"""Plain PairHMM forward likelihood: the yardstick of the likelihood cells.

GATK's pair hidden Markov model, global in the read and free in where it
starts and ends on the haplotype, written from its published equations in
plain PyTorch (no kernel, no table of the program's):

    M(i,j) = prior(i,j) * (M(i-1,j-1) a_mm + (I(i-1,j-1) + D(i-1,j-1)) a_im)
    I(i,j) = M(i-1,j) p_ins + I(i-1,j) p_cont
    D(i,j) = M(i,j-1) p_del + D(i,j-1) p_cont
    D(0,j) = 1 / hap_len for every j >= 0, all other boundary cells 0
    P(read | hap) = sum over j in 1..hap_len of M(rlen,j) + I(rlen,j)

with prior = 1 - e on a match (an N matches every base) and e / 3 on a
mismatch, e = 10^(-q/10) of the base quality, p_ins = 10^(-ins/10),
p_del = 10^(-del/10), p_cont = 10^(-gcp/10), a_mm = 1 - (p_ins + p_del)
(at most 1) and a_im = 1 - p_cont.

The sweep runs over anti-diagonals d = i + j, all pairs at once.  The
boundary starts at 2^120 / hap_len and every 64 diagonals a pair whose
largest state has fallen below 2^-60 is multiplied by 2^100: both are
exact powers of two, so they change nothing in float64 and keep float32
and bfloat16 (the control) off their floor.  Returns log10 P in float64.
"""
from __future__ import annotations

import math

import torch

SCALE0 = 2.0 ** 120
RESCALE_EVERY = 64
RESCALE_BELOW = 2.0 ** -60
RESCALE_BY = 2.0 ** 100


def phred(q, dtype) -> torch.Tensor:
    """10^(-q/10), computed in float64 and rounded once to ``dtype``."""
    q = torch.as_tensor(q)
    return torch.pow(10.0, -q.to(torch.float64) / 10.0).to(dtype)


def log10_likelihood(read: torch.Tensor, qual: torch.Tensor,
                     rlen: torch.Tensor, hap: torch.Tensor,
                     hlen: torch.Tensor, ins_q: int, del_q: int, gcp: int,
                     dtype=torch.float64) -> torch.Tensor:
    """log10 P(read | hap) per pair.

    read (B, R) base codes 0-3 (4 = N), qual (B, R) phreds, rlen (B,),
    hap (B, H) codes, hlen (B,): pair b's read is read[b, :rlen[b]] and its
    haplotype hap[b, :hlen[b]].  Arithmetic in ``dtype``; the result is
    float64, -inf where the likelihood underflows ``dtype``."""
    dev = read.device
    B, R = read.shape
    H = hap.shape[1]
    read = read.long()
    hap = hap.long()
    rlen = rlen.long()
    hlen = hlen.long()
    err = phred(qual, dtype)
    p_match = 1.0 - err
    p_mis = err / 3.0
    p_ins, p_del, p_cont = (phred(q, dtype).to(dev)
                            for q in (ins_q, del_q, gcp))
    a_mm = 1.0 - torch.clamp(p_ins + p_del, max=1.0)
    a_im = 1.0 - p_cont
    rows = torch.arange(1, R + 1, device=dev)            # i
    bound = (SCALE0 / hlen.to(torch.float64)).to(dtype)[:, None]
    zero = torch.zeros((B, 1), dtype=dtype, device=dev)

    def up(x, fill):        # value of row i-1 for each row i
        return torch.cat([fill, x[:, :-1]], dim=1)

    z = torch.zeros((B, R), dtype=dtype, device=dev)
    m1 = i1 = d1 = m2 = i2 = d2 = z      # diagonals d-1 and d-2
    acc = torch.zeros(B, dtype=dtype, device=dev)
    shift = torch.zeros(B, dtype=torch.float64, device=dev)
    last = (rlen - 1).clamp(0, R - 1)[:, None]
    for d in range(2, R + H + 1):
        cols = d - rows                                   # j of row i
        live = (cols >= 1) & (cols <= H)
        hb = hap.gather(1, (cols - 1).clamp(0, H - 1)[None].expand(B, R))
        same = (read == hb) | (read >= 4) | (hb >= 4)
        prior = torch.where(same, p_match, p_mis)
        # (i-1, j-1): row 0 holds M = I = 0 and D = the boundary
        m_new = prior * (up(m2, zero) * a_mm
                         + (up(i2, zero) + up(d2, bound)) * a_im)
        i_new = up(m1, zero) * p_ins + up(i1, zero) * p_cont   # (i-1, j)
        d_new = m1 * p_del + d1 * p_cont                        # (i, j-1)
        m_new, i_new, d_new = (torch.where(live[None], x, 0.0)
                               for x in (m_new, i_new, d_new))
        j_last = d - (last[:, 0] + 1)
        take = (j_last >= 1) & (j_last <= hlen)
        row_sum = (m_new + i_new).gather(1, last)[:, 0]
        acc = acc + torch.where(take, row_sum, 0.0)
        m2, i2, d2, m1, i1, d1 = m1, i1, d1, m_new, i_new, d_new
        if d % RESCALE_EVERY == 0:
            big = torch.maximum((m1 + i1 + d1).amax(dim=1),
                                (m2 + i2 + d2).amax(dim=1))
            low = (big > 0) & (big < RESCALE_BELOW)
            f = torch.where(low, RESCALE_BY, 1.0).to(dtype)
            m1, i1, d1, m2, i2, d2 = (x * f[:, None]
                                      for x in (m1, i1, d1, m2, i2, d2))
            acc = acc * f
            bound = bound * f[:, None]
            shift = shift + torch.where(low, 100.0, 0.0)
    out = torch.log2(acc.to(torch.float64)) - shift - 120.0
    return out * math.log10(2.0)


def log10_likelihood_naive(read, qual, hap, ins_q: int, del_q: int,
                           gcp: int) -> float:
    """One pair by the textbook cell-by-cell recurrence in float64, for
    the tests (read, qual, hap: 1-D sequences of their real lengths)."""
    R, H = len(read), len(hap)
    p_ins, p_del, p_cont = (10.0 ** (-q / 10.0) for q in (ins_q, del_q, gcp))
    a_mm = 1.0 - min(1.0, p_ins + p_del)
    a_im = 1.0 - p_cont
    M = [[0.0] * (H + 1) for _ in range(R + 1)]
    I = [[0.0] * (H + 1) for _ in range(R + 1)]
    D = [[0.0] * (H + 1) for _ in range(R + 1)]
    D[0] = [1.0 / H] * (H + 1)
    for i in range(1, R + 1):
        e = 10.0 ** (-int(qual[i - 1]) / 10.0)
        for j in range(1, H + 1):
            a, b = int(read[i - 1]), int(hap[j - 1])
            prior = 1.0 - e if (a == b or a >= 4 or b >= 4) else e / 3.0
            M[i][j] = prior * (M[i - 1][j - 1] * a_mm
                               + (I[i - 1][j - 1] + D[i - 1][j - 1]) * a_im)
            I[i][j] = M[i - 1][j] * p_ins + I[i - 1][j] * p_cont
            D[i][j] = M[i][j - 1] * p_del + D[i][j - 1] * p_cont
    total = sum(M[R][j] + I[R][j] for j in range(1, H + 1))
    return math.log10(total) if total > 0 else -math.inf
