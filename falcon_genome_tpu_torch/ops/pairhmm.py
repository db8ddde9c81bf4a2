"""Batched PairHMM forward likelihood on PyTorch tensors.

Port of ``falcon_genome_tpu/ops/pairhmm.py``: log10 P(read | haplotype)
per read x haplotype pair, GATK's forward model with constant insertion,
deletion and gap-continuation penalties (HaplotypeCaller runs 45/45/gcp)
and per-base base qualities.

The forward runs in float32 from the initial condition 2^120 / hap_len,
with the reference's per-pair rescaling (x 2^100 every 64 anti-diagonals
for a pair whose live state has fallen below 2^-60, the shift kept in
log10).  Subnormal values are flushed to zero, as the reference's
backends do, so a pair whose mass underflows float32 anyway floors to
-inf, as in the reference; callers floor every likelihood at the read's
best minus a cap.

:func:`pairhmm_sc` is the kernel wrapper (kernel K4,
``csrc/pairhmm.cu``): CPU tensors run the plain version
(:func:`_pairhmm_plain`, the twin of the reference's ``_pairhmm_jax``),
CUDA tensors launch the kernel or raise.  Per-base insertion/deletion
qualities (the reference's general kernel) are not ported yet; the entry
points here take scalar transition qualities only.
"""
from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch

from . import _build

LOG10_2 = math.log10(2.0)
LOG10_INITIAL = 120 * LOG10_2   # initial condition 2^120 (f32 headroom)
RESCALE_EVERY = 64
RESCALE_THRESH = 2.0 ** -60
RESCALE_FACTOR = 2.0 ** 100
RESCALE_SHIFT_LOG10 = 100 * LOG10_2
FLT_MIN = 2.0 ** -126            # smallest normal float32
MAX_PAIRS_PER_CALL = 8192
MAX_KERNEL_READ_LEN = 256        # 32 lanes x 8 rows per lane

# kernel launches since the last reset
LAUNCHES = {"fgt_pairhmm": 0}
_launch_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class PairHMMParams:
    """Read/haplotype bucket (inputs are padded to it) and the device."""
    max_read_len: int = 160
    max_hap_len: int = 512
    device: torch.device = torch.device("cpu")


def _phred_to_prob(q) -> torch.Tensor:
    q = torch.as_tensor(q)
    return torch.pow(10.0, -q.to(torch.float32) / 10.0)


def _transitions(ins_q: int, del_q: int, gcp: int
                 ) -> tuple[float, float, float, float, float]:
    """(p_ins, p_del, p_cont, a_mm, a_im) rounded to float32."""
    p_ins, p_del, p_cont = (_phred_to_prob(q) for q in (ins_q, del_q, gcp))
    a_mm = 1.0 - torch.clamp(p_ins + p_del, max=1.0)
    a_im = 1.0 - p_cont
    return tuple(float(x) for x in (p_ins, p_del, p_cont, a_mm, a_im))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero.  The reference's backends (XLA on
    the CPU, the TPU) flush subnormals, so a pair whose mass falls below
    the smallest normal float32 ends at -inf there; the port flushes every
    cell and the sum the same way, on any device."""
    return torch.where(x.abs() < FLT_MIN, 0.0, x)


def _finish(acc: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """log10 likelihood from the scaled sum and its log10 shift."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(
        acc > 0.0,
        torch.log10(torch.clamp(acc, min=tiny)) - shift - LOG10_INITIAL,
        torch.tensor(-math.inf, dtype=torch.float32, device=acc.device))


def _pairhmm_plain(read_codes, base_q, ins_q, del_q, gcp, rlen, hlen,
                   hap_codes, *, R: int, H: int) -> torch.Tensor:
    """Anti-diagonal wavefront, the twin of the reference's
    ``_pairhmm_jax`` (and of kernel K4).

    Time-major inputs: read_codes (R, B), base_q (R, B) phreds, rlen and
    hlen (1, B), hap_codes (H, B); ins_q/del_q/gcp phred scalars or
    (R, B) arrays.  Returns (B,) float32 log10 likelihoods."""
    f32 = torch.float32
    dev = read_codes.device
    read_codes = read_codes.to(torch.int32)
    hap_codes = hap_codes.to(torch.int32)
    B = read_codes.shape[1]

    def plane(q):
        return torch.broadcast_to(_phred_to_prob(q).to(dev), (R, B))

    p_err, p_ins, p_del, p_cont = (plane(q) for q in (base_q, ins_q, del_q,
                                                      gcp))
    rlen = rlen.to(torch.int32)
    hlen = hlen.to(torch.int32)
    a_mm = 1.0 - torch.clamp(p_ins + p_del, max=1.0)
    a_im = 1.0 - p_cont
    rvec = torch.arange(R, dtype=torch.int32, device=dev).reshape(R, 1)
    bound = (torch.tensor(2.0 ** 120, dtype=f32, device=dev)
             / torch.clamp(hlen.to(f32), min=1.0))
    zero_row = torch.zeros((1, B), dtype=f32, device=dev)
    zeros = torch.zeros((R, B), dtype=f32, device=dev)
    prior_match = 1.0 - p_err
    prior_mismatch = p_err / 3.0
    read_is_n = read_codes >= 4
    last_row = rvec + 1 == rlen

    def shift(x, fill):
        return torch.cat([fill, x[:-1]], dim=0)

    def cell(x, live):
        # masks select rather than multiply: a rescaled boundary overflows
        # to inf, and inf * 0 must not reach the sums
        return _flush(torch.where(live, x, 0.0))

    m1 = i1 = d1 = m2 = i2 = d2 = zeros
    hapd = torch.zeros((R, B), dtype=torch.int32, device=dev)
    acc = torch.zeros((1, B), dtype=f32, device=dev)
    sh = torch.zeros((1, B), dtype=f32, device=dev)
    factor = torch.tensor(RESCALE_FACTOR, dtype=f32, device=dev)
    step = torch.tensor(RESCALE_SHIFT_LOG10, dtype=f32, device=dev)
    # diagonals past every pair's rlen + hlen add nothing to acc
    dmax = min(R + H, int((rlen + hlen).max())) if B else 0
    for d in range(1, dmax + 1):
        hapd = shift(hapd, hap_codes[min(max(d - 2, 0), H - 1)][None])
        jvec = d - rvec - 1
        live = jvec >= 1
        match = (read_codes == hapd) | read_is_n | (hapd >= 4)
        prior = torch.where(match, prior_match, prior_mismatch)
        m_new = cell(prior * (shift(m2, zero_row) * a_mm
                              + (shift(i2, zero_row) + shift(d2, bound))
                              * a_im), live)
        i_new = cell(shift(m1, zero_row) * p_ins
                     + shift(i1, zero_row) * p_cont, live)
        d_new = cell(m1 * p_del + d1 * p_cont, live)
        amask = last_row & live & (jvec <= hlen)
        acc = _flush(acc + torch.where(amask, m_new + i_new, 0.0).sum(
            dim=0, keepdim=True))
        m1, i1, d1, m2, i2, d2 = m_new, i_new, d_new, m1, i1, d1
        if d % RESCALE_EVERY == 0:
            m = torch.maximum(
                (m1.abs() + i1.abs() + d1.abs()).amax(dim=0, keepdim=True),
                (m2.abs() + i2.abs() + d2.abs()).amax(dim=0, keepdim=True))
            need = (m > 0.0) & (m < RESCALE_THRESH)
            scale = torch.where(need, factor, 1.0)
            m1, i1, d1 = m1 * scale, i1 * scale, d1 * scale
            m2, i2, d2 = m2 * scale, i2 * scale, d2 * scale
            acc = acc * scale
            bound = bound * scale
            sh = sh + torch.where(need, step, 0.0)
    return _finish(acc, sh)[0]


def pairhmm_sc(read, base_q, rlen, hap, hlen, ins_q: int, del_q: int,
               gcp: int) -> torch.Tensor:
    """PairHMM with scalar transition phreds (kernel K4).

    Lane-major inputs on one device: read (B, R) uint8 codes, base_q
    (B, R) uint8 phreds, rlen (B,) int32, hap (B, H) uint8, hlen (B,)
    int32.  Returns (B,) float32 log10 likelihoods on that device."""
    B, R = read.shape
    H = hap.shape[1]
    if base_q.shape != (B, R) or hap.shape[0] != B or \
            rlen.shape != (B,) or hlen.shape != (B,):
        raise ValueError("pairhmm_sc: inconsistent shapes")
    if read.device.type == "cpu":
        return _pairhmm_plain(read.T, base_q.T, ins_q, del_q, gcp,
                              rlen[None], hlen[None], hap.T, R=R, H=H)
    if read.device.type != "cuda":
        raise ValueError(f"no PairHMM kernel for device {read.device}")
    if R > MAX_KERNEL_READ_LEN:
        raise ValueError(f"pairhmm_sc: read bucket {R} exceeds the "
                         f"kernel's {MAX_KERNEL_READ_LEN} rows")
    for t, dt in ((read, torch.uint8), (base_q, torch.uint8),
                  (hap, torch.uint8), (rlen, torch.int32),
                  (hlen, torch.int32)):
        if t.dtype != dt or t.device != read.device:
            raise TypeError(f"pairhmm_sc: expected {dt} on {read.device}")
    dev = read.device
    read, hap, rlen, hlen = (t.contiguous() for t in (read, hap, rlen, hlen))
    p_err = _phred_to_prob(base_q).contiguous()
    acc = torch.empty(B, dtype=torch.float32, device=dev)
    sh = torch.empty(B, dtype=torch.float32, device=dev)
    err = _build.load().fgt_pairhmm(
        read.data_ptr(), p_err.data_ptr(), rlen.data_ptr(), hap.data_ptr(),
        hlen.data_ptr(), B, R, H, *_transitions(ins_q, del_q, gcp),
        acc.data_ptr(), sh.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fgt_pairhmm")
    with _launch_lock:
        LAUNCHES["fgt_pairhmm"] += 1
    return _finish(acc, sh)


def _scalar_phred(name: str, q) -> int:
    if np.ndim(q) != 0:
        raise ValueError(
            f"{name}: per-base transition qualities are not ported yet; "
            "pass a scalar phred")
    return int(q)


def _padded(x, rows: int, cols: int, fill: int, device) -> torch.Tensor:
    x = np.asarray(x)
    out = np.full((rows, cols), fill, np.uint8)
    out[:x.shape[0], :x.shape[1]] = x
    return torch.from_numpy(out).to(device)


def pairhmm_logp(read_codes, base_q, ins_q, del_q, gcp, read_lens,
                 hap_codes, hap_lens,
                 params: PairHMMParams = PairHMMParams()) -> np.ndarray:
    """log10 P(read | hap) for a batch of pairs.

    Batch-major host arrays: reads (B, R') codes and base-quality phreds,
    haps (B, H'), per-pair lengths; ins_q/del_q/gcp scalar phreds.  Reads
    and haps are padded to the bucket (N codes, quality 0), as the
    reference does."""
    ins_q, del_q, gcp = (_scalar_phred(n, q) for n, q in (
        ("ins_q", ins_q), ("del_q", del_q), ("gcp", gcp)))
    B, Rin = read_codes.shape
    Hin = hap_codes.shape[1]
    R, H = params.max_read_len, params.max_hap_len
    if ((max(Rin, 8) + 7) // 8) * 8 > R:
        raise ValueError(f"read bucket {Rin} exceeds {R}")
    if Hin > H:
        raise ValueError(f"hap bucket {Hin} exceeds {H}")
    out = np.zeros(B, np.float32)
    dev = params.device
    for s in range(0, B, MAX_PAIRS_PER_CALL):
        e = min(B, s + MAX_PAIRS_PER_CALL)
        n = e - s
        logp = pairhmm_sc(
            _padded(read_codes[s:e], n, R, 4, dev),
            _padded(base_q[s:e], n, R, 0, dev),
            torch.from_numpy(np.asarray(read_lens[s:e], np.int32)).to(dev),
            _padded(hap_codes[s:e], n, H, 4, dev),
            torch.from_numpy(np.asarray(hap_lens[s:e], np.int32)).to(dev),
            ins_q, del_q, gcp)
        out[s:e] = logp.cpu().numpy()
    return out


def pairhmm_logp_pairs(reads, quals, read_lens, haps, hap_lens,
                       pair_read, pair_hap,
                       ins_q: int, del_q: int, gcp: int,
                       params: PairHMMParams = PairHMMParams()
                       ) -> np.ndarray:
    """log10 P(read | hap) for pairs given as (read index, hap index).

    HaplotypeCaller batches are cross products (every read x every hap of
    a region): the unique reads, qualities and haplotypes ship once and
    the (B, R) / (B, H) pair tiles are gathered on the device.
    reads (NR, R') codes, quals (NR, R') phreds, haps (NH, H'),
    read_lens (NR,), hap_lens (NH,), pair_read/pair_hap (B,) with
    B <= 8192 (callers chunk)."""
    B = len(pair_read)
    if B == 0:
        return np.zeros(0, np.float32)
    if B > MAX_PAIRS_PER_CALL:
        raise ValueError("pairhmm_logp_pairs: chunk pairs to <= 8192")
    NR, Rin = reads.shape
    NH, Hin = haps.shape
    R, H = params.max_read_len, params.max_hap_len
    if ((max(Rin, 8) + 7) // 8) * 8 > R or Hin > H:
        raise ValueError("input exceeds PairHMM bucket shape")
    dev = params.device
    pr = torch.from_numpy(np.asarray(pair_read, np.int64)).to(dev)
    ph = torch.from_numpy(np.asarray(pair_hap, np.int64)).to(dev)
    rl = torch.from_numpy(np.asarray(read_lens, np.int32)).to(dev)
    hl = torch.from_numpy(np.asarray(hap_lens, np.int32)).to(dev)
    logp = pairhmm_sc(
        _padded(reads, NR, R, 4, dev)[pr], _padded(quals, NR, R, 0, dev)[pr],
        rl[pr], _padded(haps, NH, H, 4, dev)[ph], hl[ph],
        int(ins_q), int(del_q), int(gcp))
    return logp.cpu().numpy()
