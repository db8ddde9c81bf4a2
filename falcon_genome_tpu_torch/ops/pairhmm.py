"""Batched PairHMM forward likelihood on PyTorch tensors.

Port of ``falcon_genome_tpu/ops/pairhmm.py``: log10 P(read | haplotype)
per read x haplotype pair, GATK's forward model with per-base base
qualities and insertion, deletion and gap-continuation penalties that
are either constants (HaplotypeCaller runs 45/45/gcp) or per-base planes
(BQSR's BI/BD tags).

The result is bit-equal to the reference's portable wavefront
``_pairhmm_jax`` as XLA's CPU backend compiles it inside the reference's
entry points (``pairhmm_logp``, ``pairhmm_logp_pairs``: lanes padded to
a multiple of 128).  The forward runs in float32 from the initial
condition 2^120 / hap_len, with the reference's per-pair rescaling
(x 2^100 every 64 anti-diagonals for a pair whose live state has fallen
below 2^-60, the shift kept in log10).  What that takes, read off the
reference's compiled object code (see the block above :func:`_mul`):
the phred table of XLA's runtime ``powf`` (:data:`_PHRED_PROB_BITS`),
every float32 result flushed to zero when subnormal, a fused
multiply-add (rounded once) wherever XLA's code has one, the row sum
fused one step further from 33 read rows on, XLA's own float32 ``log``
(:func:`_finish`), and the rescale test on every multiple of 64 up to
R + H, past a pair's end too (:func:`_late_rescale`).  A pair whose
mass underflows float32 floors to -inf, as in the reference; callers
floor every likelihood at the read's best minus a cap.

Two kernel wrappers (``csrc/pairhmm.cu``): :func:`pairhmm_sc` (kernel K4,
scalar transitions) and :func:`pairhmm_pb` (kernel K5, per-base
transition planes).  CPU tensors run the plain version
(:func:`_pairhmm_plain`, the twin of the reference's ``_pairhmm_jax``),
CUDA tensors launch the kernel or raise; the kernels take the phreds as
the uint8 they are and turn them into probabilities through the same
256-entry table (:func:`_prob_table`), and form the log10 themselves
with the same arithmetic as :func:`_finish`.  The launches
are helpers that take the kernel library (``_pairhmm_*_launch``), so a
host build of the CUDA source runs them on CPU tensors (see
``tests/test_torch_pairhmm_emulated.py``).
:func:`pairhmm_logp` routes as the reference does: all three transitions
scalar → K4, any of them a plane → K5 with the scalars broadcast to
planes; :func:`pairhmm_logp_pairs` likewise, with a gap-open table a read
(BQSR's BI/BD) → K5.  Under an active device mesh (``parallel.mesh``) a
call runs whole on the device ``parallel.mesh.call_device`` gives it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..utils import spans
from . import _build

LOG10_2 = math.log10(2.0)
LOG10_INITIAL = 120 * LOG10_2   # initial condition 2^120 (f32 headroom)
RESCALE_EVERY = 64
RESCALE_THRESH = 2.0 ** -60
RESCALE_FACTOR = 2.0 ** 100
RESCALE_SHIFT_LOG10 = 100 * LOG10_2
FLT_MIN = 2.0 ** -126            # smallest normal float32
_TIE_BELOW_FLT_MIN = FLT_MIN - 2.0 ** -150
MAX_PAIRS_PER_CALL = 8192
MAX_KERNEL_READ_LEN = 384        # 32 lanes x 12 rows per lane

# kernel launches since the last reset
LAUNCHES = {"fgt_pairhmm": 0, "fgt_pairhmm_pb": 0}
_launch_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class PairHMMParams:
    """Read/haplotype bucket (inputs are padded to it) and the device."""
    max_read_len: int = 160
    max_hap_len: int = 512
    device: torch.device = DEFAULT_DEVICE


# float32 bit patterns of the probability of every uint8 phred q, as the
# reference computes it inside its compiled entry points: XLA rewrites
# ``-q / 10`` as ``-q * float32(0.1)`` and calls the C library's powf,
# so entry q is powf(10, -q * 0.1f) (glibc's powf; 50 of the 256 differ
# by an ulp from powf(10, -q / 10), which the reference gives outside a
# compiled function, and 6 from torch.pow)
_PHRED_PROB_BITS = (
    0x3f800000, 0x3f4b5918, 0x3f21866c, 0x3f004dce, 0x3ecbd4b4, 0x3ea1e89b,
    0x3e809bcc, 0x3e4c509b, 0x3e224b06, 0x3e00e9f9, 0x3dcccccd, 0x3da2adad,
    0x3d813855, 0x3d4d4948, 0x3d231091, 0x3d0186e2, 0x3ccdc613, 0x3ca373ae,
    0x3c81d59d, 0x3c4e4329, 0x3c23d70a, 0x3c022488, 0x3bcec088, 0x3ba43aa3,
    0x3b8273a5, 0x3b4f3e37, 0x3b249e73, 0x3b02c2f1, 0x3acfbc32, 0x3aa50285,
    0x3a83126f, 0x3a503a73, 0x3a2566d3, 0x3a03621c, 0x39d0b907, 0x39a5cb5f,
    0x3983b1f5, 0x395137e9, 0x39263028, 0x39040204, 0x38d1b717, 0x38a6952f,
    0x3884523e, 0x3852368c, 0x3826fa6c, 0x3804a2b3, 0x37d2b65d, 0x37a75fe7,
    0x3784f34f, 0x3753366c, 0x3727c5ac, 0x37054425, 0x36d3b6ca, 0x36a82ba3,
    0x36859523, 0x36543784, 0x362891e4, 0x3605e653, 0x35d4b87e, 0x35a8f857,
    0x358637bd, 0x355539d5, 0x35295f08, 0x3506894f, 0x34d5bb6c, 0x34a9c603,
    0x3486db1d, 0x34563d51, 0x342a2d31, 0x34072d12, 0x33d6bf95, 0x33aa94ab,
    0x33877f39, 0x33574218, 0x332afc56, 0x3307d19c, 0x32d7c4fb, 0x32ab6441,
    0x32882428, 0x3258481d, 0x322bcc77, 0x320876e5, 0x31d8cb9f, 0x31ac34e0,
    0x3188c9d5, 0x31594f60, 0x312c9d89, 0x31091d0b, 0x30d9d373, 0x30ad0671,
    0x3089705f, 0x305a57d5, 0x302d6fb2, 0x3009c3e7, 0x2fdadc88, 0x2fadd91a,
    0x2f8a17a1, 0x2f5b61ab, 0x2f2e42c2, 0x2f0a6b8e, 0x2edbe6ff, 0x2eaeacaa,
    0x2e8abfc2, 0x2e5c6ca4, 0x2e2f16d3, 0x2e0b1415, 0x2ddcf29b, 0x2daf8155,
    0x2d8b689b, 0x2d5d78e3, 0x2d2febff, 0x2d0bbd55, 0x2cddff9c, 0x2cb056ea,
    0x2c8c1242, 0x2c5e8688, 0x2c30c215, 0x2c0c6777, 0x2bdf0dc5, 0x2bb12d82,
    0x2b8cbccc, 0x2b5f9555, 0x2b31994a, 0x2b0d1255, 0x2ae01d37, 0x2ab20539,
    0x2a8d6811, 0x2a60a58c, 0x2a32716b, 0x2a0dbe02, 0x29e12e13, 0x29b2dddd,
    0x298e143b, 0x2961b6ee, 0x29334a92, 0x290e6a94, 0x28e2401b, 0x28b3b7a3,
    0x288ec122, 0x2862c99c, 0x283424dc, 0x280f17e4, 0x27e35392, 0x27b49258,
    0x278f6edb, 0x2763ddba, 0x27350016, 0x270fc61c, 0x26e46836, 0x26b56e17,
    0x26901d7d, 0x2664f307, 0x2635dc74, 0x26107513, 0x25e57e2c, 0x25b64afb,
    0x2590ccde, 0x256609c6, 0x2536b9c5, 0x251124df, 0x24e69595, 0x24b728d2,
    0x24917d15, 0x24672197, 0x2437983e, 0x2411d596, 0x23e7ae30, 0x23b807b7,
    0x23922e22, 0x23683b20, 0x233877aa, 0x2312870f, 0x22e8c822, 0x22b8e7ac,
    0x2292e031, 0x226955bc, 0x22395827, 0x22133960, 0x21e9e36a, 0x21b9c8e6,
    0x219392ef, 0x216a71b1, 0x213a39b5, 0x2113ec89, 0x20eb004f, 0x20baaafd,
    0x20944685, 0x206b8eff, 0x203b1c55, 0x2014a0b8, 0x1fec1e4a, 0x1fbb8e27,
    0x1f94faf7, 0x1f6cada9, 0x1f3c003f, 0x1f155597, 0x1eed3da2, 0x1ebc7266,
    0x1e95b044, 0x1e6dcdf3, 0x1e3ce508, 0x1e160b53, 0x1dee5e58, 0x1dbd57ba,
    0x1d966699, 0x1d6eef59, 0x1d3dcae8, 0x1d16c1eb, 0x1cef806d, 0x1cbe3e5c,
    0x1c971da0, 0x1c70121e, 0x1c3eb1e0, 0x1c177962, 0x1bf0a428, 0x1bbf25e0,
    0x1b97d587, 0x1b713645, 0x1b3f99f0, 0x1b1831e3, 0x1af1c901, 0x1ac00e7e,
    0x1a988e4d, 0x1a725bd0, 0x1a408353, 0x1a18eb1a, 0x19f2ef3e, 0x19c0f837,
    0x199947f4, 0x19738306, 0x19416d9a, 0x1919a532, 0x18f416e1, 0x18c1e30c,
    0x189a02a9, 0x1874ab5d, 0x184258fe, 0x181a602c, 0x17f53fec, 0x17c2cf38,
    0x179abe15, 0x1775d51c, 0x17434581, 0x171b1c0a, 0x16f66aa8, 0x16c3bc4a,
    0x169b7a65, 0x16770047, 0x16443323, 0x161bd8f9, 0x15f79688, 0x15c4aa7d,
    0x159c379a, 0x15782cdd, 0x15452220, 0x151c96a2,
)

_prob_tables: dict[torch.device, torch.Tensor] = {}
_PHRED_PROB = np.array(_PHRED_PROB_BITS, np.uint32).view(np.float32)
_queues: dict[tuple, torch.Tensor] = {}   # the kernels', by (device, stream)


def _prob_table(device: torch.device) -> torch.Tensor:
    """float32[256] on ``device``: the probability of every uint8 phred
    (:data:`_PHRED_PROB_BITS`), made once per device; the kernels look
    phreds up in it and the plain version indexes it."""
    with _launch_lock:
        table = _prob_tables.get(device)
        if table is None:
            table = torch.from_numpy(_PHRED_PROB.copy()).to(device)
            _prob_tables[device] = table
        return table


def _phred_to_prob(q) -> torch.Tensor:
    """Probabilities of uint8 phreds (a tensor or an int) from the table,
    on the phreds' device."""
    q = torch.as_tensor(q)
    return _prob_table(q.device)[q.long()]


def _base_mask(code: int) -> int:
    """The kernels' base encoding: A, C, G, T = 1, 2, 4, 8 and every other
    code 15, so that two bases match (equal, or either one is not A/C/G/T)
    exactly when their masks share a bit."""
    return 1 << code if code < 4 else 15


@functools.lru_cache(maxsize=None)
def _transitions(ins_q: int, del_q: int, gcp: int
                 ) -> tuple[float, float, float, float, float]:
    """(p_ins, p_del, p_cont, a_mm, a_im) rounded to float32 (kept per
    phred triple: a call pays for no host arithmetic)."""
    p_ins, p_del, p_cont = (_phred_to_prob(q) for q in (ins_q, del_q, gcp))
    a_mm = 1.0 - torch.clamp(p_ins + p_del, max=1.0)
    a_im = 1.0 - p_cont
    return tuple(float(x) for x in (p_ins, p_del, p_cont, a_mm, a_im))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero.  The reference's backends (XLA on
    the CPU, the TPU) flush subnormals, so a pair whose mass falls below
    the smallest normal float32 ends at -inf there."""
    return torch.where(x.abs() < FLT_MIN, 0.0, x)


def _flush_nonneg(x: torch.Tensor) -> torch.Tensor:
    """:func:`_flush` of values that are >= 0 or NaN (every value of the
    recurrence), in one pass."""
    return torch.nn.functional.threshold(x, FLT_MIN - 2.0 ** -149, 0.0)


# The float32 arithmetic of the reference's ``_pairhmm_jax`` as XLA's CPU
# backend runs it, read off the object code it emits (LLVM forms the
# fused multiply-adds when it selects instructions, so the optimized IR
# shows none; the host had AVX-512, and XLA's code for it fuses the same
# operations as for AVX2).  Every result is flushed to zero when it is
# subnormal (XLA runs with FTZ and DAZ; since no flushed result is
# subnormal, later inputs never are).  In the cell update each
# ``a * b + c * d`` is one FMA of the first product onto the rounded
# second, ``fma(a, b, c * d)``:
#   M = prior * fma(M2, a_mm, (I2 + D2) * a_im)
#   I = fma(M1, p_ins, I1 * p_cont)
#   D = fma(M1, p_del, D1 * p_cont)
# where the right-hand states are the previous diagonals' cells above and
# to the left.  The likelihood sum adds the last row's M + I; XLA
# recomputes the two inside the sum's own fusion, and from 33 read rows on
# (where it splits the row reduction into windows of 32) the product by
# the prior is not rounded there: the row adds fma(X, prior, I) with X the
# M above before its prior.  Up to 32 rows it adds prior * X rounded, + I.
# The kernels do the same with ``-ftz=true --fmad=false`` and explicit
# FMAs.  The reference's bits depend on how XLA compiles it: called
# directly on a lane count that is not a multiple of 128, its loop keeps
# a scalar tail that rounds the sum as up to 32 rows; its entry points
# always pad the lanes to a multiple of 128.
FUSED_SUM_MIN_ROWS = 33


def _mul(a, b):
    return _flush(a * b)


def _add(a, b):
    return _flush(a + b)


def _fma(a, b, c, flush=_flush):
    """float32 ``a * b + c`` rounded once, then ``flush``ed. The product is
    exact in float64, and rounding the float64 sum to float32 is the
    single rounding of the exact value unless that sum lies on a
    float32 tie (the low 29 bits of its significand 1 and then zeros),
    or on the tie between the smallest normal and the largest subnormal
    (below it every result flushes to 0 whichever way it rounds); there
    (once in ~2^29 sums) the sum is rounded to odd first, by TwoSum's
    error term."""
    def wide(x):
        return x.double() if torch.is_tensor(x) else torch.tensor(
            x, dtype=torch.float64, device=a.device)

    s = a.double() * wide(b)
    c = wide(c)
    hi = s + c
    bits = hi.view(torch.int64)
    edge = (((bits & 0x1fffffff) == 0x10000000)
            | (hi.abs() == _TIE_BELOW_FLT_MIN))
    if bool(edge.any()):
        bv = hi - s
        lo = (s - (hi - bv)) + (c - bv)
        to_odd = (lo != 0.0) & torch.isfinite(lo) & ((bits & 1) == 0)
        toward = torch.where((hi < 0.0) == (lo < 0.0), 1, -1)
        hi = torch.where(to_odd, (bits + toward).view(torch.float64), hi)
    return flush(hi.float())


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


# XLA's float32 log (the Cephes polynomial of its CPU code generator) and
# the epilogue's constants, as float32 bit patterns
_LOG_SQRTHF = _f32(0x3f3504f3)
_LOG_P = tuple(_f32(b) for b in (
    0x3d9021bb, 0xbdebd1b8, 0x3def251a, 0xbdfe5d4f, 0x3e11e9bf, 0xbe2aae50,
    0x3e4cceac, 0xbe7ffffc, 0x3eaaaaaa))
_LOG_Q1 = _f32(0xb95e8083)      # -2.12194440e-4
_LOG_Q2 = _f32(0x3f318000)      # 0.693359375
_LOG10_E = _f32(0x3ede5bd9)     # float32(log10(e)): log10 is log * this
_MINUS_LOG10_INITIAL = -float(np.float32(LOG10_INITIAL))


def _log_xla(x: torch.Tensor) -> torch.Tensor:
    """ln of positive normal float32 values as XLA's CPU backend computes
    it, operation for operation (its FMAs included); +inf stays +inf."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x007fffff) | 0x3f000000).view(torch.float32)
    small = m < _LOG_SQRTHF
    t = _add(m - 1.0, torch.where(small, m, 0.0))
    e = e - torch.where(small, 1.0, 0.0)
    z = _mul(t, t)
    t3 = _mul(z, t)
    p = _LOG_P
    a = _fma(_fma(t, p[0], p[1]), t, p[2])
    b = _fma(_fma(t, p[3], p[4]), t, p[5])
    c = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(_fma(a, t3, b), t3, c), t3, _mul(e, _LOG_Q1))
    r = _fma(e, _LOG_Q2, _add(_fma(torch.full_like(z, -0.5), z, t), y))
    return torch.where(x == math.inf, math.inf, r)


def _finish(acc: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """log10 likelihood from the scaled sum and its log10 shift, as the
    reference's epilogue computes it: log(max(acc, FLT_MIN)) times
    float32(log10(e)) less the shift in one FMA, then less 120 log10(2);
    -inf where acc is 0."""
    acc = _flush(acc)
    r = _log_xla(torch.clamp(acc, min=FLT_MIN))
    out = _add(_fma(r, torch.full_like(r, _LOG10_E), -shift),
               _MINUS_LOG10_INITIAL)
    return torch.where(acc > 0.0, out, -math.inf)


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
    # XLA divides by the constant 3 as a multiply by float32(1/3)
    prior_mismatch = p_err * torch.tensor(1.0 / 3.0, dtype=f32, device=dev)
    read_is_n = read_codes >= 4
    # the likelihood sums row rlen - 1's cells: gathered, not masked
    last = torch.clamp(rlen - 1, 0, R - 1).long()
    has_row = (rlen >= 1) & (rlen <= R)
    fused_sum = R >= FUSED_SUM_MIN_ROWS

    def shift(x, fill):
        return torch.cat([fill, x[:-1]], dim=0)

    # every value here is >= 0 or NaN, and a sum of nonnegative normals is
    # never subnormal: the products and FMAs flush, the sums need not
    def mul(a, b):
        return _flush_nonneg(a * b)

    def fma(a, b, c):
        return _fma(a, b, c, flush=_flush_nonneg)

    def cell(x, live):
        # masks select rather than multiply: a rescaled boundary overflows
        # to inf, and inf * 0 must not reach the sums
        return torch.where(live, x, 0.0)

    m1 = i1 = d1 = m2 = i2 = d2 = zeros
    hapd = torch.zeros((R, B), dtype=torch.int32, device=dev)
    acc = torch.zeros((1, B), dtype=f32, device=dev)
    sh = torch.zeros((1, B), dtype=f32, device=dev)
    factor = torch.tensor(RESCALE_FACTOR, dtype=f32, device=dev)
    step = torch.tensor(RESCALE_SHIFT_LOG10, dtype=f32, device=dev)
    late = _late_rescale(torch.minimum(prior_match[:1], prior_mismatch[:1]),
                         bound, a_im[:1])
    # diagonals past a pair's rlen + hlen add nothing to its acc, and can
    # rescale it only where :func:`_late_rescale` says so; the reference
    # sweeps all R + H
    ends = torch.where(late, R + H, rlen + hlen)
    dmax = min(R + H, int(ends.max())) if B else 0
    for d in range(1, dmax + 1):
        hapd = shift(hapd, hap_codes[min(max(d - 2, 0), H - 1)][None])
        jvec = d - rvec - 1
        live = jvec >= 1
        match = (read_codes == hapd) | read_is_n | (hapd >= 4)
        prior = torch.where(match, prior_match, prior_mismatch)
        gap2 = shift(i2, zero_row) + shift(d2, bound)
        x = fma(shift(m2, zero_row), a_mm, mul(gap2, a_im))
        m_new = cell(mul(prior, x), live)
        i_new = cell(fma(shift(m1, zero_row), p_ins,
                         mul(shift(i1, zero_row), p_cont)), live)
        d_new = cell(fma(m1, p_del, mul(d1, p_cont)), live)
        jl = d - last - 1
        xl, pl, ml, il = (t.gather(0, last) for t in (x, prior, m_new, i_new))
        term = fma(xl, pl, il) if fused_sum else ml + il
        acc = acc + torch.where(has_row & (jl >= 1) & (jl <= hlen), term,
                                0.0)
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


def _late_rescale(min_prior, bound, a_im):
    """Pairs whose state can still be rescaled after their sum is done.

    The reference sweeps all R + H anti-diagonals, and a rescale on one
    past a pair's rlen + hlen still multiplies its sum by 2^100 and adds
    100 log10(2) to its shift, which rounds the log10 another way.  Row 0
    is on every such diagonal, and its M there is prior * (bound * a_im)
    with row 0's prior, a_im and the boundary (which only grows): while
    that is at least the threshold for either prior, the largest cell is,
    and no late rescale fires.  Only such pairs (a quality-0 first base,
    a gap-continuation phred of 0 on row 0) have to sweep on to R + H.
    ``min_prior`` is row 0's smaller prior, ``bound`` the initial
    boundary, ``a_im`` row 0's."""
    return ~(_mul(min_prior, _mul(bound, a_im)) >= RESCALE_THRESH)


def _pair_rows(quals, read_lens, hap_lens, pair_read, pair_hap, gcp: int,
               R: int):
    """Per pair of a :func:`pairhmm_logp_pairs` call in the read bucket R:
    (rlen, hlen, whether it has a last row, 1 <= rlen <= R, and whether
    row 0's M stays at or above the rescale threshold, so that no rescale
    can fire: :func:`_late_rescale` false in the kernels' float32
    arithmetic, with row 0's prior and a_im)."""
    f32 = np.float32
    first_q = _host_plane(quals, len(read_lens), R, 0, False).numpy()[:, 0]
    rl = np.asarray(read_lens, np.int64)
    hl = np.asarray(hap_lens, np.int64)
    pe = _PHRED_PROB[first_q]
    prior = np.minimum(f32(1.0) - pe, pe * f32(1.0 / 3.0))
    # a_im = 1 - p_cont: the gap continuation's alone
    row0 = f32(2.0 ** 120) / np.maximum(hl.astype(f32), f32(1.0)) * \
        f32(_transitions(0, 0, gcp)[4])   # row 0's M over its prior
    has_row = (rl >= 1) & (rl <= R)
    pair_read, pair_hap = np.asarray(pair_read), np.asarray(pair_hap)
    holds = prior[pair_read] * row0[pair_hap] >= f32(RESCALE_THRESH)
    return rl[pair_read], hl[pair_hap], has_row[pair_read], holds


def _k4_work(quals, read_lens, hap_lens, pair_read, pair_hap, gcp: int,
             R: int, H: int) -> dict:
    """What K4 sweeps for a call of :func:`pairhmm_logp_pairs` with these
    arguments in the bucket (R, H), by the kernel's own rule.  A pair with
    1 <= rlen <= R whose row 0 stays above the rescale threshold
    (:func:`_pair_rows`) sweeps its own ceil(rlen / 32) rows a thread over
    rlen + hlen diagonals (``fitted``); any other pair the bucket's
    ceil(R / 32) rows over min(rlen + hlen, R + H) diagonals, or R + H
    where late.  ``cells``: the matrices' cells, sum rlen x hlen;
    ``slots``: the cells swept, sum 32 x rows a thread x diagonals."""
    prl, phl, has_row, holds = _pair_rows(quals, read_lens, hap_lens,
                                          pair_read, pair_hap, gcp, R)
    fitted = holds & has_row
    rows = np.where(fitted, (prl + 31) // 32, (R + 31) // 32)
    diags = np.where(has_row & ~fitted, R + H, np.minimum(prl + phl, R + H))
    return {"pairs": len(fitted), "fitted": int(fitted.sum()),
            "cells": int(prl @ phl), "slots": 32 * int(rows @ diags)}


# What K5 sweeps for a call with gap-open tables: K4's rule, since the gap
# opens do not enter it and row 0's a_im is the constant gap continuation's
_k5_work = _k4_work


def _launch_queue(device: torch.device, stream) -> torch.Tensor:
    """K4's and K5's queue for launches on ``stream`` (the device's current
    one; None on the CPU): int32[2], zeroed once.  Each launch's last warp
    sets it back to zero, and the launches of one stream run one after
    another, so each starts from zero; launches on other streams or
    devices take queues of their own."""
    key = (device, stream)
    queue = _queues.get(key)
    if queue is None:
        with _launch_lock:
            queue = _queues.get(key)
            if queue is None:
                queue = _queues[key] = torch.zeros(2, dtype=torch.int32,
                                                   device=device)
    return queue


def _check_kernel_inputs(name: str, R: int, typed) -> None:
    """What the kernels do not take: a read bucket past 384 rows, or a
    tensor (``typed`` pairs each with its dtype) of another dtype or on
    another device than the first."""
    if R > MAX_KERNEL_READ_LEN:
        raise ValueError(f"{name}: read bucket {R} exceeds the "
                         f"kernel's {MAX_KERNEL_READ_LEN} rows")
    dev = typed[0][0].device
    for t, dt in typed:
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name}: expected {dt} on {dev}")


def _pairhmm_sc_launch(lib, read, base_q, rlen, hap, hlen, trans, stream
                       ) -> torch.Tensor:
    """Launch K4 from ``lib`` on contiguous inputs with the float32
    transitions ``trans`` (:func:`_transitions`); returns (B,) log10 on
    the inputs' device."""
    B, R = read.shape
    H = hap.shape[1]
    table = _prob_table(read.device)
    queue = _launch_queue(read.device, stream)
    logp = torch.empty(B, dtype=torch.float32, device=read.device)
    err = lib.fgt_pairhmm(
        read.data_ptr(), base_q.data_ptr(), table.data_ptr(),
        rlen.data_ptr(), hap.data_ptr(), hlen.data_ptr(), B, R, H, *trans,
        logp.data_ptr(), queue.data_ptr(), stream)
    _build.check(err, "fgt_pairhmm")
    return logp


def _pairhmm_pb_launch(lib, read, planes, rlen, hap, hlen, stream
                       ) -> torch.Tensor:
    """Launch K5 from ``lib`` on contiguous inputs, ``planes`` = (base_q,
    ins_q, del_q, gcp); returns (B,) log10 on the inputs' device."""
    B, R = read.shape
    H = hap.shape[1]
    table = _prob_table(read.device)
    queue = _launch_queue(read.device, stream)
    logp = torch.empty(B, dtype=torch.float32, device=read.device)
    err = lib.fgt_pairhmm_pb(
        read.data_ptr(), *(q.data_ptr() for q in planes), table.data_ptr(),
        rlen.data_ptr(), hap.data_ptr(), hlen.data_ptr(), B, R, H,
        logp.data_ptr(), queue.data_ptr(), stream)
    _build.check(err, "fgt_pairhmm_pb")
    return logp


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
    _check_kernel_inputs("pairhmm_sc", R, [
        (read, torch.uint8), (base_q, torch.uint8), (hap, torch.uint8),
        (rlen, torch.int32), (hlen, torch.int32)])
    dev = read.device
    with torch.cuda.device(dev):
        out = _pairhmm_sc_launch(
            _build.load(), *(t.contiguous() for t in (read, base_q, rlen,
                                                      hap, hlen)),
            _transitions(int(ins_q), int(del_q), int(gcp)),
            torch.cuda.current_stream(dev).cuda_stream)
        with _launch_lock:
            LAUNCHES["fgt_pairhmm"] += 1
        return out


def pairhmm_pb(read, base_q, ins_q, del_q, gcp, rlen, hap, hlen
               ) -> torch.Tensor:
    """PairHMM with per-base transition phreds (kernel K5).

    Lane-major inputs on one device: read (B, R) uint8 codes; base_q,
    ins_q, del_q, gcp (B, R) uint8 phreds; rlen (B,) int32; hap (B, H)
    uint8; hlen (B,) int32.  Returns (B,) float32 log10 likelihoods on
    that device."""
    B, R = read.shape
    H = hap.shape[1]
    planes = (base_q, ins_q, del_q, gcp)
    if any(q.shape != (B, R) for q in planes) or hap.shape[0] != B or \
            rlen.shape != (B,) or hlen.shape != (B,):
        raise ValueError("pairhmm_pb: inconsistent shapes")
    if read.device.type == "cpu":
        return _pairhmm_plain(read.T, base_q.T, ins_q.T, del_q.T, gcp.T,
                              rlen[None], hlen[None], hap.T, R=R, H=H)
    if read.device.type != "cuda":
        raise ValueError(f"no PairHMM kernel for device {read.device}")
    _check_kernel_inputs("pairhmm_pb", R, [
        (read, torch.uint8), (hap, torch.uint8), (rlen, torch.int32),
        (hlen, torch.int32), *((q, torch.uint8) for q in planes)])
    dev = read.device
    with torch.cuda.device(dev):
        out = _pairhmm_pb_launch(
            _build.load(), read.contiguous(),
            [q.contiguous() for q in planes],
            *(t.contiguous() for t in (rlen, hap, hlen)),
            torch.cuda.current_stream(dev).cuda_stream)
        with _launch_lock:
            LAUNCHES["fgt_pairhmm_pb"] += 1
        return out


def _is_plane(q) -> bool:
    return np.ndim(q) != 0


def _host_plane(x, rows: int, cols: int, fill: int, pin: bool
                ) -> torch.Tensor:
    """(rows, cols) uint8 host tensor, in pinned memory where ``pin``: a
    scalar phred fills it (the reference broadcasts one to the bucket),
    an array is padded with ``fill`` (N codes for bases, phred 0 for
    qualities: the reference's blob padding)."""
    out = torch.empty((rows, cols), dtype=torch.uint8, pin_memory=pin)
    a = out.numpy()
    if not _is_plane(x):
        a.fill(int(x))
        return out
    x = np.asarray(x)
    a.fill(fill)
    a[:x.shape[0], :x.shape[1]] = x
    return out


def _host_vector(x, dtype, pin: bool) -> torch.Tensor:
    out = torch.empty(len(x), dtype=dtype, pin_memory=pin)
    out.numpy()[:] = x
    return out


def pairhmm_logp(read_codes, base_q, ins_q, del_q, gcp, read_lens,
                 hap_codes, hap_lens,
                 params: PairHMMParams = PairHMMParams()) -> np.ndarray:
    """log10 P(read | hap) for a batch of pairs.

    Batch-major host arrays: reads (B, R') codes, haps (B, H'), per-pair
    lengths; base_q/ins_q/del_q/gcp each a scalar phred or a (B, R')
    phred array.  Reads and haps are padded to the bucket (N codes), quality
    planes with phred 0, as the reference does; calls hold at most 8192
    pairs.  All transitions scalar → kernel K4, else K5.  Under an active
    mesh the call runs on one of its devices (``call_device``).  Under a
    profiler session the call and its steps are spans
    (``utils/spans.py``): ``pairhmm.call``, and ``pairhmm.tables``,
    ``pairhmm.copy_in`` and ``pairhmm.launch`` a chunk, then
    ``pairhmm.wait``."""
    B, Rin = read_codes.shape
    Hin = hap_codes.shape[1]
    R, H = params.max_read_len, params.max_hap_len
    if ((max(Rin, 8) + 7) // 8) * 8 > R:
        raise ValueError(f"read bucket {Rin} exceeds {R}")
    if Hin > H:
        raise ValueError(f"hap bucket {Hin} exceeds {H}")
    from ..parallel.mesh import call_device, get_active_mesh
    mesh = get_active_mesh()
    dev = call_device(mesh.flat if mesh is not None else [params.device])
    args = (read_codes, base_q, ins_q, del_q, gcp, read_lens, hap_codes,
            hap_lens, R, H, dev)
    if not spans.active():
        return _logp_chunks(*args, spans.off)
    with spans.span("pairhmm.call", cpu=True, pairs=B, card=str(dev)):
        return _logp_chunks(*args, spans.span)


def _logp_chunks(read_codes, base_q, ins_q, del_q, gcp, read_lens,
                 hap_codes, hap_lens, R, H, dev, step) -> np.ndarray:
    """:func:`pairhmm_logp` on ``dev`` in chunks of at most 8192 pairs,
    each of its steps inside ``step(name)``."""
    B = read_codes.shape[0]
    trans = (ins_q, del_q, gcp)
    per_base = any(_is_plane(q) for q in trans)
    pin = dev.type == "cuda"
    chunks = []
    for s0 in range(0, B, MAX_PAIRS_PER_CALL):
        e0 = min(B, s0 + MAX_PAIRS_PER_CALL)
        n = e0 - s0

        def cut(q):     # scalar phreds pass through unsliced
            return q[s0:e0] if _is_plane(q) else q

        # the chunk padded once on the host (megabytes: pinned for the
        # card, whose copies then take half the device time and do not
        # wait for the host)
        with step("pairhmm.tables"):
            host = [_host_plane(read_codes[s0:e0], n, R, 4, pin),
                    _host_plane(cut(base_q), n, R, 0, pin),
                    _host_vector(read_lens[s0:e0], torch.int32, pin),
                    _host_plane(hap_codes[s0:e0], n, H, 4, pin),
                    _host_vector(hap_lens[s0:e0], torch.int32, pin)]
            if per_base:
                host += [_host_plane(cut(q), n, R, 0, pin) for q in trans]
        with step("pairhmm.copy_in"):
            read, bq, rl, hap, hl, *planes = [t.to(dev, non_blocking=True)
                                              for t in host]
        with step("pairhmm.launch", kernel="K5" if per_base else "K4"):
            if per_base:
                chunks.append(pairhmm_pb(read, bq, *planes, rl, hap, hl))
            else:
                chunks.append(pairhmm_sc(read, bq, rl, hap, hl,
                                         *(int(q) for q in trans)))
    # read back once every chunk's launch is enqueued
    with step("pairhmm.wait", cpu=True):
        out = [logp.cpu().numpy() for logp in chunks]
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def pairhmm_logp_pairs(reads, quals, read_lens, haps, hap_lens,
                       pair_read, pair_hap, ins_q, del_q, gcp: int,
                       params: PairHMMParams = PairHMMParams()
                       ) -> np.ndarray:
    """log10 P(read | hap) for pairs given as (read index, hap index).

    HaplotypeCaller batches are cross products (every read x every hap of
    a region): the unique reads, qualities and haplotypes ship once and
    the (B, R) / (B, H) pair tiles are gathered on the device.
    reads (NR, R') codes, quals (NR, R') phreds, haps (NH, H'),
    read_lens (NR,), hap_lens (NH,), pair_read/pair_hap (B,) with
    B <= 8192 (callers chunk).  ``ins_q`` and ``del_q`` are each a scalar
    phred or an (NR, R') uint8 table of a read's gap-open phreds (BQSR's
    BI/BD), padded with phred 0 as ``quals`` is; ``gcp`` a scalar.  All
    scalar → kernel K4; a table → kernel K5, the tables shipped with the
    reads and gathered to the pairs, a scalar's plane made on the device.
    Under an active mesh the call runs on one of its devices
    (``parallel.mesh.call_device``).  Under a profiler session the call
    and its steps are spans (``utils/spans.py``): ``pairhmm.call``, then
    ``pairhmm.tables`` (``planes``: the tables among them),
    ``pairhmm.copy_in``, ``pairhmm.gather``, ``pairhmm.launch``
    (``kernel``, and the kernel's work, :func:`_k4_work` or
    :func:`_k5_work`, counted when the spans are read, from references to
    the call's arguments: the caller leaves them as they are until then),
    ``pairhmm.wait`` and ``pairhmm.free``."""
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
    if any(_is_plane(x) and np.shape(x) != reads.shape
           for x in (ins_q, del_q)):
        raise ValueError("pairhmm_logp_pairs: a gap-open table is not "
                         "the reads' shape")
    from ..parallel.mesh import call_device, get_active_mesh
    mesh = get_active_mesh()
    dev = call_device(mesh.flat if mesh is not None else [params.device])
    args = (reads, quals, read_lens, haps, hap_lens, pair_read, pair_hap,
            ins_q, del_q, gcp, R, H, dev)
    if not spans.active():
        return _logp_pairs(*args, spans.off)
    with spans.span("pairhmm.call", cpu=True, pairs=B, reads=NR, haps=NH,
                    card=str(dev)):
        return _logp_pairs(*args, spans.span)


def _logp_pairs(reads, quals, read_lens, haps, hap_lens, pair_read,
                pair_hap, ins_q, del_q, gcp, R, H, dev, step) -> np.ndarray:
    """:func:`pairhmm_logp_pairs` on ``dev``, each of its steps inside
    ``step(name)``."""
    NR, NH = reads.shape[0], haps.shape[0]
    gap_tables = [x for x in (ins_q, del_q) if _is_plane(x)]
    # tens of kilobytes: pinning them costs more host time than the
    # copies save (traced on the card)
    with step("pairhmm.tables", planes=len(gap_tables)):
        tables = (_host_plane(reads, NR, R, 4, False),
                  _host_plane(quals, NR, R, 0, False),
                  _host_vector(read_lens, torch.int32, False),
                  _host_plane(haps, NH, H, 4, False),
                  _host_vector(hap_lens, torch.int32, False),
                  _host_vector(pair_read, torch.int64, False),
                  _host_vector(pair_hap, torch.int64, False))
        gap_tables = [_host_plane(x, NR, R, 0, False) for x in gap_tables]
    with step("pairhmm.copy_in"):
        rd, q, rl, hp, hl, pr, ph = [t.to(dev, non_blocking=True)
                                     for t in tables]
        gap_tables = [t.to(dev, non_blocking=True) for t in gap_tables]
    with step("pairhmm.gather"):
        tiles = (rd[pr], q[pr], rl[pr], hp[ph], hl[ph])
        if gap_tables:
            # the (B, R) planes of K5, in the order (ins, del, gcp): each
            # table gathered with the reads, each scalar made on the device
            B = len(pair_read)
            given = iter(gap_tables)
            planes = [next(given)[pr] if _is_plane(x) else
                      torch.full((B, R), int(x), dtype=torch.uint8,
                                 device=dev) for x in (ins_q, del_q, gcp)]
    with step("pairhmm.launch", kernel="K5" if gap_tables else "K4"
              ) as launch:
        # a dozen numpy calls on the pairs for the kernel's work, left to
        # the reading of the spans: here they would wait for the GIL
        # behind the other callers
        if gap_tables:
            logp = pairhmm_pb(*tiles[:2], *planes, *tiles[2:])
        else:
            logp = pairhmm_sc(*tiles, int(ins_q), int(del_q), int(gcp))
        if launch is not None:
            launch.later(functools.partial(
                _k5_work if gap_tables else _k4_work, quals, read_lens,
                hap_lens, pair_read, pair_hap, int(gcp), R, H))
    with step("pairhmm.wait", cpu=True):
        out = logp.cpu().numpy()
    # the call's tensors are released in a step of their own and not at
    # the return: torch hands the GIL over at each tensor's release, and
    # under many callers that wait is a large part of a call
    with step("pairhmm.free"):
        del tables, rd, q, rl, hp, hl, pr, ph, tiles, logp
        if gap_tables:
            del gap_tables, given, planes
    return out
