"""Batched PairHMM forward likelihood on PyTorch tensors.

Port of ``falcon_genome_tpu/ops/pairhmm.py``: log10 P(read | haplotype)
per read x haplotype pair, GATK's forward model with per-base base
qualities and insertion, deletion and gap-continuation penalties that
are either constants (HaplotypeCaller runs 45/45/gcp) or per-base planes
(BQSR's BI/BD tags).

The forward runs in float32 from the initial condition 2^120 / hap_len,
with the reference's per-pair rescaling (x 2^100 every 64 anti-diagonals
for a pair whose live state has fallen below 2^-60, the shift kept in
log10).  Every float32 operation flushes a subnormal result to zero and
fuses multiply-adds where the reference's CPU backend does, so a pair
whose mass underflows float32 floors to -inf, and a pair whose mass
passes through the subnormal range loses the same mass, as in the
reference; callers floor every likelihood at the read's best minus a
cap.

Two kernel wrappers (``csrc/pairhmm.cu``): :func:`pairhmm_sc` (kernel K4,
scalar transitions) and :func:`pairhmm_pb` (kernel K5, per-base
transition planes).  CPU tensors run the plain version
(:func:`_pairhmm_plain`, the twin of the reference's ``_pairhmm_jax``),
CUDA tensors launch the kernel or raise; the kernels take the phreds as
the uint8 they are and turn them into probabilities through a 256-entry
table that :func:`_phred_to_prob` fills once per device.  The launches
are helpers that take the kernel library (``_pairhmm_*_launch``), so a
host build of the CUDA source runs them on CPU tensors (see
``tests/test_torch_pairhmm_emulated.py``).
:func:`pairhmm_logp` routes as the reference does: all three transitions
scalar → K4, any of them a plane → K5 with the scalars broadcast to
planes; under an active device mesh (``parallel.mesh``) it splits the
pairs over the mesh's devices.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from . import _build

LOG10_2 = math.log10(2.0)
LOG10_INITIAL = 120 * LOG10_2   # initial condition 2^120 (f32 headroom)
RESCALE_EVERY = 64
RESCALE_THRESH = 2.0 ** -60
RESCALE_FACTOR = 2.0 ** 100
RESCALE_SHIFT_LOG10 = 100 * LOG10_2
FLT_MIN = 2.0 ** -126            # smallest normal float32
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


def _phred_to_prob(q) -> torch.Tensor:
    q = torch.as_tensor(q)
    return torch.pow(10.0, -q.to(torch.float32) / 10.0)


_prob_tables: dict[torch.device, torch.Tensor] = {}


def _prob_table(device: torch.device) -> torch.Tensor:
    """float32[256] on ``device``: the probability of every uint8 phred,
    made once per device by :func:`_phred_to_prob`, so a kernel that looks
    a phred up reads the bits the plain version computes."""
    with _launch_lock:
        table = _prob_tables.get(device)
        if table is None:
            table = _phred_to_prob(torch.arange(
                256, dtype=torch.uint8, device=device)).contiguous()
            _prob_tables[device] = table
        return table


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


# The recurrence's float32 arithmetic as XLA's CPU backend runs the
# reference's ``_pairhmm_jax``: every result is flushed (FTZ; since no
# flushed result can be subnormal, later inputs never are, which is DAZ),
# and ``a * b + c * d`` is one fused multiply-add of the first product
# onto the rounded second, ``fma(a, b, c * d)``.  The kernels follow the
# same order with ``-ftz=true --fmad=false`` and explicit FMAs.

def _mul(a, b):
    return _flush(a * b)


def _add(a, b):
    return _flush(a + b)


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once: the product is exact in float64
    and the sum rounds there first (a double rounding that differs from a
    single one with probability ~2^-29 per operation)."""
    return _flush((a.double() * b.double() + c.double()).float())


def _finish(acc: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """log10 likelihood from the scaled sum and its log10 shift.  The
    -inf is a Python scalar: a tensor made from it on the card would be a
    host-to-device copy per call, which makes the host wait for the
    kernel before it."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(
        acc > 0.0,
        torch.log10(torch.clamp(acc, min=tiny)) - shift - LOG10_INITIAL,
        -math.inf)


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
    last_row = rvec + 1 == rlen

    def shift(x, fill):
        return torch.cat([fill, x[:-1]], dim=0)

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
    # diagonals past every pair's rlen + hlen add nothing to acc
    dmax = min(R + H, int((rlen + hlen).max())) if B else 0
    for d in range(1, dmax + 1):
        hapd = shift(hapd, hap_codes[min(max(d - 2, 0), H - 1)][None])
        jvec = d - rvec - 1
        live = jvec >= 1
        match = (read_codes == hapd) | read_is_n | (hapd >= 4)
        prior = torch.where(match, prior_match, prior_mismatch)
        gap2 = _add(shift(i2, zero_row), shift(d2, bound))
        m_new = cell(_mul(prior, _fma(shift(m2, zero_row), a_mm,
                                      _mul(gap2, a_im))), live)
        i_new = cell(_fma(shift(m1, zero_row), p_ins,
                          _mul(shift(i1, zero_row), p_cont)), live)
        d_new = cell(_fma(m1, p_del, _mul(d1, p_cont)), live)
        amask = last_row & live & (jvec <= hlen)
        acc = _add(acc, torch.where(amask, _add(m_new, i_new), 0.0).sum(
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
    acc = torch.empty(B, dtype=torch.float32, device=read.device)
    sh = torch.empty(B, dtype=torch.float32, device=read.device)
    err = lib.fgt_pairhmm(
        read.data_ptr(), base_q.data_ptr(), table.data_ptr(),
        rlen.data_ptr(), hap.data_ptr(), hlen.data_ptr(), B, R, H, *trans,
        acc.data_ptr(), sh.data_ptr(), stream)
    _build.check(err, "fgt_pairhmm")
    return _finish(acc, sh)


def _pairhmm_pb_launch(lib, read, planes, rlen, hap, hlen, stream
                       ) -> torch.Tensor:
    """Launch K5 from ``lib`` on contiguous inputs, ``planes`` = (base_q,
    ins_q, del_q, gcp); returns (B,) log10 on the inputs' device."""
    B, R = read.shape
    H = hap.shape[1]
    table = _prob_table(read.device)
    acc = torch.empty(B, dtype=torch.float32, device=read.device)
    sh = torch.empty(B, dtype=torch.float32, device=read.device)
    err = lib.fgt_pairhmm_pb(
        read.data_ptr(), *(q.data_ptr() for q in planes), table.data_ptr(),
        rlen.data_ptr(), hap.data_ptr(), hlen.data_ptr(), B, R, H,
        acc.data_ptr(), sh.data_ptr(), stream)
    _build.check(err, "fgt_pairhmm_pb")
    return _finish(acc, sh)


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


def _gather(pieces, n: int) -> np.ndarray:
    """(n,) float32 on the host from (offset, ranges, log10) pieces, read
    back once every piece's launch is enqueued."""
    out = np.empty(n, np.float32)
    for s0, ranges, logp in pieces:
        got = logp.cpu().numpy()
        at = 0
        for s, e in ranges:
            out[s0 + s:s0 + e] = got[at:at + e - s]
            at += e - s
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
    mesh each call's pairs split evenly over the mesh's devices."""
    B, Rin = read_codes.shape
    Hin = hap_codes.shape[1]
    R, H = params.max_read_len, params.max_hap_len
    if ((max(Rin, 8) + 7) // 8) * 8 > R:
        raise ValueError(f"read bucket {Rin} exceeds {R}")
    if Hin > H:
        raise ValueError(f"hap bucket {Hin} exceeds {H}")
    from ..parallel.mesh import device_lanes, get_active_mesh, lanes_on
    trans = (ins_q, del_q, gcp)
    per_base = any(_is_plane(q) for q in trans)
    mesh = get_active_mesh()
    devices = mesh.flat if mesh is not None else [params.device]
    pin = any(torch.device(d).type == "cuda" for d in devices)
    pieces = []
    for s0 in range(0, B, MAX_PAIRS_PER_CALL):
        e0 = min(B, s0 + MAX_PAIRS_PER_CALL)
        n = e0 - s0

        def cut(q):     # scalar phreds pass through unsliced
            return q[s0:e0] if _is_plane(q) else q

        # the chunk padded once on the host (megabytes: pinned for the
        # card, whose copies then take half the device time and do not
        # wait for the host); each device takes its lanes
        host = [_host_plane(read_codes[s0:e0], n, R, 4, pin),
                _host_plane(cut(base_q), n, R, 0, pin),
                _host_vector(read_lens[s0:e0], torch.int32, pin),
                _host_plane(hap_codes[s0:e0], n, H, 4, pin),
                _host_vector(hap_lens[s0:e0], torch.int32, pin)]
        if per_base:
            host += [_host_plane(cut(q), n, R, 0, pin) for q in trans]
        for dev, ranges in device_lanes(devices, n):
            read, bq, rl, hap, hl, *planes = (lanes_on(t, ranges, dev)
                                              for t in host)
            if per_base:
                logp = pairhmm_pb(read, bq, *planes, rl, hap, hl)
            else:
                logp = pairhmm_sc(read, bq, rl, hap, hl,
                                  *(int(q) for q in trans))
            pieces.append((s0, ranges, logp))
    return _gather(pieces, B)


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
    B <= 8192 (callers chunk).  Under an active mesh the pair lanes
    split over the mesh's devices and each device gets the unique reads
    and haplotypes once."""
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
    from ..parallel.mesh import device_lanes, get_active_mesh, lanes_on
    mesh = get_active_mesh()
    devices = mesh.flat if mesh is not None else [params.device]
    # tens of kilobytes: pinning them costs more host time than the
    # copies save (traced on the card)
    tables = (_host_plane(reads, NR, R, 4, False),
              _host_plane(quals, NR, R, 0, False),
              _host_vector(read_lens, torch.int32, False),
              _host_plane(haps, NH, H, 4, False),
              _host_vector(hap_lens, torch.int32, False))
    index = (_host_vector(pair_read, torch.int64, False),
             _host_vector(pair_hap, torch.int64, False))
    pieces = []
    for dev, ranges in device_lanes(devices, B):
        rd, q, rl, hp, hl = (t.to(dev, non_blocking=True) for t in tables)
        pr, ph = (lanes_on(t, ranges, dev) for t in index)
        pieces.append((0, ranges, pairhmm_sc(
            rd[pr], q[pr], rl[pr], hp[ph], hl[ph],
            int(ins_q), int(del_q), int(gcp))))
    return _gather(pieces, B)
