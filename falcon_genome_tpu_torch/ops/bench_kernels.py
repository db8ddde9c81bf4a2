"""The benchmark kernels on PyTorch tensors: the float32 FMA ceiling (K6)
and the score-only Smith-Waterman ablation (K7).

* :func:`fma_ceiling` (``csrc/bench_kernels.cu`` ``fgt_fma_ceiling``),
  the port of ``bench.py``'s ``bench_pallas_fma_ceiling``: 64 independent
  chains ``s = s * a + b`` per element of a (R, B) float32 tile for
  ``trips`` trips, the dependence-free twin of the PairHMM kernel's loop;
  its rate is the denominator of ``pairhmm_mfu``.
* :func:`sw_score_ablate` (``fgt_sw_score_ablate``), the port of
  ``benchmarks/ablate_sw.py``'s ``make_kernel``: the score-only
  Smith-Waterman sweep over the full band (every diagonal 1..R+W for all
  R rows) with the best tracking, the validity mask or the window shift
  removed.  The kernel is K1's sweep design (NR rows a thread, the
  window's codes in shared memory, one best-cell key a row, 8 warps a
  block), each flag taking exactly its group of work out of the step.
  The ablated variants compute other scores on purpose; only their time
  matters.

A wrapper handed CPU tensors runs the plain version; handed CUDA tensors
it launches the kernel, or raises; any other device raises.
``LAUNCHES`` counts kernel launches per kernel.
"""
from __future__ import annotations

import threading

import torch

from . import _build
from .smith_waterman import POS_STRIDE, _check_lanes, _cuda_args
from .sw_ref import NEG, SWParams

FMA_CHAINS = 64
FMA_A = 1.0000001
FMA_B = 1e-9
FMA_UNROLL = 4          # trips per iteration of the kernel's trip loop

# kernel launches since the last reset
LAUNCHES = {"fgt_fma_ceiling": 0, "fgt_sw_score_ablate": 0}
_launch_lock = threading.Lock()


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def fma_ceiling_flops(R: int, B: int, trips: int) -> float:
    """Flops of one :func:`fma_ceiling` call, an FMA counted as two."""
    return 2.0 * FMA_CHAINS * trips * R * B


def _fma_rn(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once, as ``fmaf``.  The product is
    exact in float64; the sum is kept exact as ``hi + lo`` (two-sum) and
    ``hi`` is rounded to odd (moved off an even last bit towards ``lo``),
    after which the rounding to float32 is the correct one."""
    p = x.double() * y.double()
    zd = z.double()
    hi = p + zd
    bb = hi - p
    lo = (p - (hi - bb)) + (zd - bb)
    even = (hi.view(torch.int64) & 1) == 0
    toward = torch.where(lo > 0, torch.inf, -torch.inf).to(hi.dtype)
    hi = torch.where((lo != 0) & even, torch.nextafter(hi, toward), hi)
    return hi.float()


def _fma_ceiling_plain(x: torch.Tensor, trips: int) -> torch.Tensor:
    """The (64, R, B) chains updated ``trips`` times with one rounding per
    update (as the kernel's FFMA), then summed over the chains in order
    and over the rows in order: bit-equal to the kernel."""
    f32 = torch.float32
    a = torch.tensor(FMA_A, dtype=f32, device=x.device)
    b = torch.tensor(FMA_B, dtype=f32, device=x.device)
    s = x.to(f32).expand(FMA_CHAINS, *x.shape).clone()
    for _ in range(trips):
        s = _fma_rn(s, a, b)
    tot = s[0].clone()
    for c in range(1, FMA_CHAINS):
        tot += s[c]
    out = tot[0].clone()
    for r in range(1, tot.shape[0]):
        out += tot[r]
    return out


def fma_ceiling(x: torch.Tensor, trips: int) -> torch.Tensor:
    """K6: x (R, B) float32 → (B,) float32, each element's 64 chains run
    for ``trips`` trips (a multiple of 4) and summed."""
    if x.dim() != 2:
        raise ValueError("fma_ceiling: x must be (R, B)")
    R, B = x.shape
    if x.device.type == "cpu":
        return _fma_ceiling_plain(x, trips)
    if x.device.type != "cuda":
        raise ValueError(f"no FMA-ceiling kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError("fma_ceiling: x must be float32")
    if not 1 <= R <= 1024 or trips % FMA_UNROLL:
        raise ValueError(f"fma_ceiling: rows 1-1024 and trips a multiple of"
                         f" {FMA_UNROLL} (got {R}, {trips})")
    with torch.cuda.device(x.device):
        out = _fma_ceiling_launch(
            _build.load(), x.contiguous(), trips,
            torch.cuda.current_stream(x.device).cuda_stream)
        _count("fgt_fma_ceiling")
        return out


def _fma_ceiling_launch(lib, x: torch.Tensor, trips: int, stream
                        ) -> torch.Tensor:
    """Launch K6 from ``lib`` on a contiguous (R, B) float32 ``x``;
    returns (B,) on its device."""
    R, B = x.shape
    out = torch.empty(B, dtype=torch.float32, device=x.device)
    err = lib.fgt_fma_ceiling(x.data_ptr(), R, B, trips, FMA_A, FMA_B, 0.0,
                              out.data_ptr(), stream)
    _build.check(err, "fgt_fma_ceiling")
    return out


def _sw_ablate_plain(read, rlen, win, wlen, params: SWParams, *,
                     no_best: bool, no_mask: bool, no_window: bool):
    """Per-diagonal sweep over (R, B), the twin of ``make_kernel``:
    time-major read (R, B), win (W, B) int32 codes, rlen/wlen (1, B).
    Returns ((B,) score, (B,) pos) int32."""
    i32 = torch.int32
    dev = read.device
    R, B = read.shape
    W = win.shape[0]
    go, ge = params.gap_open + params.gap_ext, params.gap_ext
    rvec = torch.arange(R, dtype=i32, device=dev).reshape(R, 1)
    zero_row = torch.zeros((1, B), dtype=i32, device=dev)
    neg_row = torch.full((1, B), NEG, dtype=i32, device=dev)
    no_row = torch.full((R, 1), 1 << 30, dtype=i32, device=dev)
    match = torch.tensor(params.match, dtype=i32, device=dev)

    def shift(x, fill):
        return torch.cat([fill, x[:-1]], dim=0)

    h1 = torch.zeros((R, B), dtype=i32, device=dev)
    h2 = torch.zeros_like(h1)
    e1 = torch.full((R, B), NEG, dtype=i32, device=dev)
    f1 = e1.clone()
    wind = torch.zeros_like(h1)
    score = torch.zeros((1, B), dtype=i32, device=dev)
    pos = torch.zeros_like(score)
    for d in range(1, R + W + 1):
        if not no_window:
            wind = shift(wind, win[min(max(d - 1, 0), W - 1)][None])
        e_new = torch.maximum(h1 - go, e1 - ge)
        f_new = torch.maximum(shift(h1, zero_row) - go,
                              shift(f1, neg_row) - ge)
        sub = torch.where(read == wind, match, -params.mismatch)
        diag = shift(h2, zero_row) + sub
        h_new = torch.maximum(torch.clamp(diag, min=0),
                              torch.maximum(e_new, f_new))
        if not no_mask:
            jvec = d - rvec
            valid = (jvec >= 1) & (jvec <= wlen) & (rvec < rlen)
            h_new = torch.where(valid, h_new, 0)
            e_new = torch.where(valid, e_new, NEG)
            f_new = torch.where(valid, f_new, NEG)
        if not no_best:
            m = h_new.amax(dim=0, keepdim=True)
            rowarg = torch.where(h_new == m, rvec, no_row).amin(
                dim=0, keepdim=True)
            upd = m > score
            score = torch.where(upd, m, score)
            pos = torch.where(upd, d * POS_STRIDE + rowarg, pos)
        h1, h2, e1, f1 = h_new, h1, e_new, f_new
    if no_best:
        score = h1.amax(dim=0, keepdim=True)
    return score[0], pos[0]


def _check_ablate_params(params: SWParams, R: int, W: int) -> None:
    """What K7's sweep assumes: a row's best cell is kept as one key,
    score * 4096 + D - jj (jj the diagonal of the thread's first row), so
    R + W + 12 <= 4096 and scores below 2^18; at least one row and one
    window column."""
    if R < 1 or W < 1 or R + W + 12 > POS_STRIDE:
        raise ValueError(f"sw_score_ablate: bucket {R} x {W} needs R, W >= 1"
                         f" and R + W <= {POS_STRIDE - 12}")
    if max(R * params.match, 0) >= 1 << 18:
        raise ValueError(f"sw_score_ablate: {R} rows with match "
                         f"{params.match} exceed the kernel's best-cell key")


def _sw_ablate_launch(lib, read, rlen, win, wlen, params: SWParams,
                      flags: int, stream):
    """Launch K7 from ``lib`` on contiguous lane-major inputs; returns
    (score, pos) allocated on the inputs' device."""
    B, R = read.shape
    W = win.shape[1]
    _check_ablate_params(params, R, W)
    score = torch.empty(B, dtype=torch.int32, device=read.device)
    pos = torch.empty(B, dtype=torch.int32, device=read.device)
    err = lib.fgt_sw_score_ablate(
        read.data_ptr(), win.data_ptr(), rlen.data_ptr(), wlen.data_ptr(),
        B, R, W, params.match, params.mismatch,
        params.gap_open + params.gap_ext, params.gap_ext, flags,
        score.data_ptr(), pos.data_ptr(), stream)
    _build.check(err, "fgt_sw_score_ablate")
    return score, pos


def sw_score_ablate(read, rlen, win, wlen, params: SWParams, *,
                    no_best: bool = False, no_mask: bool = False,
                    no_window: bool = False):
    """K7.  Lane-major inputs as ``smith_waterman.sw_score``: read (B, R)
    int8 codes, win (B, W) int8, rlen/wlen (B,) int32 → ((B,) score,
    (B,) pos) int32 on the inputs' device.  With no flag set it equals
    ``sw_score`` (kernel K1).  On the card the kernel sweeps in K1's
    layout (a thread's NR = ceil(R / 32) rows on one column a step, the
    window's codes from shared memory, a best-cell key a row) over the
    full band, with guarded steps before and after it
    (``csrc/bench_kernels.cu``); it takes R + W up to 4084 and
    R * match below 2^18."""
    _check_lanes(read, rlen, win, wlen)
    if read.device.type == "cpu":
        return _sw_ablate_plain(
            read.T.to(torch.int32), rlen[None], win.T.to(torch.int32),
            wlen[None], params, no_best=no_best, no_mask=no_mask,
            no_window=no_window)
    read, win, rlen, wlen = _cuda_args(read, rlen, win, wlen)
    flags = int(no_best) | int(no_mask) << 1 | int(no_window) << 2
    with torch.cuda.device(read.device):
        out = _sw_ablate_launch(
            _build.load(), read, rlen, win, wlen, params, flags,
            torch.cuda.current_stream(read.device).cuda_stream)
        _count("fgt_sw_score_ablate")
        return out
