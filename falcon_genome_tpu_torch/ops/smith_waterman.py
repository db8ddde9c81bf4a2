"""Batched local affine Smith-Waterman on PyTorch tensors.

Port of ``falcon_genome_tpu/ops/smith_waterman.py``.  Each lane aligns one
read against one reference window.  Three kernels carry the work, each a
hand-written CUDA kernel (``csrc/smith_waterman.cu``) with its plain
PyTorch version beside it:

* :func:`sw_score` — score-only sweep (best score and ``bestpos``), used to
  rank the aligner's seed candidates;
* :func:`sw_pointers` — the full sweep, which also writes the traceback
  pointers (a byte per cell in the plain version, 4 bits in the kernel's
  own layout, :func:`_pointer_shape`);
* :func:`sw_traceback` — the pointer walk that emits the packed op stream
  and path coordinates (:func:`sw_full` runs both).  The pointer array
  never leaves the device.

A wrapper handed CPU tensors runs the plain version (``_sw_scan_core`` and
``_traceback_core``); handed CUDA tensors it launches the kernel, or
raises.  ``LAUNCHES`` counts kernel launches per kernel.

Around the kernels, as in the reference: the genome is resident on the
device (:func:`device_genome`), reads are shipped once per batch
(:func:`device_reads`), and candidate lanes are assembled on the device —
window gather and reverse complement (:func:`_lane_inputs`).  The pair
path (:func:`sw_pair_dispatch`) scores every candidate, picks each
fragment's best mate combination, and extends the winners without
returning to the host in between.  The long-read path
(:func:`sw_extend_win_dispatch`) ships its chunk reads and gathers their
windows from the resident genome; it only enqueues, and its handle is
collected later.  A gathered window is at most the bucket's W columns
(:func:`_check_windows`).

``bestpos = d * 4096 + row`` for anti-diagonal ``d = row + j`` (window
column ``j`` 1-based); ties in score go to the smallest diagonal, then the
smallest row.  Pointer per cell: bits 0-1 hdir (0 stop, 1 diag,
2 from E/deletion, 3 from F/insertion), bit 2 E-extend, bit 3 F-extend.
The launches are helpers that take the kernel library (``_sw_*_launch``),
so a host build of the CUDA source can run them on CPU tensors (see
``tests/test_torch_sw_emulated.py``).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..io import native_ext
from ..io.sam import CIGAR_S, Cigar

from . import _build
from .sw_ref import NEG, SWParams, SWResult

POS_STRIDE = 4096  # bestpos = diagonal * POS_STRIDE + row

# Bounds the on-device pointer array of one full-SW call: 4 bits per cell
# of R rows x (W + 31) steps per lane (``_pointer_shape``), ~0.19 GB at
# 8192 lanes of the aligner's 160 x 256 bucket
MAX_LANES_PER_CALL = 8192

# kernel launches since the last reset, per CUDA entry point
LAUNCHES = {"fgt_sw_score": 0, "fgt_sw_full": 0, "fgt_sw_traceback": 0}
_launch_lock = threading.Lock()


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


@dataclasses.dataclass(frozen=True)
class SWBucket:
    """Largest read and window a call accepts, and the device it runs on."""
    max_read_len: int = 160
    max_win_len: int = 416
    device: torch.device = DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class PairPolicy:
    """Pair-selection parameters for the fused pair path (mirrors
    AlignerParams' pairing fields)."""
    max_candidates: int = 4
    window_pad: int = 32
    min_insert: int = 0
    max_insert: int = 1000
    unpaired_penalty: int = 17


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernels' comparison on the card)
# ---------------------------------------------------------------------------

def _sw_scan_core(read, rlen, win, wlen, *, params: SWParams, R: int,
                  W: int):
    """Anti-diagonal sweep, the plain twin of kernels K1/K2.

    read (R, B) int32, rlen (1, B), win (W, B), wlen (1, B) — time-major,
    as the reference.  Returns ((R+W, R, B) int8 pointers, (1, B) best
    score, (1, B) bestpos)."""
    i32 = torch.int32
    dev = read.device
    B = read.shape[1]
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
    best = torch.zeros((1, B), dtype=i32, device=dev)
    bestpos = torch.zeros_like(best)
    ptrs = torch.empty((R + W, R, B), dtype=torch.int8, device=dev)
    for d in range(R + W):
        wind = shift(wind, win[min(max(d - 1, 0), W - 1)][None])
        jv = d - rvec
        e_open = h1 - go
        e_ext = e1 - ge
        e_new = torch.maximum(e_open, e_ext)
        eext = (e_ext > e_open).to(i32)
        f_open = shift(h1, zero_row) - go
        f_ext = shift(f1, neg_row) - ge
        f_new = torch.maximum(f_open, f_ext)
        fext = (f_ext > f_open).to(i32)
        sub = torch.where(read == wind, match, -params.mismatch)
        diag = shift(h2, zero_row) + sub
        h_new = torch.maximum(torch.clamp(diag, min=0),
                              torch.maximum(e_new, f_new))
        valid = (jv >= 1) & (jv <= wlen) & (rvec < rlen)
        h_new = torch.where(valid, h_new, 0)
        e_new = torch.where(valid, e_new, NEG)
        f_new = torch.where(valid, f_new, NEG)
        hdir = torch.where(
            h_new == 0, 0,
            torch.where(h_new == diag, 1, torch.where(h_new == e_new, 2, 3)))
        ptrs[d] = (hdir | (eext << 2) | (fext << 3)).to(torch.int8)
        m = h_new.amax(dim=0, keepdim=True)
        rowarg = torch.where(h_new == m, rvec, no_row).amin(dim=0,
                                                             keepdim=True)
        upd = m > best
        best = torch.where(upd, m, best)
        bestpos = torch.where(upd, d * POS_STRIDE + rowarg, bestpos)
        h1, h2, e1, f1 = h_new, h1, e_new, f_new
    return ptrs, best, bestpos


def _traceback_core(ptrs, best, bestpos, *, max_steps: int):
    """Lockstep pointer walk, the plain twin of kernel K3.

    ptrs (D, R, B) int8 from :func:`_sw_scan_core`; best/bestpos (B,).
    Returns ((ceil(max_steps/4), B) uint8 op stream packed 4 per byte as
    op + 1 (op -1 none, 0 M, 1 I, 2 D), (4, B) int32 coordinates
    (read_start, ref_start, read_end, ref_end), (B,) int32 best)."""
    D, R, B = ptrs.shape
    dev = ptrs.device
    flat = ptrs.reshape(D * R, B)
    bestpos = bestpos.to(torch.int32)
    d_prog = torch.div(bestpos, POS_STRIDE, rounding_mode="floor")
    r = bestpos - d_prog * POS_STRIDE
    bi = r + 1
    bj = d_prog - r
    i, j = bi.clone(), bj.clone()
    phase = torch.zeros(B, dtype=torch.int32, device=dev)
    active = best > 0
    ops = torch.full((max_steps, B), -1, dtype=torch.int32, device=dev)
    t = 0
    while t < max_steps and bool(active.any()):
        idx = ((i + j - 1) * R + (i - 1)).clamp(0, D * R - 1)
        byte = flat.gather(0, idx[None].long())[0].to(torch.int32)
        hdir = byte & 3
        eext = (byte >> 2) & 1
        fext = (byte >> 3) & 1
        act = active & (i > 0) & (j > 0)
        is_h = phase == 0
        stop = act & is_h & (hdir == 0)
        do_m = act & is_h & (hdir == 1)
        in_e = act & ((phase == 1) | (is_h & (hdir == 2)))
        in_f = act & ((phase == 2) | (is_h & (hdir == 3))) & ~in_e
        moving = act & ~stop
        op = torch.where(do_m, 0, torch.where(in_e, 2, torch.where(in_f, 1,
                                                                    -1)))
        ops[t] = torch.where(moving, op, -1)
        i = i - (moving & (do_m | in_f)).to(torch.int32)
        j = j - (moving & (do_m | in_e)).to(torch.int32)
        phase = torch.where(in_e & (eext == 1), 1,
                            torch.where(in_f & (fext == 1), 2, 0))
        active = moving
        t += 1
    S4 = (max_steps + 3) // 4 * 4
    ops2 = torch.zeros((S4, B), dtype=torch.int32, device=dev)
    ops2[:max_steps] = ops + 1
    ops2 = ops2.reshape(S4 // 4, 4, B)
    packed = (ops2[:, 0] | (ops2[:, 1] << 2) | (ops2[:, 2] << 4)
              | (ops2[:, 3] << 6)).to(torch.uint8)
    coords = torch.stack([i, j, bi, bj]).to(torch.int32)
    return packed, coords, best.to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_lanes(read, rlen, win, wlen) -> None:
    if read.dim() != 2 or win.dim() != 2 or read.shape[0] != win.shape[0]:
        raise ValueError("read (B, R) and win (B, W) must share B")
    B = read.shape[0]
    if rlen.shape != (B,) or wlen.shape != (B,):
        raise ValueError("rlen/wlen must be (B,)")
    if read.shape[1] >= POS_STRIDE:
        raise ValueError(f"read rows must stay below {POS_STRIDE}")


def _cuda_args(read, rlen, win, wlen):
    """Validate CUDA inputs; returns contiguous (read, win, rlen, wlen)."""
    if read.device.type != "cuda":
        raise ValueError(f"no Smith-Waterman kernel for device {read.device}")
    for t in (rlen, win, wlen):
        if t.device != read.device:
            raise ValueError("all inputs must be on one device")
    if read.dtype != torch.int8 or win.dtype != torch.int8:
        raise TypeError("read/win must be int8 codes")
    if rlen.dtype != torch.int32 or wlen.dtype != torch.int32:
        raise TypeError("rlen/wlen must be int32")
    return (read.contiguous(), win.contiguous(), rlen.contiguous(),
            wlen.contiguous())


def _plain_scan(read, rlen, win, wlen, params):
    """Lane-major inputs → time-major plain sweep, cut to the longest
    read and window.  A lane's cells are its rows below rlen and its
    columns up to min(wlen, W), as in the kernels (rows and columns past
    every lane's length are then invalid in every lane, so the cut is
    exact).  ``_sw_scan_core`` alone, like the reference's, sweeps on
    past column W for a longer wlen (see :func:`_check_windows`)."""
    R = max(1, int(rlen.max())) if len(rlen) else 1
    R = min(R, read.shape[1])
    wlen = torch.clamp(wlen, max=win.shape[1])
    W = max(1, int(wlen.max())) if len(wlen) else 1
    return _sw_scan_core(read[:, :R].T.to(torch.int32), rlen[None],
                         win[:, :W].T.to(torch.int32), wlen[None],
                         params=params, R=R, W=W)


def _pointer_shape(B: int, R: int, W: int) -> tuple[int, ...]:
    """Shape of K2's int32 pointer array, (B, stripes, words, 32 NR): the
    kernel's thread t owns rows t NR .. t NR + NR - 1 of a stripe of 32 NR
    rows (NR = ceil(R / 32) up to 12; longer reads in stripes of 384 rows)
    and sweeps column j of them at step s = j - 1 + t; the pointers of
    steps 8 w .. 8 w + 7 of a row are word w, 4 bits a cell (step s % 8 at
    bit 4 (s % 8)).  Words per row: the W + 31 steps rounded up to 8."""
    nr = min(max(1, -(-R // 32)), 12)
    return (B, -(-R // (32 * nr)), -(-(W + 31) // 8), 32 * nr)


def _check_kernel_params(params: SWParams, R: int, W: int) -> None:
    """What the kernels' sweep assumes of the parameters: penalties of at
    least 0 (a cell left of the window then holds exactly 0), a window
    below 4096 columns and scores below 2^18 (a row's best cell is kept
    as one key, score * 4096 + 4095 - column)."""
    if min(params.mismatch, params.gap_ext,
           params.gap_open + params.gap_ext) < 0:
        raise ValueError("the SW kernels need penalties >= 0")
    if W >= POS_STRIDE or max(min(R, W) * params.match, 0) >= 1 << 18:
        raise ValueError(f"SW bucket {R} x {W} with match {params.match} "
                         "exceeds the kernels' best-cell key")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _sw_score_launch(lib, read, rlen, win, wlen, params: SWParams, stream):
    """Launch K1 from ``lib`` on contiguous inputs; returns (score, pos)
    allocated on the inputs' device."""
    B, R = read.shape
    W = win.shape[1]
    _check_kernel_params(params, R, W)
    score = torch.empty(B, dtype=torch.int32, device=read.device)
    pos = torch.empty(B, dtype=torch.int32, device=read.device)
    err = lib.fgt_sw_score(
        read.data_ptr(), win.data_ptr(), rlen.data_ptr(), wlen.data_ptr(),
        B, R, W, params.match, params.mismatch,
        params.gap_open + params.gap_ext, params.gap_ext,
        score.data_ptr(), pos.data_ptr(), stream)
    _build.check(err, "fgt_sw_score")
    return score, pos


def _sw_full_launch(lib, read, rlen, win, wlen, params: SWParams, stream):
    """Launch K2 from ``lib``; returns (pointers, best, pos)."""
    B, R = read.shape
    W = win.shape[1]
    _check_kernel_params(params, R, W)
    dev = read.device
    ptr = torch.empty(_pointer_shape(B, R, W), dtype=torch.int32, device=dev)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    pos = torch.empty(B, dtype=torch.int32, device=dev)
    err = lib.fgt_sw_full(
        read.data_ptr(), win.data_ptr(), rlen.data_ptr(), wlen.data_ptr(),
        B, R, W, params.match, params.mismatch,
        params.gap_open + params.gap_ext, params.gap_ext,
        ptr.data_ptr(), best.data_ptr(), pos.data_ptr(), stream)
    _build.check(err, "fgt_sw_full")
    return ptr, best, pos


def _sw_traceback_launch(lib, ptrs, best, pos, max_steps: int, stream):
    """Launch K3 from ``lib`` over K2's pointers; returns (packed,
    coords, best)."""
    if ptrs.dim() != 4 or ptrs.dtype != torch.int32 or ptrs.shape[3] % 32:
        raise TypeError("ptrs must be the (B, stripes, words, 32 NR) int32 "
                        "output of sw_pointers")
    B, nst, nblk, rows = ptrs.shape
    for t in (best, pos):
        if t.shape != (B,) or t.dtype != torch.int32 or \
                t.device != ptrs.device:
            raise TypeError(f"best/pos must be ({B},) int32 on {ptrs.device}")
    dev = ptrs.device
    ptrs, best, pos = ptrs.contiguous(), best.contiguous(), pos.contiguous()
    packed = torch.empty(((max_steps + 3) // 4, B), dtype=torch.uint8,
                         device=dev)
    coords = torch.empty((4, B), dtype=torch.int32, device=dev)
    err = lib.fgt_sw_traceback(
        ptrs.data_ptr(), best.data_ptr(), pos.data_ptr(), B, rows // 32, nst,
        nblk, max_steps, packed.data_ptr(), coords.data_ptr(), stream)
    _build.check(err, "fgt_sw_traceback")
    return packed, coords, best


def sw_score(read, rlen, win, wlen, params: SWParams):
    """Score-only SW (kernel K1).  read (B, R) int8 codes, win (B, W) int8
    (5 = off-genome), rlen/wlen (B,) int32 → ((B,) score, (B,) bestpos)
    int32 on the inputs' device."""
    _check_lanes(read, rlen, win, wlen)
    if read.device.type == "cpu":
        _, best, pos = _plain_scan(read, rlen, win, wlen, params)
        return best[0], pos[0]
    read, win, rlen, wlen = _cuda_args(read, rlen, win, wlen)
    with torch.cuda.device(read.device):
        out = _sw_score_launch(_build.load(), read, rlen, win, wlen, params,
                               _stream(read))
        _count("fgt_sw_score")
    return out


def sw_pointers(read, rlen, win, wlen, params: SWParams):
    """Full SW sweep with traceback pointers (kernel K2).  Inputs as
    :func:`sw_score`.  Returns (pointers, best (B,), bestpos (B,)); the
    pointer layout is the version's own — (R+W, R, B) for the plain sweep,
    :func:`_pointer_shape` for the kernel — and only :func:`sw_traceback`
    reads it."""
    _check_lanes(read, rlen, win, wlen)
    if read.device.type == "cpu":
        ptrs, best, pos = _plain_scan(read, rlen, win, wlen, params)
        return ptrs, best[0], pos[0]
    read, win, rlen, wlen = _cuda_args(read, rlen, win, wlen)
    with torch.cuda.device(read.device):
        out = _sw_full_launch(_build.load(), read, rlen, win, wlen, params,
                              _stream(read))
        _count("fgt_sw_full")
    return out


def sw_traceback(ptrs, best, pos, max_steps: int):
    """Pointer walk (kernel K3) over :func:`sw_pointers` output.  Returns
    (packed ops (ceil(max_steps/4), B) uint8, coords (4, B) int32,
    best (B,) int32)."""
    if ptrs.device.type == "cpu":
        return _traceback_core(ptrs, best, pos, max_steps=max_steps)
    if ptrs.device.type != "cuda":
        raise ValueError(f"no Smith-Waterman kernel for device {ptrs.device}")
    with torch.cuda.device(ptrs.device):
        out = _sw_traceback_launch(_build.load(), ptrs, best, pos,
                                   max_steps, _stream(ptrs))
        _count("fgt_sw_traceback")
    return out


def sw_full(read, rlen, win, wlen, params: SWParams, max_steps: int):
    """Full SW and traceback (K2 then K3); the pointer array stays on the
    device.  Returns as :func:`sw_traceback`."""
    return sw_traceback(*sw_pointers(read, rlen, win, wlen, params),
                        max_steps)


# ---------------------------------------------------------------------------
# device-resident genome + on-device lane assembly
# ---------------------------------------------------------------------------

def device_genome(genome_codes: np.ndarray, device: torch.device
                  ) -> torch.Tensor:
    """The reference genome as int8 codes on ``device``, shipped once;
    windows are gathered from it on the device thereafter."""
    return torch.from_numpy(np.ascontiguousarray(genome_codes, np.int8)
                            ).to(device)


def device_reads(reads: np.ndarray, device: torch.device) -> torch.Tensor:
    """A (NR, R) batch of padded read codes as int8 on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(reads, np.int8)).to(device)


def _lane_inputs(reads8, read_idx, is_rev, rlen, genome, starts, W: int):
    """Per-lane (read, window) tiles assembled on the reads' device.

    reads8 (NR, R) int8; read_idx/is_rev/rlen/starts (B,).  Reverse-strand
    lanes get the reverse complement; window positions outside the genome
    get code 5, which matches no base.  Returns (B, R) and (B, W) int8."""
    dev = reads8.device
    R = reads8.shape[1]
    read = reads8[read_idx.long()]
    rvec = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    rl = rlen[:, None]
    rev = (is_rev > 0)[:, None]
    ridx = torch.where(rev, rl - 1 - rvec, rvec).clamp(0, R - 1)
    gathered = read.gather(1, ridx.long())
    comp = torch.where(gathered < 4, 3 - gathered, gathered)
    read = torch.where(rvec < rl, torch.where(rev, comp, gathered),
                       4).to(torch.int8)
    G = genome.shape[0]
    widx = starts[:, None].long() + torch.arange(W, device=dev)[None, :]
    valid = (widx >= 0) & (widx < G)
    win = genome[widx.clamp(0, max(G - 1, 0))]
    win = torch.where(valid, win, 5).to(torch.int8)
    return read, win


def _lane_meta(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in arrays]


def _check_windows(win_lens, bucket: SWBucket) -> None:
    """Gathered windows are cut to the bucket's W columns.  The reference
    sweeps a longer ``wlen`` on past column W (its last code repeated, up
    to the sweep's last anti-diagonal) where the kernels stop at W; no
    path makes such a lane (the aligner's windows are its reads plus
    2 x 32, indel's targets at most 300 bases), so one is refused rather
    than aligned differently."""
    if len(win_lens) and int(np.max(win_lens)) > bucket.max_win_len:
        raise ValueError(f"a window of {int(np.max(win_lens))} columns "
                         f"exceeds the bucket's {bucket.max_win_len}")


def sw_score_gather(reads8_dev, read_idx, is_rev, read_lens, genome_dev,
                    win_starts, win_lens, params: SWParams = SWParams(),
                    bucket: SWBucket = SWBucket()
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Score-only SW over candidate lanes assembled on the device.
    Returns (score, bestpos) per lane."""
    B = len(read_idx)
    if B == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    _check_windows(win_lens, bucket)
    ridx, rev, rl, st, wl = _lane_meta(reads8_dev.device, read_idx, is_rev,
                                       read_lens, win_starts, win_lens)
    read, win = _lane_inputs(reads8_dev, ridx, rev, rl, genome_dev, st,
                             bucket.max_win_len)
    score, pos = sw_score(read, rl, win, wl, params)
    return score.cpu().numpy(), pos.cpu().numpy()


def sw_extend_gather(reads8_dev, read_idx, is_rev, read_lens, genome_dev,
                     win_starts, win_lens, params: SWParams = SWParams(),
                     bucket: SWBucket = SWBucket()) -> list[SWResult]:
    """Full SW (CIGAR traceback) over candidate lanes assembled on the
    device."""
    B = len(read_idx)
    if B == 0:
        return []
    if B > MAX_LANES_PER_CALL:
        out: list[SWResult] = []
        for s in range(0, B, MAX_LANES_PER_CALL):
            e = s + MAX_LANES_PER_CALL
            out.extend(sw_extend_gather(
                reads8_dev, read_idx[s:e], is_rev[s:e], read_lens[s:e],
                genome_dev, win_starts[s:e], win_lens[s:e], params, bucket))
        return out
    _check_windows(win_lens, bucket)
    max_steps = _traceback_steps_bound(
        int(np.max(read_lens)), int(np.max(win_lens)), params, bucket)
    ridx, rev, rl, st, wl = _lane_meta(reads8_dev.device, read_idx, is_rev,
                                       read_lens, win_starts, win_lens)
    read, win = _lane_inputs(reads8_dev, ridx, rev, rl, genome_dev, st,
                             bucket.max_win_len)
    packed, coords, best = sw_full(read, rl, win, wl, params, max_steps)
    return _results_from_packed(packed.cpu().numpy(), max_steps,
                                coords.cpu().numpy(), best.cpu().numpy(),
                                np.asarray(read_lens))


# ---------------------------------------------------------------------------
# fused pair path: score → pair selection → winner extension on the device
# ---------------------------------------------------------------------------

def _sw_pair_fused(reads8, j_read, j_rev, j_rlen, j_start, j_wlen,
                   flat_idx, genome, *, params: SWParams, bucket: SWBucket,
                   pair: PairPolicy, max_steps: int, nr: int):
    """Score-only SW over every candidate job → dense (reads, K) candidate
    grid → best/second per read → all-combo FR pair selection → winner
    full SW + traceback, all on the jobs' device.

    Selection semantics are the reference's (ties: higher score, then
    smaller window position, then candidate rank; combo ties keep the
    first (k1, k2) in row-major order).  Returns (packed, coords, best,
    winner_job, sub_of, best_single) tensors, one lane per read."""
    i32 = torch.int32
    dev = reads8.device
    K = pair.max_candidates
    B1 = nr // 2
    W = bucket.max_win_len
    J = j_read.shape[0]

    read, win = _lane_inputs(reads8, j_read, j_rev, j_rlen, genome, j_start,
                             W)
    score, _ = sw_score(read, j_rlen, win, j_wlen, params)
    jpos = j_start + torch.clamp(j_start, max=pair.window_pad)
    valid = score > 0

    def scatter(vals, fill):
        out = torch.full((nr * K,), fill, dtype=i32, device=dev)
        return out.scatter_(0, flat_idx, vals.to(i32)).reshape(nr, K)

    jobs = torch.arange(J, dtype=i32, device=dev)
    d_score = scatter(torch.where(valid, score, 0), 0)
    d_job = scatter(torch.where(valid, jobs, -1), -1)
    d_pos = scatter(jpos, 0)
    d_rev = scatter(j_rev, 0)
    d_rlen = scatter(j_rlen, 0)

    # best + second-best per read by (score desc, pos asc, rank asc)
    bs = torch.zeros(nr, dtype=i32, device=dev)
    bp = torch.zeros_like(bs)
    bjob = torch.full((nr,), -1, dtype=i32, device=dev)
    bk = torch.full((nr,), -1, dtype=i32, device=dev)
    for k in range(K):
        s, p_, j_ = d_score[:, k], d_pos[:, k], d_job[:, k]
        better = (j_ >= 0) & ((bjob < 0) | (s > bs) | ((s == bs) & (p_ < bp)))
        bs = torch.where(better, s, bs)
        bp = torch.where(better, p_, bp)
        bjob = torch.where(better, j_, bjob)
        bk = torch.where(better, k, bk)
    ss = torch.zeros_like(bs)
    sp = torch.zeros_like(bs)
    sv = torch.zeros(nr, dtype=torch.bool, device=dev)
    for k in range(K):
        s, p_, j_ = d_score[:, k], d_pos[:, k], d_job[:, k]
        better = ((j_ >= 0) & (bk != k)
                  & (~sv | (s > ss) | ((s == ss) & (p_ < sp))))
        ss = torch.where(better, s, ss)
        sp = torch.where(better, p_, sp)
        sv = sv | better
    sub_of = torch.where(sv, ss, 0)

    # all K x K combos per fragment: FR orientation within insert bounds
    s1, s2 = d_score[:B1], d_score[B1:]
    rev1, rev2 = d_rev[:B1], d_rev[B1:]
    pos1, pos2 = d_pos[:B1], d_pos[B1:]
    rl1, rl2 = d_rlen[:B1], d_rlen[B1:]
    jbest = torch.full((B1,), -1, dtype=i32, device=dev)
    w1 = torch.full((B1,), -1, dtype=i32, device=dev)
    w2 = torch.full((B1,), -1, dtype=i32, device=dev)
    for k1 in range(K):
        for k2 in range(K):
            a_fwd = rev1[:, k1] == 0
            span = torch.where(
                a_fwd, (pos2[:, k2] + rl2[:, k2]) - pos1[:, k1],
                (pos1[:, k1] + rl1[:, k1]) - pos2[:, k2])
            ok = ((rev1[:, k1] != rev2[:, k2])
                  & (span >= pair.min_insert) & (span <= pair.max_insert)
                  & (s1[:, k1] > 0) & (s2[:, k2] > 0))
            cand = torch.where(ok, s1[:, k1] + s2[:, k2], -1)
            better = cand > jbest
            jbest = torch.where(better, cand, jbest)
            w1 = torch.where(better, d_job[:B1, k1], w1)
            w2 = torch.where(better, d_job[B1:, k2], w2)
    solo = bs[:B1] + bs[B1:] - pair.unpaired_penalty
    use_pair = (jbest > 0) & (jbest >= solo)
    winner_job = torch.where(torch.cat([use_pair, use_pair]),
                             torch.cat([w1, w2]), bjob)

    # winner full SW + traceback (unmapped reads run as empty lanes)
    wj = torch.clamp(winner_job, min=0).long()
    bad = winner_job < 0
    rlen_w = torch.where(bad, 0, j_rlen[wj])
    wlen_w = torch.where(bad, 0, j_wlen[wj])
    read_w, win_w = _lane_inputs(reads8, j_read[wj], j_rev[wj], rlen_w,
                                 genome, j_start[wj], W)
    packed, coords, best = sw_full(read_w, rlen_w, win_w, wlen_w, params,
                                   max_steps)
    return packed, coords, best, winner_job, sub_of, bs


def sw_pair_dispatch(reads8_dev, j_read, j_rev, j_rlen, genome_dev,
                     j_start, j_wlen, slice_of, read_lens,
                     params: SWParams, bucket: SWBucket, pair: PairPolicy):
    """Enqueue the fused pair path for one batch and return a handle for
    :func:`sw_pair_collect`; the device works while the caller does host
    work for neighbouring batches (CUDA launches are asynchronous)."""
    NR = len(read_lens)
    J = len(j_read)
    K = pair.max_candidates
    _check_windows(j_wlen, bucket)
    j_read = np.asarray(j_read, np.int64)
    ranks = np.arange(J) - slice_of[j_read]
    flat = torch.from_numpy(j_read * K + ranks).to(reads8_dev.device)
    max_steps = _traceback_steps_bound(
        int(np.max(read_lens)), int(np.max(j_wlen)) if J else 0,
        params, bucket)
    jr, jv, jl, js, jw = _lane_meta(reads8_dev.device, j_read, j_rev,
                                    j_rlen, j_start, j_wlen)
    out = _sw_pair_fused(reads8_dev, jr, jv, jl, js, jw, flat, genome_dev,
                         params=params, bucket=bucket, pair=pair,
                         max_steps=max_steps, nr=NR)
    return out, max_steps, np.asarray(read_lens)


def sw_pair_collect(handle):
    """Sync half of the fused pair path → array-native results.

    Returns ``(ops, lens, nc, coords, best, winner_job, sub_of,
    best_score)``: per-read CIGAR arrays ((NR, max_ops) int32 x2 + (NR,)
    counts), the (4, NR) path coordinates (read_start, ref_start,
    read_end, ref_end), per-lane best scores, the winning job row
    (-1 = unmapped), the mapq sub-score, and the best single-end score
    (mate-rescue anchoring)."""
    out, max_steps, read_lens = handle
    packed_h, coords_h, best_h, winner_job, sub_of, best_score = (
        t.cpu().numpy() for t in out)
    return (*_cigar_arrays(packed_h, max_steps, coords_h, best_h, read_lens),
            coords_h, best_h, winner_job, sub_of, best_score)


# ---------------------------------------------------------------------------
# host-side decode of the packed op streams
# ---------------------------------------------------------------------------

def _results_from_packed(packed: np.ndarray, max_steps: int,
                         coords: np.ndarray, best: np.ndarray,
                         read_lens: np.ndarray) -> list[SWResult]:
    """Packed op streams + (4, B) coords → SWResults (native RLE when the
    fgio extension is built, python otherwise)."""
    i_f, j_f, bi, bj = coords
    nat = native_ext.ops_rle_batch(packed, max_steps, i_f, bi, best,
                                   np.asarray(read_lens, np.int32))
    if nat is not None:
        ops_a, lens_a, nc = nat
        results: list[SWResult] = []
        for b in range(len(read_lens)):
            n = int(nc[b])
            cigar = list(zip(ops_a[b, :n].tolist(), lens_a[b, :n].tolist()))
            if best[b] > 0:
                results.append(SWResult(
                    int(best[b]), int(i_f[b]), int(bi[b]), int(j_f[b]),
                    int(bj[b]), cigar))
            else:
                results.append(SWResult(0, 0, 0, 0, 0, cigar))
        return results
    ops = _unpack_ops(packed, max_steps)
    return _results_from_device_traceback(ops, i_f, j_f, bi, bj, best,
                                          read_lens)


def _cigar_arrays(packed: np.ndarray, max_steps: int, coords: np.ndarray,
                  best: np.ndarray, read_lens: np.ndarray, max_ops: int = 160
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packed op streams → per-lane CIGAR arrays ((B, max_ops) ops and
    lengths, (B,) counts), natively when the fgio extension is built."""
    read_lens = np.asarray(read_lens, np.int32)
    nat = native_ext.ops_rle_batch(packed, max_steps, coords[0], coords[2],
                                   best, read_lens)
    if nat is not None:
        return nat
    B = len(read_lens)
    ops_a = np.zeros((B, max_ops), np.int32)
    lens_a = np.zeros((B, max_ops), np.int32)
    nc = np.zeros(B, np.int32)
    for b, r in enumerate(_results_from_packed(packed, max_steps, coords,
                                               best, read_lens)):
        n = min(len(r.cigar), max_ops)
        nc[b] = n
        if n:
            ops_a[b, :n], lens_a[b, :n] = zip(*r.cigar[:n])
    return ops_a, lens_a, nc


def _unpack_ops(packed: np.ndarray, max_steps: int) -> np.ndarray:
    """(S/4, B) packed bytes → (max_steps, B) int8 ops in -1..2."""
    S4, B = packed.shape
    out = np.empty((S4 * 4, B), np.int8)
    for t in range(4):
        out[t::4] = ((packed >> (2 * t)) & 3).astype(np.int8) - 1
    return out[:max_steps]


def _results_from_device_traceback(ops: np.ndarray, i_f, j_f, bi, bj,
                                   best, read_lens) -> list[SWResult]:
    """Reverse + run-length-encode the per-lane op streams."""
    B = ops.shape[1]
    results: list[SWResult] = []
    for b in range(B):
        score = int(best[b])
        rl = int(read_lens[b])
        if score <= 0:
            results.append(SWResult(
                0, 0, 0, 0, 0, [(CIGAR_S, rl)] if rl else []))
            continue
        seq = ops[:, b]
        seq = seq[seq >= 0][::-1]
        cigar: Cigar = []
        if i_f[b] > 0:
            cigar.append((CIGAR_S, int(i_f[b])))
        if len(seq):
            breaks = np.nonzero(np.diff(seq))[0]
            starts = np.concatenate([[0], breaks + 1])
            ends = np.concatenate([breaks + 1, [len(seq)]])
            for s, e in zip(starts, ends):
                cigar.append((int(seq[s]), int(e - s)))
        if rl - int(bi[b]) > 0:
            cigar.append((CIGAR_S, rl - int(bi[b])))
        results.append(SWResult(score, int(i_f[b]), int(bi[b]),
                                int(j_f[b]), int(bj[b]), cigar))
    return results


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _traceback_steps_bound(rlen_max: int, wlen_max: int, params: SWParams,
                           bucket: SWBucket) -> int:
    """Provable bound on the traceback's step count.

    Path steps = #M + #I + #D with #M + #I <= rlen.  A positive-score
    local path has match*rlen - (go + ge*#gapbases) >= score > 0, so
    #D < (match*rlen - go) / ge.  Rounded to 128."""
    d_max = max(0, (rlen_max * params.match - params.gap_open
                    - params.gap_ext) // params.gap_ext)
    need = min(rlen_max + wlen_max, rlen_max + d_max) + 8
    return min(bucket.max_read_len + bucket.max_win_len,
               _round_up(need, 128))


# ---------------------------------------------------------------------------
# host-array entry (HaplotypeCaller hap → ref)
# ---------------------------------------------------------------------------

def sw_extend_batch(reads: np.ndarray, read_lens: np.ndarray,
                    windows: np.ndarray, win_lens: np.ndarray,
                    params: SWParams = SWParams(),
                    bucket: SWBucket = SWBucket()) -> list[SWResult]:
    """Align each read against its window; returns per-pair score, spans
    and CIGAR (soft clips included)."""
    return sw_extend_collect(sw_extend_dispatch(
        reads, read_lens, windows, win_lens, params, bucket))


def sw_extend_dispatch(reads: np.ndarray, read_lens: np.ndarray,
                       windows: np.ndarray, win_lens: np.ndarray,
                       params: SWParams = SWParams(),
                       bucket: SWBucket = SWBucket()):
    """Enqueue the device work and return a handle:
    ``sw_extend_collect(handle)`` copies back and walks the results."""
    if reads.shape[0] > MAX_LANES_PER_CALL:
        handles = []
        for s in range(0, reads.shape[0], MAX_LANES_PER_CALL):
            e = s + MAX_LANES_PER_CALL
            handles.append(sw_extend_dispatch(
                reads[s:e], read_lens[s:e], windows[s:e], win_lens[s:e],
                params, bucket))
        return ("multi", handles)
    return _sw_extend_dispatch_one(reads, read_lens, windows, win_lens,
                                   params, bucket)


def sw_extend_collect(handle) -> list[SWResult]:
    if handle[0] == "multi":
        out: list[SWResult] = []
        for h in handle[1]:
            out.extend(sw_extend_collect(h))
        return out
    return handle[1]()


def sw_extend_collect_arrays(handle):
    """Array form of :func:`sw_extend_collect`: (ops, lens, nc, coords,
    best), rows concatenated across sub-calls."""
    if handle[0] == "multi":
        parts = [sw_extend_collect_arrays(h) for h in handle[1]]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts], axis=1),
                np.concatenate([p[4] for p in parts]))
    return handle[2]()


def _sw_extend_dispatch_one(reads, read_lens, windows, win_lens, params,
                            bucket):
    Rin = reads.shape[1]
    Win = windows.shape[1]
    if Rin > bucket.max_read_len or Win > bucket.max_win_len:
        raise ValueError("input exceeds SW bucket shape")
    max_steps = bucket.max_read_len + bucket.max_win_len
    dev = bucket.device
    rl = np.asarray(read_lens, np.int32)
    read = device_reads(reads, dev)
    win = device_reads(windows, dev)
    rl_d, wl_d = _lane_meta(dev, rl, win_lens)
    return _handle(sw_full(read, rl_d, win, wl_d, params, max_steps),
                   max_steps, rl)


def _handle(out, max_steps: int, read_lens: np.ndarray):
    """The ``("one", collect, collect_arrays)`` handle over one enqueued
    :func:`sw_full`; only collecting copies the results to the host."""
    packed, coords, best = out

    def fetch():
        return packed.cpu().numpy(), coords.cpu().numpy(), best.cpu().numpy()

    def collect():
        p, c, b = fetch()
        return _results_from_packed(p, max_steps, c, b, read_lens)

    def collect_arrays():
        p, c, b = fetch()
        return (*_cigar_arrays(p, max_steps, c, b, read_lens), c, b)
    return ("one", collect, collect_arrays)


# ---------------------------------------------------------------------------
# window-gather entry (long-read chunks)
# ---------------------------------------------------------------------------

def sw_extend_win_dispatch(reads: np.ndarray, read_lens: np.ndarray,
                           genome_dev: torch.Tensor, win_starts: np.ndarray,
                           win_lens: np.ndarray,
                           params: SWParams = SWParams(),
                           bucket: SWBucket = SWBucket()):
    """Window-gather extension: the (B, <= R) reads ship to the device of
    the resident genome (the bucket's) and each lane's window,
    ``win_starts`` + [0, W), is gathered there (code 5 outside it).  K2 then K3 are
    enqueued and nothing waits for the device: the returned handle is
    read by :func:`sw_extend_collect` or :func:`sw_extend_collect_arrays`.
    Calls above ``MAX_LANES_PER_CALL`` lanes split into several."""
    B = reads.shape[0]
    if B > MAX_LANES_PER_CALL:
        return ("multi", [sw_extend_win_dispatch(
            reads[s:s + MAX_LANES_PER_CALL],
            read_lens[s:s + MAX_LANES_PER_CALL], genome_dev,
            win_starts[s:s + MAX_LANES_PER_CALL],
            win_lens[s:s + MAX_LANES_PER_CALL], params, bucket)
            for s in range(0, B, MAX_LANES_PER_CALL)])
    R, W = bucket.max_read_len, bucket.max_win_len
    if reads.shape[1] > R:
        raise ValueError("reads exceed the SW bucket's rows")
    _check_windows(win_lens, bucket)
    if genome_dev.device.type != torch.device(bucket.device).type:
        raise ValueError(f"the genome is on {genome_dev.device}, the "
                         f"bucket on {bucket.device}")
    rl = np.asarray(read_lens, np.int32)
    max_steps = _traceback_steps_bound(
        int(rl.max()) if B else 0,
        int(np.max(win_lens)) if B else 0, params, bucket)
    pad = np.full((B, R), 4, np.int8)
    pad[:, :reads.shape[1]] = reads
    reads8 = device_reads(pad, genome_dev.device)
    ridx, rev, rl_d, st, wl_d = _lane_meta(
        genome_dev.device, np.arange(B), np.zeros(B), rl, win_starts,
        win_lens)
    read, win = _lane_inputs(reads8, ridx, rev, rl_d, genome_dev, st, W)
    return _handle(sw_full(read, rl_d, win, wl_d, params, max_steps),
                   max_steps, rl)
