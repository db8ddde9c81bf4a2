"""NumPy golden model: local affine-gap Smith-Waterman with traceback.

Copied from ``falcon_genome_tpu/ops/sw_ref.py``.  Scoring matches bwa-mem
defaults (match +1, mismatch -4, gap open 6, gap extend 1 — the engine the
reference drives as ``bwa-flow mem``, SURVEY.md §2 row 11).  Local
alignment + soft-clipping of uncovered read ends is exactly BWA-MEM's
extension behavior.  int64 throughout: the oracle the CUDA kernels'
scores and CIGARs are held against.

Coordinates: rows = read (i), cols = reference window (j).  A horizontal
move consumes a reference base (read deletion, CIGAR D); a vertical move
consumes a read base (insertion, CIGAR I).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..io.sam import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S, Cigar

NEG = -(1 << 28)


@dataclasses.dataclass(frozen=True)
class SWParams:
    match: int = 1
    mismatch: int = 4      # penalty (positive)
    gap_open: int = 6      # penalty for opening (first gap base costs open+ext)
    gap_ext: int = 1


@dataclasses.dataclass
class SWResult:
    score: int
    read_start: int   # 0-based inclusive, aligned read span [read_start, read_end)
    read_end: int
    ref_start: int    # 0-based inclusive window span [ref_start, ref_end)
    ref_end: int
    cigar: Cigar      # includes soft clips covering the full read


def sw_align_ref(read: np.ndarray, window: np.ndarray,
                 params: SWParams = SWParams()) -> SWResult:
    """Full-matrix local SW with affine gaps and traceback."""
    R, W = len(read), len(window)
    H = np.zeros((R + 1, W + 1), dtype=np.int64)
    E = np.full((R + 1, W + 1), NEG, dtype=np.int64)
    F = np.full((R + 1, W + 1), NEG, dtype=np.int64)
    # hdir: 0 stop, 1 diag, 2 from E (D op), 3 from F (I op)
    hdir = np.zeros((R + 1, W + 1), dtype=np.int8)
    eext = np.zeros((R + 1, W + 1), dtype=np.int8)
    fext = np.zeros((R + 1, W + 1), dtype=np.int8)

    go = params.gap_open + params.gap_ext
    ge = params.gap_ext

    best, bi, bj = 0, 0, 0
    for i in range(1, R + 1):
        for j in range(1, W + 1):
            e_open = H[i, j - 1] - go
            e_ext = E[i, j - 1] - ge
            E[i, j] = max(e_open, e_ext)
            eext[i, j] = 1 if e_ext > e_open else 0
            f_open = H[i - 1, j] - go
            f_ext = F[i - 1, j] - ge
            F[i, j] = max(f_open, f_ext)
            fext[i, j] = 1 if f_ext > f_open else 0
            sub = (params.match if read[i - 1] == window[j - 1]
                   else -params.mismatch)
            diag = H[i - 1, j - 1] + sub
            h = max(0, diag, E[i, j], F[i, j])
            H[i, j] = h
            if h == 0:
                hdir[i, j] = 0
            elif h == diag:
                hdir[i, j] = 1
            elif h == E[i, j]:
                hdir[i, j] = 2
            else:
                hdir[i, j] = 3
            if h > best:
                best, bi, bj = h, i, j

    if best == 0:
        return SWResult(0, 0, 0, 0, 0, [(CIGAR_S, R)] if R else [])

    # traceback
    ops: list[int] = []
    i, j = bi, bj
    while i > 0 and j > 0 and H[i, j] > 0:
        d = hdir[i, j]
        if d == 0:
            break
        if d == 1:
            ops.append(CIGAR_M)
            i -= 1
            j -= 1
        elif d == 2:
            while True:
                ops.append(CIGAR_D)
                ext = eext[i, j]
                j -= 1
                if not ext:
                    break
        else:
            while True:
                ops.append(CIGAR_I)
                ext = fext[i, j]
                i -= 1
                if not ext:
                    break
    ops.reverse()

    cigar: Cigar = []
    if i > 0:
        cigar.append((CIGAR_S, i))
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    if R - bi > 0:
        cigar.append((CIGAR_S, R - bi))
    return SWResult(int(best), i, bi, j, bj, cigar)
