"""Smith-Waterman parameter and result types.

Copied from ``falcon_genome_tpu/ops/sw_ref.py`` (whose package import
pulls in JAX): bwa-mem default scoring, and the per-alignment result with
soft clips covering the full read.
"""
from __future__ import annotations

import dataclasses

from falcon_genome_tpu.io.sam import Cigar

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
