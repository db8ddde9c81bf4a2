"""Active-region detection: find windows with variant evidence.

GATK HaplotypeCaller's first phase (run inside the GATK jar in the
reference).  Evidence is a per-position activity score from the pileup:
mismatches, indel events, and soft clips vote; positions above threshold
are expanded/merged into padded regions that feed assembly.

Array-shaped by construction: the pileup counts are numpy scatter-adds
over the interval, the smoothing is a convolution — both trivially
device-mappable when regions are processed in bulk.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from falcon_genome_tpu.io.dna import encode_seq
from falcon_genome_tpu.io.sam import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S, SamRecord


@dataclasses.dataclass
class ActiveRegionParams:
    threshold: float = 0.02     # min activity fraction
    min_depth: int = 2
    pad: int = 50               # region padding each side
    max_region: int = 300       # split larger regions
    smooth: int = 9             # moving-average window


def pileup_activity(records: list[SamRecord], ref: np.ndarray,
                    start: int, end: int) -> tuple[np.ndarray, np.ndarray]:
    """(activity, depth) arrays over [start, end) for one contig."""
    n = end - start
    depth = np.zeros(n, np.int32)
    events = np.zeros(n, np.float32)
    for rec in records:
        if rec.is_unmapped or rec.is_duplicate or rec.flag & 0x900:
            continue
        seq = encode_seq(rec.seq) if rec.seq not in ("*", "") else None
        i, rpos = 0, rec.pos
        for op, ln in rec.cigar:
            if op == CIGAR_M:
                lo = max(rpos, start)
                hi = min(rpos + ln, end)
                if lo < hi:
                    depth[lo - start:hi - start] += 1
                    if seq is not None:
                        off = lo - rpos
                        seg = seq[i + off:i + off + (hi - lo)]
                        refseg = ref[lo:hi]
                        mism = (seg != refseg) & (seg != 4)
                        events[lo - start:hi - start] += mism
                i += ln
                rpos += ln
            elif op == CIGAR_I:
                if start <= rpos < end:
                    events[rpos - start] += 1.5
                i += ln
            elif op == CIGAR_D:
                lo = max(rpos, start)
                hi = min(rpos + ln, end)
                if lo < hi:
                    events[lo - start:hi - start] += 1.5
                rpos += ln
            elif op == CIGAR_S:
                if start <= rpos < end:
                    events[max(rpos - start, 0)] += 0.5
                i += ln
    return events, depth


def find_active_regions(records: list[SamRecord], ref: np.ndarray,
                        start: int, end: int,
                        params: ActiveRegionParams = ActiveRegionParams()
                        ) -> list[tuple[int, int]]:
    """Active windows [(rstart, rend), ...] within [start, end), padded and
    clipped to the contig."""
    events, depth = pileup_activity(records, ref, start, end)
    return regions_from_activity(events, depth, start, len(ref), params)


def regions_from_activity(events: np.ndarray, depth: np.ndarray,
                          start: int, ref_len: int,
                          params: ActiveRegionParams
                          ) -> list[tuple[int, int]]:
    """Threshold/smooth/merge/split of precomputed activity arrays (the
    back half of find_active_regions, shared with the columnar pileup)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        act = np.where(depth >= params.min_depth, events / np.maximum(depth, 1),
                       0.0)
    if params.smooth > 1:
        kern = np.ones(params.smooth) / params.smooth
        act = np.convolve(act, kern, mode="same")
    hot = act > params.threshold
    # hot-run boundaries, vectorized (a 60 Mb python scan is seconds)
    h = np.concatenate([[False], hot, [False]])
    starts_h = np.flatnonzero(h[1:] & ~h[:-1])
    ends_h = np.flatnonzero(~h[1:] & h[:-1])
    regions: list[tuple[int, int]] = [
        (max(0, start + int(i) - params.pad),
         min(ref_len, start + int(j) + params.pad))
        for i, j in zip(starts_h, ends_h)]
    # merge overlapping, then split oversized
    merged: list[tuple[int, int]] = []
    for lo, hi in regions:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
        else:
            merged.append((lo, hi))
    out: list[tuple[int, int]] = []
    for lo, hi in merged:
        while hi - lo > params.max_region:
            out.append((lo, lo + params.max_region))
            lo += params.max_region - 2 * params.pad
        out.append((lo, hi))
    return out
