"""HaplotypeCaller: germline variant calling over active regions.

End-to-end equivalent of the per-contig ``HTCWorker`` GATK invocations the
reference schedules (SURVEY.md §2 row 13, src/workers/HTCWorker.cpp),
including the PairHMM the reference offloads to the Blaze NAM FPGA — here
an in-process kernel (ops/pairhmm.py).

Per interval shard:
  pileup → active regions → de Bruijn assembly → hap→ref Smith-Waterman
  and PairHMM read×hap likelihoods (device batches) → diploid genotyping →
  VCF records (or gVCF with reference blocks).

Port of ``falcon_genome_tpu/models/haplotypecaller.py``: the device calls
run on ``HTCParams.device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..io.dna import decode_seq, encode_seq
from ..io.sam import CIGAR_D, CIGAR_M, SamRecord, cigar_ref_len, indel_quals
from ..io.vcf import VcfRecord

from ..ops.pairhmm import PairHMMParams, pairhmm_logp, pairhmm_logp_pairs
from ..ops.smith_waterman import SWBucket, sw_extend_batch
from ..ops.sw_ref import SWParams
from .activeregion import ActiveRegionParams, find_active_regions
from .assembly import AssemblyParams, assemble_region
from .genotyper import (
    events_from_alignment, genotype_sites, site_to_vcf_record)


LIKELIHOOD_CAP = 6.0  # per-read dynamic-range cap in log10 (GATK's global
                      # read-mismapping floor): L(r|h) is floored at
                      # best_h L(r|h) - cap, which also absorbs f32
                      # underflow (-inf) for hopeless read×hap pairs
# the PairHMM's gap-open phred of a read without BI/BD tags (GATK 3's
# default insertion and deletion quality; HaplotypeCaller's constant)
GAP_OPEN_PHRED = 45


def _clip_bounds(rec: SamRecord, rstart: int, rend: int
                 ) -> tuple[int, int] | None:
    """The query span [lo, hi) of a read aligned inside [rstart, rend),
    None where no aligned base falls there."""
    from ..io.sam import (
        CIGAR_EQ, CIGAR_I as CI, CIGAR_S as CS, CIGAR_X)
    i, rpos = 0, rec.pos
    lo_q, hi_q = None, None
    for op, n in rec.cigar:
        consumes_q = op in (CIGAR_M, CI, CS, CIGAR_EQ, CIGAR_X)
        consumes_r = op in (CIGAR_M, CIGAR_D, CIGAR_EQ, CIGAR_X)
        if consumes_r:
            seg_lo, seg_hi = rpos, rpos + n
            ov_lo = max(seg_lo, rstart)
            ov_hi = min(seg_hi, rend)
            if ov_lo < ov_hi and consumes_q:
                q_from = i + (ov_lo - seg_lo)
                q_to = i + (ov_hi - seg_lo)
                lo_q = q_from if lo_q is None else lo_q
                hi_q = q_to
            rpos += n
        if consumes_q:
            i += n
    return None if lo_q is None else (lo_q, hi_q)


def clip_read_to_region(rec: SamRecord, rstart: int, rend: int
                        ) -> tuple[str, str]:
    """Trim a read's seq/qual to the part aligned inside [rstart, rend).

    GATK hard-clips reads to the padded active region before PairHMM;
    without this, the out-of-region tail mismatches every haplotype and
    destroys the likelihood's dynamic range.
    """
    bounds = _clip_bounds(rec, rstart, rend)
    if bounds is None:
        return "", ""
    qlo, qhi = bounds
    seq, qual = rec.seq, rec.qual
    return seq[qlo:qhi], (qual[qlo:qhi] if qual not in ("*", "") else qual)


def clip_read(rec: SamRecord, rstart: int, rend: int):
    """A read clipped to [rstart, rend) as the PairHMM takes it: (base
    codes, base phreds, BI phreds, BD phreds), the tags clipped with the
    bases and each None where the read lacks it.  A read without
    qualities takes phred 30 a base.  BI/BD are taken as written: the
    port floors no quality before the PairHMM."""
    lo, hi = _clip_bounds(rec, rstart, rend) or (0, 0)
    codes = (encode_seq(rec.seq[lo:hi]) if hi > lo
             else np.zeros(0, np.uint8))
    q = (np.frombuffer(rec.qual[lo:hi].encode(), np.uint8) - 33
         if rec.qual not in ("*", "") and hi > lo
         else np.full(len(codes), 30, np.uint8))
    return (codes, q, *(None if t is None else t[lo:hi]
                        for t in indel_quals(rec)))


def gap_open_row(out: np.ndarray, tag, n: int) -> None:
    """A read's gap-open phreds into ``out`` (its row of a plane, phred 0
    past the read): the tag's values, and :data:`GAP_OPEN_PHRED` over the
    first ``n`` rows where it has none (GATK 3's
    ``getBaseInsertionQualities`` for a read without the tag)."""
    out[:n] = GAP_OPEN_PHRED
    if tag is not None:
        out[:len(tag)] = tag


def _has_indel_quals(clipped) -> bool:
    return any(bi is not None or bd is not None
               for _, _, bi, bd in clipped)


def normalize_read_likelihoods(logp: np.ndarray,
                               cap: float = LIKELIHOOD_CAP) -> np.ndarray:
    """Floor each read's likelihoods at (best over haps) - cap.

    Reads with no finite likelihood at all become uniformly uninformative
    (-300 across haplotypes).
    """
    best = np.max(np.where(np.isfinite(logp), logp, -np.inf), axis=1)
    floor = np.where(np.isfinite(best), best - cap, -300.0)
    out = np.maximum(np.where(np.isfinite(logp), logp, -np.inf),
                     floor[:, None])
    return out


@dataclasses.dataclass
class HTCParams:
    active: ActiveRegionParams = dataclasses.field(
        default_factory=ActiveRegionParams)
    assembly: AssemblyParams = dataclasses.field(
        default_factory=AssemblyParams)
    max_reads_per_region: int = 256
    min_mapq: int = 10
    # GATK HaplotypeCaller's -stand_call_conf default (30.0 in GATK4 and
    # the 3.7-era tools the reference wraps); overridable per run via
    # --extra-options.  The round-3 value of 10 admitted low-confidence
    # error-pileup hets at WGS scale (677 extras at 60 Mb)
    min_call_qual: float = 30.0
    emit_gvcf: bool = False
    gcp: int = 10                    # gap-continuation penalty phred
    sample: str = "SAMPLE"
    device: torch.device = DEFAULT_DEVICE   # SW + PairHMM batches

# hap-to-ref alignment uses GATK-ish heavier gap penalties to canonicalize
# indels
HAP_SW = SWParams(match=2, mismatch=6, gap_open=12, gap_ext=1)


def _hap_to_ref_events(haps: list[np.ndarray], ref: np.ndarray,
                       device: torch.device):
    """Align each assembled hap to the region reference; extract events."""
    if len(haps) == 1:
        return [[]]
    n = len(haps) - 1
    maxh = max(len(h) for h in haps[1:])
    # 128-quantized like _hap_to_ref_events_multi (compile variants)
    R = ((max(maxh, len(ref), 128) + 127) // 128) * 128
    W = max(((len(ref) + 127) // 128) * 128, 128)
    reads = np.full((n, R), 4, np.uint8)
    rl = np.zeros(n, np.int32)
    for i, h in enumerate(haps[1:]):
        reads[i, :len(h)] = h
        rl[i] = len(h)
    wins = np.tile(ref, (n, 1)).astype(np.uint8)
    wl = np.full(n, len(ref), np.int32)
    bucket = SWBucket(max_read_len=R, max_win_len=W, device=device)
    results = sw_extend_batch(reads, rl, wins, wl, HAP_SW, bucket)
    events = [[]]  # haplotype 0 = reference
    for i, res in enumerate(results):
        events.append(events_from_alignment(reads[i, :rl[i]], ref, res)
                      if res.score > 0 else None)
    return events


def read_hap_likelihood_matrix(reads: list[SamRecord],
                               haps: list[np.ndarray],
                               rstart: int, rend: int, gcp: int = 10,
                               device: torch.device = DEFAULT_DEVICE
                               ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Clip reads to the region, batch PairHMM over read×hap pairs, floor.

    Reads that carry BQSR's BI/BD tags give the PairHMM per-base gap-open
    planes (kernel K5; :func:`gap_open_row` for the reads without them);
    with no tag in the region the gap opens are the constant
    :data:`GAP_OPEN_PHRED` (kernel K4).
    Returns ((n_reads, n_haps) log10 matrix, clipped read code arrays).
    """
    clipped = [clip_read(rec, rstart, rend) for rec in reads]

    n_r, n_h = len(reads), len(haps)
    maxrl = max(8, max((len(c) for c, *_ in clipped), default=8))
    maxhl = max(8, max(len(h) for h in haps))
    codes = np.full((n_r * n_h, maxrl), 4, np.uint8)
    quals = np.zeros((n_r * n_h, maxrl), np.uint8)
    rlens = np.zeros(n_r * n_h, np.int32)
    hcodes = np.full((n_r * n_h, maxhl), 4, np.uint8)
    hlens = np.zeros(n_r * n_h, np.int32)
    ins = dels = GAP_OPEN_PHRED
    if _has_indel_quals(clipped):
        ins = np.zeros((n_r * n_h, maxrl), np.uint8)
        dels = np.zeros((n_r * n_h, maxrl), np.uint8)
    for ri, (rc, q, bi, bd) in enumerate(clipped):
        for hi, h in enumerate(haps):
            b = ri * n_h + hi
            codes[b, :len(rc)] = rc
            quals[b, :len(q)] = q
            rlens[b] = max(len(rc), 1)
            hcodes[b, :len(h)] = h
            hlens[b] = len(h)
        if np.ndim(ins):    # the read's row, then its other pairs'
            for plane, tag in ((ins, bi), (dels, bd)):
                gap_open_row(plane[ri * n_h], tag, rlens[ri * n_h])
                plane[ri * n_h:(ri + 1) * n_h] = plane[ri * n_h]
    logp = np.asarray(pairhmm_logp(
        codes, quals, ins, dels, gcp, rlens, hcodes, hlens,
        params=_default_pairhmm_params(maxrl, maxhl, device)))
    mat = normalize_read_likelihoods(logp.reshape(n_r, n_h))
    return mat, [c for c, *_ in clipped]


def _hap_to_ref_events_multi(items: list[tuple[list[np.ndarray],
                                               np.ndarray]],
                             device: torch.device):
    """Batched hap→ref alignment across regions: one SW call for the whole
    interval.  Returns per-region hap_events lists (hap 0 = ref = [])."""

    jobs = []           # (region_idx, hap_idx, hap, ref)
    for ri, (haps, ref) in enumerate(items):
        for hi, h in enumerate(haps[1:], start=1):
            jobs.append((ri, hi, h, ref))
    if not jobs:
        return [[[]] for _ in items]

    maxh = max(len(h) for _, _, h, _ in jobs)
    maxw = max(len(r) for _, _, _, r in jobs)
    # 128-quantized bucket (the traceback walk bound is R + W)
    R = ((max(maxh, maxw, 128) + 127) // 128) * 128
    W = ((max(maxw, 128) + 127) // 128) * 128
    n = len(jobs)
    reads = np.full((n, maxh), 4, np.uint8)
    rl = np.zeros(n, np.int32)
    wins = np.full((n, maxw), 4, np.uint8)
    wl = np.zeros(n, np.int32)
    for b, (_, _, h, r) in enumerate(jobs):
        reads[b, :len(h)] = h
        rl[b] = len(h)
        wins[b, :len(r)] = r
        wl[b] = len(r)
    bucket = SWBucket(max_read_len=R, max_win_len=W, device=device)
    results = sw_extend_batch(reads, rl, wins, wl, HAP_SW, bucket)

    events_all = [[[]] + [None] * (len(haps) - 1) for haps, _ in items]
    for (ri, hi, h, r), res in zip(jobs, results):
        events_all[ri][hi] = (events_from_alignment(h, r, res)
                              if res.score > 0 else None)
    return events_all


def _likelihoods_multi(staged: list[dict], gcp: int,
                       device: torch.device) -> list[np.ndarray]:
    """Batched PairHMM across regions via the pair-indexed dispatch:
    unique reads/haps ship once per chunk and the (read ⊗ hap) cross
    products expand on device (ops/pairhmm.pairhmm_logp_pairs) —
    returns per-region floored matrices.  Each region's ``clipped`` holds
    its reads as :func:`clip_read` gives them; a chunk in which any read
    carries BI/BD passes (n_reads, maxrl) gap-open tables (kernel K5),
    any other the constant :data:`GAP_OPEN_PHRED` (kernel K4)."""
    maxrl, maxhl = 8, 8
    for s in staged:
        maxrl = max(maxrl, max((len(c) for c, *_ in s["clipped"]),
                               default=8))
        maxhl = max(maxhl, max(len(h) for h in s["haps"]))
    params = _default_pairhmm_params(maxrl, maxhl, device)

    MAX_PAIRS = 8192
    out: list[np.ndarray] = [None] * len(staged)
    ci = 0
    while ci < len(staged):
        # greedily group regions until the chunk reaches the lane cap
        cj = ci
        pairs = 0
        while cj < len(staged):
            p = len(staged[cj]["reads"]) * len(staged[cj]["haps"])
            if cj > ci and pairs + p > MAX_PAIRS:
                break
            pairs += p
            cj += 1
        chunk = staged[ci:cj]

        n_reads = sum(len(s["clipped"]) for s in chunk)
        n_haps = sum(len(s["haps"]) for s in chunk)
        rtab = np.full((n_reads, maxrl), 4, np.uint8)
        qtab = np.zeros((n_reads, maxrl), np.uint8)
        rlv = np.ones(n_reads, np.int32)
        htab = np.full((n_haps, maxhl), 4, np.uint8)
        hlv = np.ones(n_haps, np.int32)
        ins = dels = GAP_OPEN_PHRED
        if any(_has_indel_quals(s["clipped"]) for s in chunk):
            ins = np.zeros((n_reads, maxrl), np.uint8)
            dels = np.zeros((n_reads, maxrl), np.uint8)
        pr_parts, ph_parts, spans = [], [], []
        roff = hoff = poff = 0
        for s in chunk:
            n_r, n_h = len(s["clipped"]), len(s["haps"])
            for ri, (rc, q, bi, bd) in enumerate(s["clipped"]):
                rtab[roff + ri, :len(rc)] = rc
                qtab[roff + ri, :len(q)] = q
                rlv[roff + ri] = max(len(rc), 1)
                if np.ndim(ins):
                    gap_open_row(ins[roff + ri], bi, rlv[roff + ri])
                    gap_open_row(dels[roff + ri], bd, rlv[roff + ri])
            for hi, h in enumerate(s["haps"]):
                htab[hoff + hi, :len(h)] = h
                hlv[hoff + hi] = len(h)
            pr_parts.append(np.repeat(np.arange(roff, roff + n_r), n_h))
            ph_parts.append(np.tile(np.arange(hoff, hoff + n_h), n_r))
            spans.append((poff, n_r, n_h))
            roff += n_r
            hoff += n_h
            poff += n_r * n_h
        pr = np.concatenate(pr_parts)
        ph = np.concatenate(ph_parts)
        if len(pr) == 0:
            # zero-pair chunk (every region had 0 reads or 0 haplotypes):
            # nothing to score — emit empty matrices and move on
            for s, (off, n_r, n_h) in zip(chunk, spans):
                out[ci] = np.zeros((n_r, n_h), np.float32)
                ci += 1
            continue
        logp_parts = [
            pairhmm_logp_pairs(rtab, qtab, rlv, htab, hlv,
                               pr[s0:s0 + MAX_PAIRS],
                               ph[s0:s0 + MAX_PAIRS],
                               ins, dels, gcp, params=params)
            for s0 in range(0, len(pr), MAX_PAIRS)]
        logp = (np.concatenate(logp_parts) if len(logp_parts) > 1
                else logp_parts[0])
        for s, (off, n_r, n_h) in zip(chunk, spans):
            out[ci] = normalize_read_likelihoods(
                logp[off:off + n_r * n_h].reshape(n_r, n_h))
            ci += 1
    return out


class ReadSelector:
    """Region→read selection over a shard, indexed once.

    A per-region ``for r in records`` scan is O(regions × records) —
    ~585M attribute checks per WGS shard, the round-2 dress rehearsal's
    HTC wall.  One vectorized pass extracts (pos, end, usable) arrays;
    each region then binary-searches the sorted starts and touches only
    reads near the region."""

    def __init__(self, records: list[SamRecord], min_mapq: int):
        n = len(records)
        self.records = records
        self.pos = np.fromiter((r.pos for r in records), np.int64, n)
        self.endp = np.fromiter((r.end_pos for r in records), np.int64, n)
        self.ok = np.fromiter(
            ((not r.is_unmapped and not r.is_duplicate
              and not (r.flag & 0x900) and r.mapq >= min_mapq
              and r.seq not in ("*", "")) for r in records), bool, n)
        self.order = np.argsort(self.pos, kind="stable")
        self.pos_sorted = self.pos[self.order]
        self.max_span = int((self.endp - self.pos).max(initial=1))

    def __call__(self, rstart: int, rend: int, cap: int) -> list[SamRecord]:
        lo = int(np.searchsorted(self.pos_sorted, rstart - self.max_span))
        hi = int(np.searchsorted(self.pos_sorted, rend))
        cand = self.order[lo:hi]
        cand = cand[(self.endp[cand] > rstart) & (self.pos[cand] < rend)
                    & self.ok[cand]]
        cand.sort()                         # original record order
        return [self.records[i] for i in cand[:cap]]


class HaplotypeCaller:
    def __init__(self, params: HTCParams = None):
        self.params = params or HTCParams()

    def call_region(self, records: list[SamRecord], ref: np.ndarray,
                    contig: str, rstart: int, rend: int
                    ) -> list[VcfRecord]:
        """Genotype one active region [rstart, rend) on ``contig``."""
        p = self.params
        region_ref = ref[rstart:rend]

        reads = [r for r in records
                 if not r.is_unmapped and not r.is_duplicate
                 and not (r.flag & 0x900) and r.mapq >= p.min_mapq
                 and r.pos < rend and r.end_pos > rstart
                 and r.seq not in ("*", "")]
        reads = reads[:p.max_reads_per_region]
        if not reads:
            return []

        # assembly consumes region-clipped read sequences (GATK behavior)
        read_codes = [
            encode_seq(s) for s, _ in
            (clip_read_to_region(r, rstart, rend) for r in reads) if s]
        asm = assemble_region(region_ref, read_codes, p.assembly)
        haps = asm.haplotypes
        if len(haps) == 1:
            return []

        hap_events = _hap_to_ref_events(haps, region_ref, p.device)
        read_hap_logp, _ = read_hap_likelihood_matrix(
            reads, haps, rstart, rend, p.gcp, p.device)

        calls = genotype_sites(hap_events, read_hap_logp)
        out = []
        for c in calls:
            if c.qual < p.min_call_qual:
                continue
            if c.gt == (0, 0) and not p.emit_gvcf:
                continue
            out.append(site_to_vcf_record(c, contig, rstart))
        return out

    def _select_reads(self, records, rstart, rend):
        p = self.params
        reads = [r for r in records
                 if not r.is_unmapped and not r.is_duplicate
                 and not (r.flag & 0x900) and r.mapq >= p.min_mapq
                 and r.pos < rend and r.end_pos > rstart
                 and r.seq not in ("*", "")]
        return reads[:p.max_reads_per_region]

    def call_interval(self, records: list[SamRecord], ref: np.ndarray,
                      contig: str, start: int, end: int,
                      emit_start: int | None = None,
                      emit_end: int | None = None) -> list[VcfRecord]:
        """Full sharded-caller step: detect active regions then genotype.

        ``emit_start``/``emit_end`` restrict EMISSION to a sub-window of
        the analyzed [start, end) — the sharded caller analyzes each
        shard with boundary padding (activity smoothing and read
        evidence are position-symmetric only away from the bounds) and
        emits each site from exactly one shard, like GATK's interval
        padding.

        Device work is batched *across* regions: host assembly stages every
        region first, then ONE Smith-Waterman batch aligns all assembled
        haplotypes to their region references, then ONE PairHMM batch
        scores every (region, read, hap) pair — a kernel launch per
        interval, not per region.
        """
        p = self.params
        regions = find_active_regions(records, ref, start, end, p.active)

        select_reads = ReadSelector(records, p.min_mapq)

        # ---- phase 1 (host): read selection + assembly per region --------
        staged = []
        for rstart, rend in regions:
            reads = select_reads(rstart, rend, p.max_reads_per_region)
            if not reads:
                continue
            region_ref = ref[rstart:rend]
            clipped = [clip_read(rec, rstart, rend) for rec in reads]
            asm = assemble_region(region_ref,
                                  [c for c, *_ in clipped if len(c)],
                                  p.assembly)
            if len(asm.haplotypes) == 1:
                continue
            staged.append(dict(rstart=rstart, rend=rend, reads=reads,
                               clipped=clipped, region_ref=region_ref,
                               haps=asm.haplotypes))

        out: list[VcfRecord] = []
        if staged:
            # ---- phase 2: one SW batch for all hap→ref alignments --------
            hap_events_all = _hap_to_ref_events_multi(
                [(s["haps"], s["region_ref"]) for s in staged], p.device)
            # ---- phase 3: one PairHMM batch over all pairs ---------------
            logp_all = _likelihoods_multi(staged, p.gcp, p.device)
            # ---- phase 4 (host): genotyping per region -------------------
            for s, hap_events, logp in zip(staged, hap_events_all,
                                           logp_all):
                calls = genotype_sites(hap_events, logp)
                for c in calls:
                    if c.qual < p.min_call_qual:
                        continue
                    if c.gt == (0, 0) and not p.emit_gvcf:
                        continue
                    out.append(site_to_vcf_record(c, contig, s["rstart"]))
        out.sort(key=lambda r: r.pos)
        # drop duplicate sites from overlapping regions
        dedup: list[VcfRecord] = []
        seen = set()
        for r in out:
            key = (r.pos, r.ref, tuple(r.alts))
            if key not in seen:
                seen.add(key)
                dedup.append(r)
        e0 = start if emit_start is None else emit_start
        e1 = end if emit_end is None else emit_end
        if emit_start is not None or emit_end is not None:
            dedup = [r for r in dedup if e0 <= r.pos - 1 < e1]
        if p.emit_gvcf:
            dedup = _add_ref_blocks(dedup, records, ref, contig, e0, e1)
        return dedup


def _default_pairhmm_params(maxrl: int, maxhl: int,
                            device: torch.device) -> PairHMMParams:
    R = ((max(maxrl, 8) + 7) // 8) * 8
    H = ((max(maxhl, 8) + 127) // 128) * 128
    return PairHMMParams(max_read_len=R, max_hap_len=H, device=device)


def _add_ref_blocks(variants: list[VcfRecord], records: list[SamRecord],
                    ref: np.ndarray, contig: str, start: int, end: int
                    ) -> list[VcfRecord]:
    """gVCF mode: fill non-variant spans with <NON_REF> reference blocks.

    Block GQ is depth-derived (min depth in the block, capped at 99) and
    blocks are banded at GQ breakpoints {0, 20, 60} like GATK's standard
    bands.
    """
    depth = np.zeros(end - start, np.int32)
    for rec in records:
        if rec.is_unmapped or rec.is_duplicate or rec.flag & 0x900:
            continue
        lo = max(rec.pos, start)
        hi = min(rec.pos + cigar_ref_len(rec.cigar), end)
        if lo < hi:
            depth[lo - start:hi - start] += 1

    def band(gq: int) -> int:
        if gq >= 60:
            return 60
        if gq >= 20:
            return 20
        return 0

    var_pos = {v.pos - 1 for v in variants}  # 0-based
    out: list[VcfRecord] = []
    vi = 0
    pos = start
    while pos < end:
        if pos in var_pos:
            while vi < len(variants) and variants[vi].pos - 1 == pos:
                out.append(variants[vi])
                vi += 1
            pos += 1
            continue
        # start a ref block
        bstart = pos
        gq0 = band(min(99, int(depth[pos - start]) * 3))
        while (pos < end and pos not in var_pos and
               band(min(99, int(depth[pos - start]) * 3)) == gq0):
            pos += 1
        out.append(VcfRecord(
            contig=contig, pos=bstart + 1,
            ref=decode_seq(ref[bstart:bstart + 1]),
            alts=["<NON_REF>"], qual=None, filter=".",
            info={"END": pos},
            fmt=["GT", "DP", "GQ"],
            samples=[{"GT": "0/0",
                      "DP": int(depth[bstart - start]),
                      "GQ": min(99, int(depth[bstart - start]) * 3)}]))
    # any variants not at positions seen (shouldn't happen) are appended
    out.extend(variants[vi:])
    out.sort(key=lambda r: r.pos)
    return out
