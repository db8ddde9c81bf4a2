"""BWA-MEM-class read aligner: minimizer seeding → diagonal chaining →
batched Smith-Waterman extension on the device → pairing.

Port of ``falcon_genome_tpu/aligner.py``.  The host half (minimizer index,
candidate chaining, NM/mapq, SAM column emission) is the reference's code;
``AlignerEngine`` drives the port's Smith-Waterman ops
(``ops/smith_waterman.py``) on the ``torch.device`` it is given:

* **host (numpy + the fgio C++ extension)**: k-mer/minimizer index build
  and lookup, diagonal chaining, candidate jobs, CIGAR run-length
  encoding, SAM columns;
* **device**: score-only SW over every candidate, pair selection, full SW
  and traceback of the winners, and mate rescue.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .io import native_ext
from .io.columns import RecordColumns
from .io.dna import _COMP_LUT, BASE_N, revcomp_codes
from .io.sam import (
    CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S,
    FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
    FLAG_PROPER_PAIR, FLAG_READ1, FLAG_READ2, FLAG_REVERSE, FLAG_UNMAPPED,
    Cigar,
)

from .ops.smith_waterman import (
    PairPolicy, SWBucket, device_genome, device_reads, sw_extend_gather,
    sw_pair_collect, sw_pair_dispatch, sw_score_gather,
)
from .ops.sw_ref import SWParams, SWResult


# ---------------------------------------------------------------------------
# minimizer index
# ---------------------------------------------------------------------------

def _mix64(h: np.ndarray) -> np.ndarray:
    """Invertible 64-bit mix (splitmix-style) for k-mer hashing."""
    h = h.astype(np.uint64, copy=True)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return h


def _pack_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mers of a code sequence, 2-bit packed; mask marks N-free ones."""
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return (np.zeros(0, np.uint64), np.zeros(0, bool))
    c = codes.astype(np.uint64)
    val = np.zeros(n, dtype=np.uint64)
    ok = np.ones(n, dtype=bool)
    for i in range(k):
        ci = c[i:n + i]
        val = (val << np.uint64(2)) | (ci & np.uint64(3))
        ok &= codes[i:n + i] != BASE_N
    return val, ok


def _revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2-bit packed k-mers, vectorized."""
    x = ~kmers  # complement: A(00)<->T(11), C(01)<->G(10) == bitwise NOT
    # reverse 2-bit groups within 2k bits
    r = np.zeros_like(x)
    for i in range(k):
        r = (r << np.uint64(2)) | ((x >> np.uint64(2 * i)) & np.uint64(3))
    return r


def _canonical(kmers: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(canonical hash, is_reverse_strand) per k-mer."""
    rc = _revcomp_kmers(kmers, k)
    fwd_h = _mix64(kmers)
    rc_h = _mix64(rc)
    use_rc = rc_h < fwd_h
    return np.where(use_rc, rc_h, fwd_h), use_rc


def _minimizers(codes: np.ndarray, k: int, w: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hash, position, strand) of the w-window minimizers of a sequence.

    Uses the native fgio implementation when built (identical output —
    asserted by tests); the numpy path below is the reference."""
    nat = native_ext.minimizers(codes, k, w)
    if nat is not None:
        return nat
    return _minimizers_py(codes, k, w)


def _minimizers_py(codes: np.ndarray, k: int, w: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    kmers, ok = _pack_kmers(codes, k)
    n = len(kmers)
    if n == 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, bool))
    h, strand = _canonical(kmers, k)
    h = np.where(ok, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    if n <= w:
        idx = np.array([int(np.argmin(h))])
    else:
        win = np.lib.stride_tricks.sliding_window_view(h, w)
        idx = np.unique(win.argmin(axis=1) + np.arange(n - w + 1))
    keep = h[idx] != np.uint64(0xFFFFFFFFFFFFFFFF)
    idx = idx[keep]
    return h[idx], idx.astype(np.int64), strand[idx]


@dataclasses.dataclass
class IndexParams:
    k: int = 17
    w: int = 7
    max_hits: int = 64  # drop repetitive minimizers with more hits


class MinimizerIndex:
    """Sorted-array minimizer index over a multi-contig reference."""

    def __init__(self, contigs: list[tuple[str, np.ndarray]],
                 params: IndexParams = IndexParams()):
        self.params = params
        self.contig_names = [name for name, _ in contigs]
        self.contig_codes = [codes for _, codes in contigs]
        self.contig_lengths = [len(c) for c in self.contig_codes]
        # global coordinate space: contig i starts at offsets[i]
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.contig_lengths)]).astype(np.int64)
        self.genome = (np.concatenate(self.contig_codes)
                       if self.contig_codes else np.zeros(0, np.uint8))

        hashes, positions, strands = [], [], []
        for tid, codes in enumerate(self.contig_codes):
            h, pos, s = _minimizers(codes, params.k, params.w)
            hashes.append(h)
            positions.append(pos + self.offsets[tid])
            strands.append(s)
        h = np.concatenate(hashes) if hashes else np.zeros(0, np.uint64)
        pos = np.concatenate(positions) if positions else np.zeros(0, np.int64)
        s = np.concatenate(strands) if strands else np.zeros(0, bool)
        order = np.argsort(h, kind="stable")
        self.hashes = h[order]
        # positions fit uint32 for genomes < 4.3 Gbp (human incl.): 13 B
        # per entry total instead of 17 — the WGS index memory budget
        pos_sorted = pos[order]
        self.positions = (pos_sorted.astype(np.uint32)
                          if (len(pos_sorted) == 0
                              or int(self.offsets[-1]) < (1 << 32))
                          else pos_sorted)
        self.strands = s[order]

    @classmethod
    def from_fasta(cls, fasta, params: IndexParams = IndexParams()):
        contigs = [(c.name, fasta.contig_codes(c.name)) for c in fasta.dict]
        return cls(contigs, params)

    def tid_of(self, gpos: int) -> tuple[int, int]:
        """Global position → (tid, local position)."""
        tid = int(np.searchsorted(self.offsets, gpos, side="right")) - 1
        return tid, int(gpos - self.offsets[tid])

    def lookup_ranges(self, query_hashes: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) index ranges per query hash.

        Queries are sorted first: a binary search with sorted probes
        walks the index coherently instead of thrashing the cache —
        5.6× on WGS-scale batches (measured on the 60 Mb index)."""
        o = np.argsort(query_hashes, kind="stable")
        hs = query_hashes[o]
        lo_s = np.searchsorted(self.hashes, hs, side="left")
        hi_s = np.searchsorted(self.hashes, hs, side="right")
        lo = np.empty_like(lo_s)
        hi = np.empty_like(hi_s)
        lo[o] = lo_s
        hi[o] = hi_s
        return lo, hi

# ---------------------------------------------------------------------------
# seeding + chaining
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AlignerParams:
    index: IndexParams = dataclasses.field(default_factory=IndexParams)
    sw: SWParams = dataclasses.field(default_factory=SWParams)
    max_candidates: int = 4
    diag_band: int = 24       # chain tolerance in diagonal units
    window_pad: int = 32      # ref window slack each side for indels
    min_seeds: int = 1
    max_insert: int = 1000    # proper-pair insert bound
    min_insert: int = 0
    unpaired_penalty: int = 17  # score penalty when mates can't pair (bwa -U)
    min_rescue_score: int = 30  # accept a mate-rescue hit at/above this
    rescue_window: int = 1024   # SW window bucket for mate rescue


def candidate_arrays(codes: np.ndarray, lengths: np.ndarray,
                     index: MinimizerIndex, params: AlignerParams
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """Chained seed candidates of a whole read batch: ONE index lookup and
    ONE lexsort-based clustering pass over all reads' seed hits (or the
    fgio extension's fused seed-and-chain).  Returns parallel candidate
    arrays ``(read, is_rev, gdiag, nseeds, span)`` ordered by (read,
    rank): per read, the top ``max_candidates`` clusters by (-nseeds,
    -span, gdiag)."""
    k, w = index.params.k, index.params.w
    B = codes.shape[0]
    empty = (np.zeros(0, np.int32), np.zeros(0, bool),
             np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros(0, np.int64))

    # fused native pass: minimizers + galloping index merge + band
    # clustering + top-K in one threaded C++ call (fg_seed_and_chain)
    nat_sc = native_ext.seed_and_chain(
        codes, np.asarray(lengths, np.int32), k, w, index.hashes,
        index.positions, index.strands, index.params.max_hits,
        params.diag_band, params.min_seeds, params.max_candidates)
    if nat_sc is not None:
        s_diag, s_rev, s_nseeds, s_span, s_counts = nat_sc
        K = params.max_candidates
        mask = np.arange(K)[None, :] < s_counts[:, None]
        c_read = np.repeat(np.arange(B, dtype=np.int32),
                           s_counts.astype(np.int64))
        return (c_read, s_rev[mask].astype(bool), s_diag[mask],
                s_nseeds[mask].astype(np.int64), s_span[mask])

    # whole-batch minimizers: one native call threaded across reads
    # (40k per-read ctypes round-trips were ~0.7 s/batch)
    nat = native_ext.minimizers_batch(codes, lengths, k, w)
    if nat is not None:
        out_h, out_p, out_s, offs, counts = nat
        if int(counts.sum()) == 0:
            return empty
        idx = (np.repeat(offs[:-1], counts)
               + np.arange(int(counts.sum()))
               - np.repeat(np.cumsum(counts) - counts, counts))
        H = out_h[idx]
        RP = out_p[idx]
        RS = out_s[idx].astype(bool)
        RID = np.repeat(np.arange(B, dtype=np.int32), counts)
    else:
        # python fallback: per-read extraction, concatenated
        hs, rps, rss, rids = [], [], [], []
        for b in range(B):
            h, rp, rs = _minimizers(codes[b, :lengths[b]], k, w)
            if len(h):
                hs.append(h)
                rps.append(rp)
                rss.append(rs)
                rids.append(np.full(len(h), b, np.int32))
        if not hs:
            return empty
        H = np.concatenate(hs)
        RP = np.concatenate(rps)
        RS = np.concatenate(rss)
        RID = np.concatenate(rids)

    # one lookup over all query hashes (sorted-probe binary search)
    lo, hi = index.lookup_ranges(H)
    counts = hi - lo
    counts = np.where(counts > index.params.max_hits, 0, counts)
    total = int(counts.sum())
    if total == 0:
        return empty
    qidx = np.repeat(np.arange(len(H)), counts)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = np.repeat(lo, counts) + (np.arange(total) -
                                    np.repeat(offs, counts))
    gpos = index.positions[flat]
    gstrand = index.strands[flat]

    rid = RID[qidx]
    rp = RP[qidx]
    rev = gstrand != RS[qidx]
    Lb = lengths[rid].astype(np.int64)
    diag = np.where(rev, gpos - (Lb - k - rp), gpos - rp)

    # cluster: contiguous runs in (read, strand, diag) order within band
    order = np.lexsort((diag, rev, rid))
    d = diag[order]
    rv = rev[order]
    ri = rid[order]
    rp_s = rp[order]
    newgrp = np.empty(len(d), bool)
    newgrp[0] = True
    newgrp[1:] = ((ri[1:] != ri[:-1]) | (rv[1:] != rv[:-1])
                  | (d[1:] - d[:-1] > params.diag_band))
    starts_g = np.flatnonzero(newgrp)
    ends_g = np.concatenate([starts_g[1:], [len(d)]])
    lens_g = ends_g - starts_g

    # per-group stats (segments are contiguous → reduceat)
    mid_lo = starts_g + (lens_g - 1) // 2
    mid_hi = starts_g + lens_g // 2
    # int(np.median(...)) semantics: average of middle two, trunc toward 0
    med = np.trunc((d[mid_lo] + d[mid_hi]) / 2.0).astype(np.int64)
    rp_max = np.maximum.reduceat(rp_s, starts_g)
    rp_min = np.minimum.reduceat(rp_s, starts_g)
    span = (rp_max - rp_min).astype(np.int64) + k
    grp_read = ri[starts_g]
    grp_rev = rv[starts_g]

    keep = lens_g >= params.min_seeds
    if not keep.any():
        return empty
    med, span, lens_g = med[keep], span[keep], lens_g[keep]
    grp_read, grp_rev = grp_read[keep], grp_rev[keep]

    # per-read top max_candidates by (-nseeds, -span, gdiag); lexsort is
    # stable so full ties keep (strand, diag) creation order like the
    # per-read path
    order2 = np.lexsort((med, -span, -lens_g, grp_read))
    r_sorted = grp_read[order2]
    firsts = np.empty(len(order2), bool)
    firsts[0] = True
    firsts[1:] = r_sorted[1:] != r_sorted[:-1]
    grp_start = np.flatnonzero(firsts)
    rank = np.arange(len(order2)) - np.repeat(
        grp_start, np.diff(np.concatenate([grp_start, [len(order2)]])))
    sel = order2[rank < params.max_candidates]
    # order2 sorts primary by read, then by rank — sel keeps that order,
    # so the arrays come out grouped by read with per-read rank ascending
    return (grp_read[sel].astype(np.int32), grp_rev[sel], med[sel],
            lens_g[sel].astype(np.int64), span[sel])


# ---------------------------------------------------------------------------
# batch alignment engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Alignment:
    """Single-end alignment outcome (pre-SAM)."""
    mapped: bool
    tid: int = -1
    pos: int = -1            # 0-based contig-local leftmost
    is_rev: bool = False
    score: int = 0
    sub_score: int = 0       # best competing candidate score
    mapq: int = 0
    cigar: Cigar = dataclasses.field(default_factory=list)
    nm: int = 0
    read_len: int = 0


@dataclasses.dataclass
class AlignmentBatch:
    """Array-native alignment results for a batch of reads — the columnar
    twin of ``list[Alignment]`` (lane order = read order), consumed
    directly by the SAM column emission."""
    mapped: np.ndarray       # (N,) bool
    tid: np.ndarray          # (N,) int64
    pos: np.ndarray          # (N,) int64 contig-local leftmost
    is_rev: np.ndarray       # (N,) bool
    score: np.ndarray       # (N,) int64
    sub: np.ndarray          # (N,) int64
    mapq: np.ndarray         # (N,) int64
    nm: np.ndarray           # (N,) int64
    read_len: np.ndarray     # (N,) int64
    ops: np.ndarray          # (N, max_ops) int32 CIGAR ops (SAM numeric)
    lens: np.ndarray         # (N, max_ops) int32 CIGAR op lengths
    nc: np.ndarray           # (N,) int32 op counts (0 for unmapped)

    def __len__(self) -> int:
        return len(self.mapped)

    def set_lane(self, i: int, a: Alignment) -> None:
        """Patch one lane from an Alignment (mate-rescue path)."""
        self.mapped[i] = a.mapped
        self.tid[i] = a.tid
        self.pos[i] = a.pos
        self.is_rev[i] = a.is_rev
        self.score[i] = a.score
        self.sub[i] = a.sub_score
        self.mapq[i] = a.mapq
        self.nm[i] = a.nm
        n = min(len(a.cigar), self.ops.shape[1])
        self.nc[i] = n
        for t in range(n):
            self.ops[i, t], self.lens[i, t] = a.cigar[t]


def _edit_distance(read: np.ndarray, window: np.ndarray, res: SWResult) -> int:
    """NM tag: mismatches + gap bases along the aligned path.

    Two regimes: short CIGARs (Illumina reads, a handful of ops) walk a
    plain loop; long CIGARs (noisy long reads, hundreds of ops) run the
    vectorized gather — each is ~10× the other's cost in its regime."""
    nc = len(res.cigar)
    if nc == 0:
        return 0
    if nc <= 16:
        nm = 0
        i, j = 0, res.ref_start
        for op, n in res.cigar:
            if op == CIGAR_M:
                nm += int((read[i:i + n] != window[j:j + n]).sum())
                i += n
                j += n
            elif op == CIGAR_I:
                nm += n
                i += n
            elif op == CIGAR_D:
                nm += n
                j += n
            elif op == CIGAR_S:
                i += n
        return nm
    ops = np.fromiter((op for op, _ in res.cigar), np.int32, nc)
    lens = np.fromiter((n for _, n in res.cigar), np.int64, nc)
    di = np.where((ops == CIGAR_M) | (ops == CIGAR_I) | (ops == CIGAR_S),
                  lens, 0)
    dj = np.where((ops == CIGAR_M) | (ops == CIGAR_D), lens, 0)
    i0 = np.cumsum(di) - di                     # read offset per op
    j0 = res.ref_start + np.cumsum(dj) - dj     # window offset per op
    nm = int(lens[(ops == CIGAR_I) | (ops == CIGAR_D)].sum())
    m = ops == CIGAR_M
    if m.any():
        ml = lens[m]
        tot = int(ml.sum())
        off = np.arange(tot) - np.repeat(np.cumsum(ml) - ml, ml)
        ii = np.repeat(i0[m], ml) + off
        jj = np.repeat(j0[m], ml) + off
        nm += int((read[ii] != window[jj]).sum())
    return nm


def _nm_batch(codes: np.ndarray, lengths: np.ndarray, rev: np.ndarray,
              gstart: np.ndarray, ref_start: np.ndarray, genome: np.ndarray,
              ops: np.ndarray, lens: np.ndarray, nc: np.ndarray,
              sel: np.ndarray) -> np.ndarray:
    """Vectorized ``_edit_distance`` over the selected (mapped) lanes.

    One flattened pass over all lanes' CIGAR ops: per-op read/window
    offsets by prefix sums, M-run mismatches by a single oriented-read +
    genome gather.  Bit-identical to the per-read loop (tests assert)."""
    nm = np.zeros(len(codes), np.int64)
    if not len(sel):
        return nm
    nc_s = nc[sel].astype(np.int64)
    wmax = max(int(nc_s.max()), 1)      # typical CIGARs are ≤5 ops; the
    ops = ops[:, :wmax]                 # slot arrays are 160 wide
    lens = lens[:, :wmax]
    mask = np.arange(wmax)[None, :] < nc_s[:, None]
    ops_f = ops[sel][mask].astype(np.int64)
    lens_f = lens[sel][mask].astype(np.int64)
    n_ops = len(ops_f)
    if n_ops == 0:
        return nm
    rec = np.repeat(np.arange(len(sel)), nc_s)
    starts = np.cumsum(nc_s) - nc_s               # first-op index per rec
    di = np.where((ops_f == CIGAR_M) | (ops_f == CIGAR_I)
                  | (ops_f == CIGAR_S), lens_f, 0)
    dj = np.where((ops_f == CIGAR_M) | (ops_f == CIGAR_D), lens_f, 0)
    ci = np.cumsum(di) - di
    cj = np.cumsum(dj) - dj
    has = nc_s > 0
    i0 = ci - np.repeat(ci[starts[has]], nc_s[has])
    j0 = cj - np.repeat(cj[starts[has]], nc_s[has])
    nm_sel = np.bincount(
        rec, weights=np.where((ops_f == CIGAR_I) | (ops_f == CIGAR_D),
                              lens_f, 0), minlength=len(sel))
    m = ops_f == CIGAR_M
    if m.any():
        ml = lens_f[m]
        rec_m = rec[m]
        tot = int(ml.sum())
        off = np.arange(tot) - np.repeat(np.cumsum(ml) - ml, ml)
        base_rec = np.repeat(rec_m, ml)
        rows = sel[base_rec]
        ii = np.repeat(i0[m], ml) + off           # oriented read coord
        gj = np.repeat(gstart[sel][rec_m] + ref_start[sel][rec_m]
                       + j0[m], ml) + off
        Lr = lengths[rows]
        rrev = rev[rows]
        col = np.where(rrev, Lr - 1 - ii, ii)
        rb = codes[rows, col]
        rb = np.where(rrev, _COMP_LUT[rb], rb)
        mism = rb != genome[gj]
        nm_sel += np.bincount(base_rec, weights=mism, minlength=len(sel))
    nm[sel] = nm_sel.astype(np.int64)
    return nm


def _mapq_batch(score: np.ndarray, sub: np.ndarray, read_len: np.ndarray,
                match: int) -> np.ndarray:
    """Vectorized ``_mapq`` (identical rounding/damping semantics)."""
    best = np.maximum(read_len * match, 1).astype(np.float64)
    q = 6.02 * (score - sub)
    q = q * np.minimum(1.0, score / best)
    out = np.clip(np.round(q), 0, 60).astype(np.int64)
    return np.where((score <= 0) | (sub >= score), 0, out)


def _mapq(score: int, sub: int, read_len: int, match: int) -> int:
    """Deterministic BWA-flavor mapping quality from score separation."""
    if score <= 0:
        return 0
    best = read_len * match
    if sub >= score:
        return 0
    q = 6.02 * (score - sub)
    q *= min(1.0, score / best)  # identity damping
    return int(max(0, min(60, round(q))))


class AlignerEngine:
    """Aligns batches of reads against a MinimizerIndex on one device.

    The SW bucket (read rows x window columns) defaults to 160 x 256:
    aligner windows are read_len + 2 * window_pad <= 160 + 64."""

    def __init__(self, index: MinimizerIndex, params: AlignerParams = None,
                 device: torch.device = torch.device("cpu"),
                 bucket: SWBucket | None = None):
        self.index = index
        self.params = params or AlignerParams()
        self.bucket = bucket or SWBucket(max_win_len=256, device=device)
        self.device = self.bucket.device
        self._genome_dev = None

    @property
    def genome_dev(self) -> torch.Tensor:
        """Reference genome resident on the device (shipped once, reused
        by every batch's on-device window gather)."""
        if self._genome_dev is None:
            self._genome_dev = device_genome(self.index.genome, self.device)
        return self._genome_dev

    # --- shared device-batch plumbing ---------------------------------------

    def _build_jobs(self, codes: np.ndarray, lengths: np.ndarray):
        """Candidate jobs for every read: parallel arrays + per-read row
        slices (jobs of read b occupy rows slice_of[b]:slice_of[b+1]).

        Fully array-native: candidate_arrays comes back grouped by read,
        so the job fields are elementwise maps over it (the per-read
        python loop here was ~20% of the serial engine wall)."""
        p = self.params
        B = codes.shape[0]
        lengths = np.asarray(lengths)
        genome_len = len(self.index.genome)
        c_read, c_rev, c_diag, _, _ = candidate_arrays(
            codes, lengths, self.index, p)
        gstart = np.maximum(c_diag - p.window_pad, 0)
        wlen = np.minimum(lengths[c_read] + 2 * p.window_pad,
                          genome_len - gstart)
        keep = wlen > 0
        if not keep.all():
            c_read, c_rev = c_read[keep], c_rev[keep]
            gstart, wlen = gstart[keep], wlen[keep]
        slice_of = np.zeros(B + 1, np.int64)
        np.cumsum(np.bincount(c_read, minlength=B), out=slice_of[1:])
        return (c_read, c_rev, lengths[c_read].astype(np.int32),
                gstart.astype(np.int32), wlen.astype(np.int32), slice_of)

    def _ship_reads(self, codes: np.ndarray, lengths: np.ndarray):
        R = self.bucket.max_read_len
        B = codes.shape[0]
        reads_pad = np.full((B, R), 4, np.uint8)
        L = min(codes.shape[1], R)
        reads_pad[:, :L] = codes[:, :L]
        return device_reads(reads_pad, self.device)

    def _alignment_from(self, codes, lengths, b: int, is_rev: bool,
                        gstart: int, res: SWResult, sub: int) -> Alignment:
        p = self.params
        gpos = gstart + res.ref_start
        tid, pos = self.index.tid_of(gpos)
        rcodes = codes[b, :lengths[b]]
        qcodes = revcomp_codes(rcodes) if is_rev else rcodes
        window = self.index.genome[gstart:gstart + res.ref_end]
        nm = _edit_distance(qcodes, window, res)
        return Alignment(
            mapped=True, tid=tid, pos=pos, is_rev=is_rev,
            score=res.score, sub_score=sub,
            mapq=_mapq(res.score, sub, int(lengths[b]), p.sw.match),
            cigar=list(res.cigar), nm=nm, read_len=int(lengths[b]))

    @staticmethod
    def _winners_and_subs(j_read, j_start, scores, nreads: int):
        """Best positive-score job row per read + second-best score."""
        order = np.lexsort((j_start, -scores, j_read))
        reads_sorted = j_read[order]
        first = np.ones(len(order), bool)
        first[1:] = reads_sorted[1:] != reads_sorted[:-1]
        win_rows = order[first]
        win_rows = win_rows[scores[win_rows] > 0]
        sub_of = np.zeros(nreads, np.int64)
        second = np.zeros(len(order), bool)
        second[1:] = first[:-1] & ~first[1:]
        sub_of[reads_sorted[second]] = scores[order[second]]
        return win_rows, sub_of

    def align_batch(self, codes: np.ndarray, lengths: np.ndarray
                    ) -> list[Alignment]:
        """Align a padded batch (B, L); returns best alignment per read.

        Two device phases (the reads ship once as int8, the genome is
        already resident on the device):

        1. **score-only SW** over every chained candidate — no pointer
           emission, the kernel returns one int32 score per lane;
        2. **full SW + traceback** over only the winning candidate of each
           read (the second-best score is kept as the mapq sub-score).
        """
        p = self.params
        bucket = self.bucket
        B = codes.shape[0]
        j_read, j_rev, j_rlen, j_start, j_wlen, _ = self._build_jobs(
            codes, lengths)
        best: list[Alignment] = [
            Alignment(mapped=False, read_len=int(lengths[b]))
            for b in range(B)]
        if not len(j_read):
            return best

        reads8_dev = self._ship_reads(codes, lengths)
        scores, _ = sw_score_gather(
            reads8_dev, j_read, j_rev, j_rlen, self.genome_dev,
            j_start, j_wlen, p.sw, bucket)
        win_rows, sub_of = self._winners_and_subs(j_read, j_start, scores, B)
        if len(win_rows) == 0:
            return best

        results = sw_extend_gather(
            reads8_dev, j_read[win_rows], j_rev[win_rows], j_rlen[win_rows],
            self.genome_dev, j_start[win_rows], j_wlen[win_rows],
            p.sw, bucket)
        for row, res in zip(win_rows, results):
            if res.score <= 0:
                continue
            b = int(j_read[row])
            best[b] = self._alignment_from(
                codes, lengths, b, bool(j_rev[row]), int(j_start[row]), res,
                int(sub_of[b]))
        return best

    def align_pair_dispatch(self, codes1, lengths1, codes2, lengths2):
        """Pair-aware alignment of mate batches (bwa-mem semantics), first
        half: host seeding/chaining, then the score → pair-select → extend
        → traceback chain enqueued on the device (not synced).  The caller
        overlaps host work for neighboring batches with the device
        computing this one, then syncs via ``align_pair_collect``.

        The winning (cand1, cand2) combo maximizes score1 + score2 with FR
        orientation within the insert bounds; the best unpaired
        combination is charged ``unpaired_penalty`` (bwa -U)."""
        p = self.params
        B1 = codes1.shape[0]
        L = max(codes1.shape[1], codes2.shape[1])
        codes = np.full((2 * B1, L), 4, codes1.dtype)
        codes[:B1, :codes1.shape[1]] = codes1
        codes[B1:, :codes2.shape[1]] = codes2
        lengths = np.concatenate(
            [np.asarray(lengths1), np.asarray(lengths2)])
        j_read, j_rev, j_rlen, j_start, j_wlen, slice_of = self._build_jobs(
            codes, lengths)
        if not len(j_read):
            return (codes, lengths, B1, None, None, None)
        reads8_dev = self._ship_reads(codes, lengths)
        pair = PairPolicy(
            max_candidates=p.max_candidates, window_pad=p.window_pad,
            min_insert=p.min_insert, max_insert=p.max_insert,
            unpaired_penalty=p.unpaired_penalty)
        sw_handle = sw_pair_dispatch(
            reads8_dev, j_read, j_rev, j_rlen, self.genome_dev,
            j_start, j_wlen, slice_of, lengths, p.sw, self.bucket, pair)
        return (codes, lengths, B1, (j_rev, j_rlen, j_start), sw_handle,
                reads8_dev)

    def align_pair_collect(self, handle
                           ) -> tuple[AlignmentBatch, AlignmentBatch]:
        """Second half: device sync + array-native result assembly
        (vectorized NM/mapq/tid), then mate rescue — a fragment with one
        seeded mate SWs the other against the anchor's expected insert
        window on the opposite strand."""
        codes, lengths, B1, jarrs, sw_handle, reads8_dev = handle
        p = self.params
        NR = 2 * B1
        if sw_handle is None:
            z = np.zeros(NR, np.int64)
            return self._split_batch(AlignmentBatch(
                np.zeros(NR, bool), z - 1, z - 1, np.zeros(NR, bool),
                z.copy(), z.copy(), z.copy(), z.copy(),
                lengths.astype(np.int64), np.zeros((NR, 1), np.int32),
                np.zeros((NR, 1), np.int32), np.zeros(NR, np.int32)), B1)
        j_rev, j_rlen, j_start = jarrs
        (ops_a, lens_a, nc, coords, best_h, winner_job, sub_of,
         best_score) = sw_pair_collect(sw_handle)
        i_f, j_f, bi, bj = (c.astype(np.int64) for c in coords)
        mapped = best_h > 0
        wj = np.maximum(winner_job, 0)
        rev = j_rev[wj] & mapped
        gstart = j_start.astype(np.int64)[wj]
        gpos = gstart + j_f
        tid = np.searchsorted(self.index.offsets, gpos, side="right") - 1
        pos = gpos - self.index.offsets[tid]
        nc = np.where(mapped, nc, 0).astype(np.int32)
        score = np.where(mapped, best_h, 0).astype(np.int64)
        sub = np.where(mapped, sub_of, 0).astype(np.int64)
        ab = AlignmentBatch(
            mapped=mapped, tid=np.where(mapped, tid, -1),
            pos=np.where(mapped, pos, -1), is_rev=rev,
            score=score, sub=sub,
            mapq=_mapq_batch(score, sub, lengths.astype(np.int64),
                             p.sw.match),
            nm=_nm_batch(codes, lengths, rev, gstart, j_f,
                         self.index.genome, ops_a, lens_a, nc,
                         np.flatnonzero(mapped)),
            read_len=lengths.astype(np.int64),
            ops=ops_a, lens=lens_a, nc=nc)

        # mate rescue: fragments with exactly one seeded mate
        has1 = best_score[:B1] > 0
        has2 = best_score[B1:] > 0
        rescue: list[tuple[int, int]] = []
        for f in np.flatnonzero(has1 ^ has2):
            weak, strong = (B1 + f, f) if has1[f] else (f, B1 + f)
            rescue.append((int(weak), int(winner_job[strong])))
        if rescue:
            j_pos = (j_start.astype(np.int64)
                     + np.minimum(p.window_pad, j_start))
            self._mate_rescue_batch(rescue, ab, codes, lengths, reads8_dev,
                                    j_rev, j_rlen, j_pos, self.bucket)
        return self._split_batch(ab, B1)

    @staticmethod
    def _split_batch(ab: AlignmentBatch, B1: int
                     ) -> tuple[AlignmentBatch, AlignmentBatch]:
        def half(sl):
            return AlignmentBatch(*(getattr(ab, f.name)[sl]
                                    for f in dataclasses.fields(
                                        AlignmentBatch)))
        return half(slice(None, B1)), half(slice(B1, None))

    def _mate_rescue_batch(self, rescue, ab: AlignmentBatch, codes,
                           lengths, reads8_dev, j_rev, j_rlen, j_pos,
                           bucket) -> None:
        best = {b: Alignment(mapped=False, read_len=int(lengths[b]))
                for b, _ in rescue}
        self._mate_rescue(rescue, best, codes, lengths, reads8_dev,
                          j_rev, j_rlen, j_pos, bucket)
        for b, a in best.items():
            if a.mapped and not ab.mapped[b]:
                ab.set_lane(b, a)

    def _mate_rescue(self, rescue, best, codes, lengths, reads8_dev,
                     j_rev, j_rlen, j_pos, bucket) -> None:
        """SW the seedless mate against the anchor's insert window."""
        p = self.params
        G = len(self.index.genome)
        W2 = p.rescue_window
        span = min(p.max_insert, W2)
        bucket2 = SWBucket(max_read_len=bucket.max_read_len,
                           max_win_len=W2, device=bucket.device)
        rr_read, rr_rev, rr_rlen, rr_start, rr_wlen = [], [], [], [], []
        for b, anchor in rescue:
            Lb = int(lengths[b])
            arev = bool(j_rev[anchor])
            apos = int(j_pos[anchor])
            start = apos if not arev else apos + int(j_rlen[anchor]) - span
            start = max(0, min(start, G - 1))
            wlen = min(span, G - start)
            if wlen < Lb // 2:
                continue
            rr_read.append(b)
            rr_rev.append(not arev)
            rr_rlen.append(Lb)
            rr_start.append(start)
            rr_wlen.append(wlen)
        if not rr_read:
            return
        res2 = sw_extend_gather(
            reads8_dev, np.asarray(rr_read, np.int32),
            np.asarray(rr_rev, bool), np.asarray(rr_rlen, np.int32),
            self.genome_dev, np.asarray(rr_start, np.int32),
            np.asarray(rr_wlen, np.int32), p.sw, bucket2)
        for b, rv, st, res in zip(rr_read, rr_rev, rr_start, res2):
            if res.score >= p.min_rescue_score and not best[b].mapped:
                best[b] = self._alignment_from(
                    codes, lengths, b, rv, st, res, 0)


# ---------------------------------------------------------------------------
# columnar SAM emission
# ---------------------------------------------------------------------------
def _aln_scalars(alns: list[Alignment]) -> np.ndarray:
    """(n, 8) int64: mapped, tid, pos, is_rev, mapq, score, sub, nm."""
    n = len(alns)
    out = np.empty((n, 8), np.int64)
    for i, a in enumerate(alns):
        out[i, 0] = a.mapped
        out[i, 1] = a.tid
        out[i, 2] = a.pos
        out[i, 3] = a.is_rev
        out[i, 4] = a.mapq
        out[i, 5] = a.score
        out[i, 6] = a.sub_score
        out[i, 7] = a.nm
    return out


def _flatten_cigars(alns: list[Alignment], mapped: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, np.ndarray]:
    """(ops, lens, cig_off, ncigar, ref_len) over the record axis.

    One np.asarray per record instead of a per-op python append loop —
    long-read CIGARs run to thousands of ops per record and the append
    loop was the long-read emit bottleneck."""
    n = len(alns)
    cig_off = np.zeros(n, np.int64)
    ncigar = np.zeros(n, np.int32)
    arrs: list[np.ndarray] = []
    total = 0
    for i, a in enumerate(alns):
        cig_off[i] = total
        if mapped[i] and a.cigar:
            arr = np.asarray(a.cigar, np.int32)
            ncigar[i] = len(arr)
            total += len(arr)
            arrs.append(arr)
    cat = (np.concatenate(arrs) if arrs
           else np.zeros((0, 2), np.int32))
    ops = np.ascontiguousarray(cat[:, 0])
    lens = np.ascontiguousarray(cat[:, 1])
    if len(ops):
        contrib = np.where((ops == CIGAR_M) | (ops == CIGAR_D), lens, 0)
        csum = np.concatenate([[0], np.cumsum(contrib, dtype=np.int64)])
        ref_len = csum[cig_off + ncigar] - csum[cig_off]
    else:
        ref_len = np.zeros(n, np.int64)
    return ops, lens, cig_off, ncigar, ref_len


def _oriented_blob(codes: np.ndarray, quals: np.ndarray, lens: np.ndarray,
                   rev: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Flatten padded (N, L) codes/quals to per-record blobs, reverse-
    complementing rows flagged in ``rev`` (vectorized gather)."""
    lens64 = lens.astype(np.int64)
    off = np.zeros(len(lens64), np.int64)
    np.cumsum(lens64[:-1], out=off[1:])
    total = int(lens64.sum())
    k = np.arange(total) - np.repeat(off, lens64)
    row = np.repeat(np.arange(len(lens64)), lens64)
    rrep = np.repeat(rev, lens64)
    col = np.where(rrep, np.repeat(lens64, lens64) - 1 - k, k)
    seq = codes[row, col]
    seq = np.where(rrep, _COMP_LUT[seq], seq).astype(np.uint8)
    qual = quals[row, col].astype(np.uint8)
    return seq, qual, off


def _tag_blob(mapped: np.ndarray, nm: np.ndarray, score: np.ndarray,
              sub: np.ndarray, read_group: str | None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NM/AS/XS + RG tag bytes per record (int16 ';s' encoding)."""
    n = len(mapped)
    rg_part = (b"RGZ" + read_group.encode() + b"\x00") if read_group else b""
    if int(max(nm.max(initial=0), score.max(initial=0),
               sub.max(initial=0))) > 32767:
        raise ValueError("tag value exceeds int16 fast path")
    lm = 15 + len(rg_part)
    lu = len(rg_part)
    tag_len = np.where(mapped, lm, lu).astype(np.int64)
    tag_off = np.zeros(n, np.int64)
    np.cumsum(tag_len[:-1], out=tag_off[1:])
    blob = np.zeros(int(tag_len.sum()), np.uint8)
    midx = np.flatnonzero(mapped)
    if len(midx):
        tmpl = np.frombuffer(b"NMs\x00\x00ASs\x00\x00XSs\x00\x00" + rg_part,
                             np.uint8)
        mat = np.tile(tmpl, (len(midx), 1))
        for base, vals in ((3, nm[midx]), (8, score[midx]), (13, sub[midx])):
            v16 = vals.astype(np.int16).view(np.uint16)
            mat[:, base] = (v16 & 0xFF).astype(np.uint8)
            mat[:, base + 1] = (v16 >> 8).astype(np.uint8)
        dst = (np.repeat(tag_off[midx], lm)
               + np.tile(np.arange(lm), len(midx)))
        blob[dst] = mat.ravel()
    if lu:
        uidx = np.flatnonzero(~mapped)
        if len(uidx):
            dst = (np.repeat(tag_off[uidx], lu)
                   + np.tile(np.arange(lu), len(uidx)))
            blob[dst] = np.tile(np.frombuffer(rg_part, np.uint8),
                                len(uidx))
    return blob, tag_off, tag_len


def _interleave_batches(ab1: AlignmentBatch, ab2: AlignmentBatch
                        ) -> AlignmentBatch:
    """Record-major interleave of two mate AlignmentBatches."""
    def mix(a, b):
        if a.ndim == 2 and a.shape[1] != b.shape[1]:
            w = max(a.shape[1], b.shape[1])
            a2 = np.zeros((a.shape[0], w), a.dtype)
            a2[:, :a.shape[1]] = a
            b2 = np.zeros((b.shape[0], w), b.dtype)
            b2[:, :b.shape[1]] = b
            a, b = a2, b2
        out = np.empty((a.shape[0] + b.shape[0],) + a.shape[1:], a.dtype)
        out[0::2] = a
        out[1::2] = b
        return out
    return AlignmentBatch(*(mix(getattr(ab1, f.name), getattr(ab2, f.name))
                            for f in dataclasses.fields(AlignmentBatch)))


def _flatten_cigars_batch(ab: AlignmentBatch
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
    """(ops, lens, cig_off, ncigar, ref_len) from an AlignmentBatch —
    the array twin of ``_flatten_cigars`` (unmapped lanes have nc 0)."""
    nc = ab.nc.astype(np.int64)
    wmax = max(int(nc.max(initial=0)), 1)
    ops2 = ab.ops[:, :wmax]
    lens2 = ab.lens[:, :wmax]
    mask = np.arange(wmax)[None, :] < nc[:, None]
    ops = ops2[mask].astype(np.int32)
    lens = lens2[mask].astype(np.int32)
    cig_off = np.cumsum(nc) - nc
    contrib = np.where(mask & ((ops2 == CIGAR_M) | (ops2 == CIGAR_D)),
                       lens2.astype(np.int64), 0)
    ref_len = contrib.sum(axis=1)
    return ops, lens, cig_off, nc.astype(np.int32), ref_len


def alignments_to_columns(b1, res1, b2=None, res2=None,
                          params: AlignerParams | None = None,
                          read_group: str | None = None):
    """SAM records of a whole batch as RecordColumns (flags, proper-pair
    TLEN, mate fields, oriented SEQ/QUAL, NM/AS/XS/RG tags).

    Pairs interleave read-major (rec 2i = read1_i, 2i+1 = read2_i).  No
    per-read Python objects or strings are built.

    ``res1``/``res2`` are either ``list[Alignment]`` or (hot path)
    ``AlignmentBatch`` — the array form skips the per-record scalar and
    CIGAR flattening loops entirely.
    """
    params = params or AlignerParams()
    B = len(res1)
    paired = b2 is not None and res2 is not None
    batched = isinstance(res1, AlignmentBatch)

    if paired:
        N = 2 * B
        Lmax = max(b1.codes.shape[1], b2.codes.shape[1])
        codes = np.full((N, Lmax), 4, np.uint8)
        quals = np.zeros((N, Lmax), np.uint8)
        codes[0::2, :b1.codes.shape[1]] = b1.codes
        codes[1::2, :b2.codes.shape[1]] = b2.codes
        quals[0::2, :b1.quals.shape[1]] = b1.quals
        quals[1::2, :b2.quals.shape[1]] = b2.quals
        lens = np.empty(N, np.int64)
        lens[0::2] = b1.lengths
        lens[1::2] = b2.lengths
    else:
        N = B
        codes = b1.codes
        quals = b1.quals
        lens = np.asarray(b1.lengths, np.int64)

    if batched:
        ab = _interleave_batches(res1, res2) if paired else res1
        mapped = ab.mapped
        tid = np.where(mapped, ab.tid, -1)
        pos = np.where(mapped, ab.pos, -1)
        rev = ab.is_rev
        mapq = np.where(mapped, ab.mapq, 0)
        s = np.empty((N, 8), np.int64)
        s[:, 5] = ab.score
        s[:, 6] = ab.sub
        s[:, 7] = ab.nm
        ops, clens, cig_off, ncigar, ref_len = _flatten_cigars_batch(ab)
    else:
        if paired:
            alns: list[Alignment] = [None] * N
            alns[0::2] = res1
            alns[1::2] = res2
        else:
            alns = list(res1)
        s = _aln_scalars(alns)
        mapped = s[:, 0].astype(bool)
        tid = np.where(mapped, s[:, 1], -1)
        pos = np.where(mapped, s[:, 2], -1)
        rev = s[:, 3].astype(bool)
        mapq = np.where(mapped, s[:, 4], 0)
        ops, clens, cig_off, ncigar, ref_len = _flatten_cigars(alns, mapped)
    end_pos = np.where(ncigar > 0, pos + ref_len, pos + 1)

    if paired:
        m1, m2 = mapped[0::2], mapped[1::2]
        r1, r2 = rev[0::2], rev[1::2]
        p1, p2 = pos[0::2], pos[1::2]
        t1, t2 = tid[0::2], tid[1::2]
        rl1, rl2 = ref_len[0::2], ref_len[1::2]
        f1 = np.full(B, FLAG_PAIRED | FLAG_READ1, np.int64)
        f2 = np.full(B, FLAG_PAIRED | FLAG_READ2, np.int64)
        f1 |= np.where(~m1, FLAG_UNMAPPED, 0) | np.where(
            ~m2, FLAG_MATE_UNMAPPED, 0)
        f2 |= np.where(~m2, FLAG_UNMAPPED, 0) | np.where(
            ~m1, FLAG_MATE_UNMAPPED, 0)
        f1 |= np.where(r1, FLAG_REVERSE, 0) | np.where(
            r2, FLAG_MATE_REVERSE, 0)
        f2 |= np.where(r2, FLAG_REVERSE, 0) | np.where(
            r1, FLAG_MATE_REVERSE, 0)
        both = m1 & m2 & (t1 == t2) & (r1 != r2)
        a1_left = p1 <= p2
        left_pos = np.where(a1_left, p1, p2)
        end_right = np.where(a1_left, p2 + rl2, p1 + rl1)
        span = end_right - left_pos
        left_rev = np.where(a1_left, r1, r2)
        right_rev = np.where(a1_left, r2, r1)
        proper = (both & ~left_rev & right_rev
                  & (span >= params.min_insert)
                  & (span <= params.max_insert))
        f1 |= np.where(proper, FLAG_PROPER_PAIR, 0)
        f2 |= np.where(proper, FLAG_PROPER_PAIR, 0)
        tlen1 = np.where(proper, np.where(a1_left, span, -span), 0)
        flag = np.empty(N, np.int64)
        flag[0::2] = f1
        flag[1::2] = f2
        tlen = np.empty(N, np.int64)
        tlen[0::2] = tlen1
        tlen[1::2] = -tlen1
        mtid = np.empty(N, np.int64)
        mtid[0::2] = np.where(m2, t2, -1)
        mtid[1::2] = np.where(m1, t1, -1)
        mpos = np.empty(N, np.int64)
        mpos[0::2] = np.where(m2, p2, -1)
        mpos[1::2] = np.where(m1, p1, -1)
    else:
        flag = np.where(mapped, 0, FLAG_UNMAPPED) | np.where(
            mapped & rev, FLAG_REVERSE, 0)
        tlen = np.zeros(N, np.int64)
        mtid = np.full(N, -1, np.int64)
        mpos = np.full(N, -1, np.int64)

    seq, qual, seq_off = _oriented_blob(codes, quals, lens, mapped & rev)
    blob_t, tag_off, tag_len = _tag_blob(
        mapped, s[:, 7], s[:, 5], s[:, 6], read_group)

    # names: pairs share one span (offsets may alias)
    names_bytes = "".join(b1.names).encode()
    nlens = np.fromiter((len(x) for x in b1.names), np.int64, B)
    noff = np.zeros(B, np.int64)
    np.cumsum(nlens[:-1], out=noff[1:])
    if paired:
        name_off = np.repeat(noff, 2)
        name_len = np.repeat(nlens, 2)
    else:
        name_off, name_len = noff, nlens

    fixed = np.empty((N, 12), np.int32)
    fixed[:, 0] = tid
    fixed[:, 1] = pos
    fixed[:, 2] = mapq
    fixed[:, 3] = flag
    fixed[:, 4] = lens
    fixed[:, 5] = mtid
    fixed[:, 6] = mpos
    fixed[:, 7] = tlen
    fixed[:, 8] = ncigar
    fixed[:, 9] = name_len
    fixed[:, 10] = 0
    fixed[:, 11] = end_pos
    return RecordColumns(
        fixed=fixed, names=np.frombuffer(names_bytes, np.uint8),
        name_off=name_off, cigar_ops=ops, cigar_lens=clens,
        cig_off=cig_off, seq=seq, qual=qual, seq_off=seq_off,
        tags=blob_t, tag_off=tag_off, tag_len=tag_len,
        seq_mode="codes", qual_mode="raw")
