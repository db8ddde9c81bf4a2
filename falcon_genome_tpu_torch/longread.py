"""Long-read aligner (minimap2-class): minimizer anchors → gap-cost
chaining → checkpointed piecewise Smith-Waterman on the device.

Port of ``falcon_genome_tpu/longread.py``.  Replaces the reference's
shelled-out ``minimap-flow`` binary (src/workers/Minimap2Worker.cpp:51-106;
selected by the fast-germline pipeline, src/worker-germline.cpp:191):

* **anchors** reuse the short-read path's minimizer index
  (:class:`~falcon_genome_tpu_torch.aligner.MinimizerIndex`) at long-read
  parameters (k=19, w=10 — the minimap2 map-ont neighborhood);
* **chaining** is the minimap2 gap-cost DP (bounded lookback, score
  ``min(dq, dr, k) − gapcost``) on the host, natively when the fgio
  extension is built;
* **base-level alignment** runs on the device: the chain is cut into
  checkpointed chunks (anchor-pinned boundaries are exact k-mer
  correspondences), every chunk of every read in a sub-batch becomes one
  lane of a window-gather Smith-Waterman call (kernels K2 then K3,
  ``ops.smith_waterman.sw_extend_win_dispatch``), and chunk CIGARs
  concatenate exactly at the pinned boundaries.  Local-SW edge clipping
  at a pinned boundary is patched with M/I/D so coordinates stay exact;
* long reads have no proper-pair model — records emit single-end, like
  minimap2's map-ont preset.

A prebuilt serialized index (``<ref>.mmi.npz``, the ``.mmi`` analog) is
loaded by the align stage when present.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from .aligner import (
    Alignment, IndexParams, MinimizerIndex, _edit_distance, _minimizers)
from .device import DEFAULT_DEVICE
from .io import native_ext
from .io.dna import revcomp_codes
from .io.sam import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S, Cigar
from .ops.smith_waterman import (
    SWBucket, device_genome, sw_extend_collect_arrays, sw_extend_win_dispatch)
from .ops.sw_ref import SWParams, SWResult


@dataclasses.dataclass
class LongReadParams:
    index: IndexParams = dataclasses.field(
        default_factory=lambda: IndexParams(k=19, w=10, max_hits=256))
    sw: SWParams = dataclasses.field(default_factory=SWParams)
    max_gap: int = 5000        # max read/ref gap between chainable anchors
    lookback: int = 64         # chaining DP predecessors examined
    min_anchors: int = 3
    min_chain_score: int = 40
    chunk_read: int = 144      # piecewise-SW read-chunk budget (160 bucket)
    chunk_win: int = 240       # ref window budget per chunk (256 bucket)
    end_pad: int = 48          # ref slack at the free read ends


# ---------------------------------------------------------------------------
# chaining (minimap2 §2.1: gap-cost DP with bounded lookback)
# ---------------------------------------------------------------------------

def _chain_dp(qs: np.ndarray, rs: np.ndarray, k: int, L: int,
              max_gap: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Python twin of ``fg_chain_anchors``: vectorized over the lookback
    window, serial over anchors.  Returns (f, parent, best end)."""
    n = len(qs)
    f = np.full(n, float(k))
    parent = np.full(n, -1, np.int64)
    for i in range(1, n):
        j0 = max(0, i - L)
        dq = qs[i] - qs[j0:i]
        dr = rs[i] - rs[j0:i]
        gap = np.abs(dr - dq)
        ok = (dq > 0) & (dr > 0) & (dq <= max_gap) & (dr <= max_gap)
        if not ok.any():
            continue
        gain = np.minimum(np.minimum(dq, dr), k).astype(np.float64) \
            - 0.01 * k * gap - 0.5 * np.log2(gap + 1.0)
        cand = np.where(ok, f[j0:i] + gain, -np.inf)
        b = int(np.argmax(cand))
        if cand[b] > f[i]:
            f[i] = cand[b]
            parent[i] = j0 + b
    return f, parent, int(np.argmax(f))


def chain_anchors(q: np.ndarray, r: np.ndarray, k: int,
                  params: LongReadParams
                  ) -> tuple[np.ndarray, float, float]:
    """Best anchor chain for one read+strand.

    ``q``/``r``: read / global-ref positions of anchors (same strand,
    oriented-read coordinates).  Returns (indices of the best chain in
    ascending order, its score, the best non-overlapping other score —
    for mapq).  Scoring: each extension gains ``min(dq, dr, k)`` minus
    the minimap2 gap cost ``0.01·k·|dr−dq| + 0.5·log2(|dr−dq|+1)``.
    """
    n = len(q)
    if n == 0:
        return np.zeros(0, np.int64), 0.0, 0.0
    order = np.lexsort((q, r))
    qs, rs = q[order].astype(np.int64), r[order].astype(np.int64)
    L = min(params.lookback, n)
    nat = native_ext.chain_anchors(qs, rs, k, L, params.max_gap)
    f, parent, end = (nat if nat is not None
                      else _chain_dp(qs, rs, k, L, params.max_gap))
    chain = []
    i = end
    while i >= 0:
        chain.append(i)
        i = int(parent[i])
    chain.reverse()
    # second-best = best chain at a DIFFERENT locus: anchors near the
    # primary's ref span belong to the same placement (their f trails the
    # primary by construction) and must not drag mapq to zero
    ref_lo, ref_hi = int(rs[chain[0]]), int(rs[chain[-1]])
    span = max(int(qs[chain[-1]]) + k, 1)
    away = (rs < ref_lo - span) | (rs > ref_hi + span)
    other = float(f[away].max()) if away.any() else 0.0
    return order[np.asarray(chain, np.int64)], float(f[end]), other


# ---------------------------------------------------------------------------
# checkpointed piecewise alignment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Chunk:
    read_a: int       # oriented-read span [read_a, read_b)
    read_b: int
    ref_a: int        # absolute (global) ref span [ref_a, ref_b)
    ref_b: int
    free_left: bool   # free read end (keep soft clip, shifts pos)
    free_right: bool


def _checkpoints(cq: np.ndarray, cr: np.ndarray, k: int, L: int,
                 genome_len: int, params: LongReadParams
                 ) -> list[_Chunk]:
    """Cut a chain into SW chunks.

    Checkpoints are chain anchors (exact k-mer correspondences); a chunk
    spans checkpoint→checkpoint inclusive of the closing anchor's k-mer,
    so consecutive chunks abut at exact read↔ref correspondences.  Long
    inter-anchor gaps are chopped proportionally (boundaries approximate
    — the SW edge patch restores the pin).  Virtual checkpoints extend
    the chain to the read ends along the local diagonal.
    """
    first_q, first_r = int(cq[0]), int(cr[0])
    last_q, last_r = int(cq[-1]), int(cr[-1])
    # virtual start: project read base 0 on the first anchor's diagonal
    r0 = max(0, first_r - first_q)
    # closing anchor consumes its k-mer; then project the read tail
    rend = min(genome_len, last_r + k + (L - (last_q + k)))

    # strictly-increasing point list: the chain anchors already increase
    # strictly in both coordinates (_chain_read's keep filter), so skip
    # leading anchors not beyond the virtual start and test the virtual
    # end against the last kept point.  _assemble_rows soft-clips any
    # read tail left uncovered when the genome end clamps the projection.
    s = 0
    n = len(cq)
    while s < n and not (int(cq[s]) > 0 and int(cr[s]) > r0):
        s += 1
    lq, lr = (int(cq[-1]), int(cr[-1])) if s < n else (0, r0)
    tail = [L] if (L > lq and rend > lr) else []
    pts_q = np.concatenate([[0], cq[s:], tail]).astype(np.int64)
    pts_r = np.concatenate(
        [[r0], cr[s:], [rend] if tail else []]).astype(np.int64)
    if len(pts_q) < 2:
        return []

    chunks: list[_Chunk] = []
    budget_q = params.chunk_read
    budget_r = params.chunk_win
    npts = len(pts_q)
    # list + bisect: two tiny binary searches per chunk (np.searchsorted's
    # per-call overhead dominates at this size)
    pq = pts_q.tolist()
    pr_ = pts_r.tolist()
    i = 0
    while i < npts - 1:
        qa, ra = pq[i], pr_[i]
        # greedily absorb checkpoints while the chunk fits both budgets
        j = min(bisect.bisect_right(pq, qa + budget_q),
                bisect.bisect_right(pr_, ra + budget_r)) - 1
        j = max(j, i + 1)
        j = min(j, npts - 1)
        qb, rb = int(pts_q[j]), int(pts_r[j])
        dq, dr = qb - qa, rb - ra
        if dq > budget_q or dr > budget_r:
            # single long inter-checkpoint gap: proportional chop
            nsp = max(int(np.ceil(dq / budget_q)),
                      int(np.ceil(dr / budget_r)))
            for sp in range(nsp):
                sqa = qa + dq * sp // nsp
                sqb = qa + dq * (sp + 1) // nsp
                sra = ra + dr * sp // nsp
                srb = ra + dr * (sp + 1) // nsp
                chunks.append(_Chunk(sqa, sqb, sra, srb,
                                     free_left=(i == 0 and sp == 0),
                                     free_right=(j == npts - 1
                                                 and sp == nsp - 1)))
        else:
            chunks.append(_Chunk(qa, qb, ra, rb,
                                 free_left=(i == 0),
                                 free_right=(j == npts - 1)))
        i = j
    return [c for c in chunks if c.read_b > c.read_a and c.ref_b >= c.ref_a]


def _merge_cigar(out: Cigar, op: int, n: int) -> None:
    if n <= 0:
        return
    if out and out[-1][0] == op:
        out[-1] = (op, out[-1][1] + n)
    else:
        out.append((op, n))


def _assemble_rows(chunks: list[_Chunk], r0: int, arrs,
                   read_len: int) -> tuple[Cigar, int, int] | None:
    """Concatenate chunk alignments → (oriented CIGAR, abs ref begin,
    total score).  Pinned chunk edges that local SW clipped are patched
    with M (+ I/D remainder) so checkpoint correspondences stay exact.
    Consumes the RLE slot arrays of ``sw_extend_collect_arrays`` directly
    (rows r0..r0+len(chunks))."""
    ops_a, lens_a, nc, coords, best = arrs
    cigar: Cigar = []
    score = 0
    ref_begin = None
    lead_uncovered = chunks[0].read_a if chunks else 0
    for ci, c in enumerate(chunks):
        r = r0 + ci
        seg_q = c.read_b - c.read_a
        seg_r = c.ref_b - c.ref_a
        if best[r] <= 0:
            if ref_begin is None:
                # still unanchored: soft-clip and keep looking
                _merge_cigar(cigar, CIGAR_S, seg_q)
                continue
            # chunk failed to align: bridge it coordinate-exactly
            m = min(seg_q, seg_r)
            _merge_cigar(cigar, CIGAR_M, m)
            _merge_cigar(cigar, CIGAR_I, seg_q - m)
            _merge_cigar(cigar, CIGAR_D, seg_r - m)
            continue
        score += int(best[r])
        # leading edge
        lead_q = int(coords[0, r])
        lead_r = int(coords[1, r])
        if c.free_left and ref_begin is None:
            _merge_cigar(cigar, CIGAR_S, lead_q)
            ref_begin = c.ref_a + lead_r
        else:
            if ref_begin is None:
                ref_begin = c.ref_a + lead_r  # first scoring chunk pins
                _merge_cigar(cigar, CIGAR_S, lead_q)
            else:
                m = min(lead_q, lead_r)
                _merge_cigar(cigar, CIGAR_M, m)
                _merge_cigar(cigar, CIGAR_I, lead_q - m)
                _merge_cigar(cigar, CIGAR_D, lead_r - m)
        # aligned body (strip the soft clips the local SW emitted)
        ro = ops_a[r]
        rl_ = lens_a[r]
        for t in range(int(nc[r])):
            if ro[t] != CIGAR_S:
                _merge_cigar(cigar, int(ro[t]), int(rl_[t]))
        # trailing edge
        tail_q = seg_q - int(coords[2, r])
        tail_r = seg_r - int(coords[3, r])
        if c.free_right:
            _merge_cigar(cigar, CIGAR_S, tail_q)
        else:
            m = min(tail_q, tail_r)
            _merge_cigar(cigar, CIGAR_M, m)
            _merge_cigar(cigar, CIGAR_I, tail_q - m)
            _merge_cigar(cigar, CIGAR_D, tail_r - m)
    if ref_begin is None:
        return None
    if lead_uncovered:
        cigar.insert(0, (CIGAR_S, lead_uncovered))
    # coverage invariant: the CIGAR must consume exactly the read — a
    # genome-end clamp can leave a tail uncovered; soft-clip it
    consumed = sum(n for op, n in cigar
                   if op in (CIGAR_M, CIGAR_I, CIGAR_S))
    if consumed < read_len:
        _merge_cigar(cigar, CIGAR_S, read_len - consumed)
    elif consumed > read_len:
        return None   # malformed chunk plan: refuse rather than emit junk
    return cigar, ref_begin, score


def _long_mapq(best: float, second: float, n_anchors: int) -> int:
    """minimap2-flavor mapq from chain-score separation."""
    if best <= 0:
        return 0
    ratio = max(0.0, 1.0 - second / best)
    q = 40.0 * ratio * min(1.0, n_anchors / 10.0)
    return int(max(0, min(60, round(q))))


class LongReadAligner:
    """Aligns variable-length long reads against a MinimizerIndex; the
    chunk alignments run on ``device`` (the bucket's, when one is
    given)."""

    # reads per pipeline stage: the host chains sub-batch i + 1 while the
    # device aligns sub-batch i; production batches (tpu.batch.long_reads
    # = 512) get two overlapped stages
    SUB_BATCH = 256

    def __init__(self, index: MinimizerIndex,
                 params: LongReadParams | None = None,
                 bucket: SWBucket | None = None,
                 device: torch.device = DEFAULT_DEVICE):
        self.index = index
        self.params = params or LongReadParams()
        self.bucket = bucket or SWBucket(max_read_len=160, max_win_len=256,
                                         device=device)
        self._genome_dev: dict[str, torch.Tensor] = {}

    def _lookup_batch(self, reads: list[np.ndarray]):
        """ONE index lookup for a whole sub-batch's minimizers (a sorted
        probe walks the index coherently; per-read lookups walked it
        cache-cold).  Returns per-read (rp, rstrand, gpos, gstrand)."""
        k, w = self.index.params.k, self.index.params.w
        hs, rps, rss, nm = [], [], [], []
        for codes in reads:
            h, rp, rs = _minimizers(np.asarray(codes, np.uint8), k, w)
            hs.append(h)
            rps.append(rp)
            rss.append(rs)
            nm.append(len(h))
        if not hs:
            return []
        H = np.concatenate(hs)
        if len(H) == 0:
            return [(np.zeros(0, np.int64), np.zeros(0, bool),
                     np.zeros(0, np.int64), np.zeros(0, bool))] * len(reads)
        qidx, gpos, gstrand = self.index.lookup(H)
        RP = np.concatenate(rps)[qidx]
        RS = np.concatenate(rss)[qidx]
        # hits are in ascending minimizer order → grouped by read
        bounds = np.concatenate([[0], np.cumsum(nm)])
        splits = np.searchsorted(qidx, bounds)
        return [(RP[a:b], RS[a:b], gpos[a:b], gstrand[a:b])
                for a, b in zip(splits[:-1], splits[1:])]

    def _chain_read(self, codes: np.ndarray, hits=None):
        """Best chain over both strands → (is_rev, oriented codes,
        chain read/ref arrays, score, runner-up score) or None."""
        p = self.params
        k, w = self.index.params.k, self.index.params.w
        if hits is None:
            h, rpos, rstrand = _minimizers(codes, k, w)
            if len(h) == 0:
                return None
            qidx, gpos, gstrand = self.index.lookup(h)
            rp = rpos[qidx]
            rs_h = rstrand[qidx]
        else:
            rp, rs_h, gpos, gstrand = hits
        if len(rp) == 0:
            return None
        L = len(codes)
        rev = gstrand != rs_h
        # oriented-read anchor coordinates (see aligner.candidate_arrays)
        q_or = np.where(rev, L - k - rp, rp)
        best = None
        scores = []
        for is_rev in (False, True):
            sel = rev == is_rev
            if not sel.any():
                scores.append(0.0)
                continue
            chain_idx, sc, other = chain_anchors(
                q_or[sel], gpos[sel], k, p)
            scores.append(sc)
            if len(chain_idx) < p.min_anchors or sc < p.min_chain_score:
                continue
            if best is None or sc > best[3]:
                cq = q_or[sel][chain_idx]
                cr = gpos[sel][chain_idx]
                best = (is_rev, cq, cr, sc, other)
        if best is None:
            return None
        is_rev, cq, cr, sc, other = best
        # opposite strand's best chain competes too
        second = max(other, scores[0 if is_rev else 1])
        # enforce strictly increasing checkpoints in both coordinates
        keep = [0]
        for i in range(1, len(cq)):
            if cq[i] > cq[keep[-1]] and cr[i] > cr[keep[-1]]:
                keep.append(i)
        cq, cr = cq[keep], cr[keep]
        oriented = revcomp_codes(codes) if is_rev else codes
        return is_rev, oriented, cq, cr, sc, second

    def align_batch(self, reads: list[np.ndarray]) -> list[Alignment]:
        """Two-stage pipeline: while the device aligns sub-batch i's
        chunks (the dispatch only enqueues: CUDA launches are
        asynchronous), the host chains and checkpoints sub-batch i + 1,
        then assembles sub-batch i."""
        out: list[Alignment | None] = [None] * len(reads)
        pending = None
        for lo in range(0, len(reads), self.SUB_BATCH):
            sub = reads[lo:lo + self.SUB_BATCH]
            plan, chunks, oriented = self._prep(sub)
            handle = self._run_chunks(chunks, oriented, plan)
            if pending is not None:
                self._post(out, *pending)
            pending = (lo, sub, plan, chunks, oriented, handle)
        if pending is not None:
            self._post(out, *pending)
        return out  # type: ignore[return-value]

    def _prep(self, reads: list[np.ndarray]):
        """Host stage 1: chain + checkpoint every read of a sub-batch."""
        p = self.params
        k = self.index.params.k
        genome = self.index.genome
        plan = []                  # (is_rev, c0, c1, score, second, n)
        all_chunks: list[_Chunk] = []
        all_oriented: dict[int, np.ndarray] = {}
        batch_hits = self._lookup_batch(
            [np.asarray(c, np.uint8) for c in reads])
        for ri, codes in enumerate(reads):
            got = self._chain_read(np.asarray(codes, np.uint8),
                                   batch_hits[ri])
            if got is None:
                plan.append(None)
                continue
            is_rev, oriented, cq, cr, sc, second = got
            chunks = _checkpoints(cq, cr, k, len(codes), len(genome), p)
            if not chunks:
                plan.append(None)
                continue
            plan.append((is_rev, len(all_chunks),
                         len(all_chunks) + len(chunks), sc, second,
                         len(cq)))
            all_chunks.extend(chunks)
            all_oriented[ri] = oriented
        return plan, all_chunks, all_oriented

    def _post(self, out, lo, reads, plan, all_chunks, all_oriented,
              handle):
        """Host stage 2: collect device results, assemble alignments."""
        genome = self.index.genome
        arrs = (sw_extend_collect_arrays(handle) if handle is not None
                else None)
        for ri, codes in enumerate(reads):
            item = plan[ri]
            if item is None:
                out[lo + ri] = Alignment(mapped=False, read_len=len(codes))
                continue
            is_rev, c0, c1, sc, second, n_anchors = item
            asm = _assemble_rows(all_chunks[c0:c1], c0, arrs, len(codes))
            if asm is None:
                out[lo + ri] = Alignment(mapped=False, read_len=len(codes))
                continue
            cigar, ref_begin, score = asm
            tid, pos = self.index.tid_of(ref_begin)
            ref_len = sum(n for op, n in cigar
                          if op in (CIGAR_M, CIGAR_D))
            shim = SWResult(score, 0, len(codes), 0, ref_len, cigar)
            win = genome[ref_begin:ref_begin + ref_len]
            if len(win) < ref_len:  # genome-end clamp: pad, no match
                win = np.concatenate(
                    [win, np.full(ref_len - len(win), 4, np.uint8)])
            nm = _edit_distance(all_oriented[ri], win, shim)
            out[lo + ri] = Alignment(
                mapped=True, tid=tid, pos=pos, is_rev=is_rev,
                score=score, sub_score=int(second),
                mapq=_long_mapq(sc, second, n_anchors),
                cigar=cigar, nm=nm, read_len=len(codes))

    @property
    def genome_dev(self) -> torch.Tensor:
        """The reference genome resident on the bucket's device, shipped
        once: chunk windows are gathered there."""
        key = str(self.bucket.device)
        if key not in self._genome_dev:
            self._genome_dev[key] = device_genome(self.index.genome,
                                                  self.bucket.device)
        return self._genome_dev[key]

    def _run_chunks(self, chunks: list[_Chunk], oriented, plan):
        """Enqueue every chunk of a sub-batch as one lane of K2/K3 (windows
        padded at free read ends, gathered on the device); returns the
        handle ``_post`` collects, or None without chunks."""
        if not chunks:
            return None
        R, W = self.bucket.max_read_len, self.bucket.max_win_len
        p = self.params
        genome = self.index.genome
        n = len(chunks)
        creads = np.full((n, R), 4, np.uint8)
        starts = np.zeros(n, np.int32)
        rl = np.zeros(n, np.int32)
        wl = np.zeros(n, np.int32)
        # map chunk row → owning read (plan slices are contiguous)
        owner = np.zeros(n, np.int64)
        for ri, item in enumerate(plan):
            if item is not None:
                owner[item[1]:item[2]] = ri
        for ci, c in enumerate(chunks):
            ocodes = oriented[int(owner[ci])]
            ra, rb = c.ref_a, c.ref_b
            # free-end ref pad, clamped so the window still fits the
            # bucket (pinned boundaries must never be cut off)
            pad_room = max(0, W - (rb - ra))
            if c.free_left:
                ra = max(0, ra - min(p.end_pad, pad_room))
                pad_room = max(0, W - (rb - ra))
            if c.free_right:
                rb = min(len(genome), rb + min(p.end_pad, pad_room))
            # free-end pads shift the chunk-local origin: rebase the
            # chunk to the padded window
            chunks[ci] = _Chunk(c.read_a, c.read_b, ra, rb,
                                c.free_left, c.free_right)
            seg_q = min(c.read_b - c.read_a, R)
            seg_r = min(rb - ra, W)
            creads[ci, :seg_q] = ocodes[c.read_a:c.read_a + seg_q]
            starts[ci] = ra
            rl[ci] = seg_q
            wl[ci] = seg_r
        return sw_extend_win_dispatch(creads, rl, self.genome_dev, starts,
                                      wl, p.sw, self.bucket)
