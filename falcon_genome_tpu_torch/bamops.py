"""BAM record operations: coordinate sort, duplicate marking, merge.

Replaces the reference's SambambaWorker MARKDUP / MERGE / SORT actions
(SURVEY.md §2 row 19, src/workers/SambambaWorker.cpp:11-24) with in-repo
implementations: a record path over ``SamRecord`` lists (the golden model
of the columnar path) and the columnar path itself, whose duplicate keys
are flat numpy arrays (vectorized).  Duplicate criteria follow
Picard/sambamba: same library, same reference, same *unclipped* 5'
coordinate and strand — for pairs, of both mates; the representative kept
is the one with the highest base-quality sum (ties: first by query name,
deterministic).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from .io.sam import (
    CIGAR_D, CIGAR_EQ, CIGAR_H, CIGAR_M, CIGAR_N, CIGAR_S, CIGAR_X,
    FLAG_DUP, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
    SamRecord, cigar_ref_len,
)

_REF_CONSUME = (CIGAR_M, CIGAR_D, CIGAR_N, CIGAR_EQ, CIGAR_X)
_CLIP = (CIGAR_S, CIGAR_H)


# ---------------------------------------------------------------------------
# sort (ref: SambambaWorker SORT action)
# ---------------------------------------------------------------------------

def sort_key_arrays(records: list[SamRecord]) -> np.ndarray:
    """(n,) order for coordinate sort: (tid, pos), unmapped last."""
    n = len(records)
    tid = np.fromiter(((r.tid if not r.is_unmapped else (1 << 30))
                       for r in records), np.int64, n)
    pos = np.fromiter((r.pos for r in records), np.int64, n)
    return np.lexsort((pos, tid))


def sort_records(records: list[SamRecord]) -> list[SamRecord]:
    order = sort_key_arrays(records)
    return [records[i] for i in order]


# ---------------------------------------------------------------------------
# duplicate marking on records (ref: SambambaWorker MARKDUP)
# ---------------------------------------------------------------------------

def unclipped_start(rec: SamRecord) -> int:
    """5' unclipped coordinate for the strand the read maps to."""
    if rec.is_reverse:
        end = rec.pos + cigar_ref_len(rec.cigar)
        # only the contiguous trailing clip run counts
        tail = 0
        for op, n in reversed(rec.cigar):
            if op in _CLIP:
                tail += n
            else:
                break
        return end + tail - 1
    lead = 0
    for op, n in rec.cigar:
        if op in _CLIP:
            lead += n
        else:
            break
    return rec.pos - lead


def _qual_sum(rec: SamRecord, min_q: int = 15) -> int:
    if rec.qual in ("*", ""):
        return 0
    return sum(q - 33 for q in rec.qual.encode() if q - 33 >= min_q)


def mark_duplicates(records: list[SamRecord]) -> tuple[list[SamRecord], int]:
    """Set FLAG_DUP on duplicate records in place; returns (records, ndup).

    Pairs are keyed by both mates' (tid, unclipped 5', strand); unpaired
    reads by their own.  Secondary/supplementary/unmapped records are never
    representatives and are marked if their primary is.
    """
    by_name: dict[str, list[SamRecord]] = defaultdict(list)
    for r in records:
        if r.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
            continue
        by_name[r.qname].append(r)

    groups: dict[tuple, list[tuple[str, int]]] = defaultdict(list)
    for name, recs in by_name.items():
        mapped = [r for r in recs if not r.is_unmapped]
        if not mapped:
            continue
        ends = sorted(
            ((r.tid, unclipped_start(r), r.is_reverse) for r in mapped))
        key = (len(mapped) > 1, tuple(ends))
        score = sum(_qual_sum(r) for r in mapped)
        groups[key].append((name, score))

    dup_names: set[str] = set()
    for key, members in groups.items():
        if len(members) < 2:
            continue
        members.sort(key=lambda t: (-t[1], t[0]))
        for name, _ in members[1:]:
            dup_names.add(name)

    ndup = 0
    for r in records:
        if r.qname in dup_names:
            if not (r.flag & FLAG_DUP):
                ndup += 1
            r.flag |= FLAG_DUP
    return records, ndup


# ---------------------------------------------------------------------------
# columnar duplicate marking
# ---------------------------------------------------------------------------

def _unclipped_coords_columns(cols, sel: np.ndarray):
    """(n,) unclipped 5' coordinate for each selected record, strand-aware.

    Leading/trailing clip runs are at most two ops (H then S per SAM
    spec), so two vectorized lookups cover them exactly.
    """
    from .io.columns import F_ENDPOS, F_FLAG, F_NCIGAR, F_POS

    f = cols.fixed
    ncig = f[sel, F_NCIGAR].astype(np.int64)
    co = cols.cig_off[sel].astype(np.int64)
    ops, lens = cols.cigar_ops, cols.cigar_lens

    def clip_run(idx0, idx1, have0, have1):
        o0 = ops[np.where(have0, idx0, 0)]
        l0 = lens[np.where(have0, idx0, 0)].astype(np.int64)
        c0 = have0 & ((o0 == CIGAR_S) | (o0 == CIGAR_H))
        o1 = ops[np.where(have1, idx1, 0)]
        l1 = lens[np.where(have1, idx1, 0)].astype(np.int64)
        c1 = c0 & have1 & ((o1 == CIGAR_S) | (o1 == CIGAR_H))
        return np.where(c0, l0, 0) + np.where(c1, l1, 0)

    lead = clip_run(co, co + 1, ncig > 0, ncig > 1)
    trail = clip_run(co + ncig - 1, co + ncig - 2, ncig > 0, ncig > 1)
    rev = (f[sel, F_FLAG] & 0x10) != 0
    pos = f[sel, F_POS].astype(np.int64)
    end = f[sel, F_ENDPOS].astype(np.int64)
    return np.where(rev, end + trail - 1, pos - lead), rev


def _qual_sums_columns(cols) -> np.ndarray:
    """(N,) per-record base-quality sums (quals ≥ 15), qstar records 0.

    Chunked over records: a whole-blob int64 cumsum costs ~24 bytes per
    base (36 GB at a 10M-read WGS shard — the round-2 dress rehearsal's
    RSS spike); per-chunk intermediates bound the extra memory to ~tens
    of MB regardless of input size."""
    from .io.columns import F_LSEQ, F_QSTAR, qual_phred_blob
    q8 = qual_phred_blob(cols)                      # (total bases,) uint8
    soff = cols.seq_off.astype(np.int64)
    lseq = cols.fixed[:, F_LSEQ].astype(np.int64)
    n = len(cols)
    s = np.zeros(n, np.int64)
    CH = 1 << 20                                    # records per chunk
    for a in range(0, n, CH):
        b = min(a + CH, n)
        # min/max (not [a]/[b-1]) keeps this correct for permuted
        # offsets (post-take columns); packed file-order inputs still
        # get the tight contiguous span
        lo = int(soff[a:b].min(initial=0))
        hi = int((soff[a:b] + lseq[a:b]).max(initial=0))
        q = q8[lo:hi].astype(np.int32)
        w = np.where(q >= 15, q, 0)
        c = np.zeros(len(w) + 1, np.int64)
        np.cumsum(w, out=c[1:])
        s[a:b] = c[soff[a:b] + lseq[a:b] - lo] - c[soff[a:b] - lo]
    s[cols.fixed[:, F_QSTAR] != 0] = 0
    return s


@dataclasses.dataclass
class DupMetrics:
    """Picard DuplicationMetrics analog (MarkDuplicates METRICS_FILE;
    sambamba markdup reports the same counts — SambambaWorker.cpp)."""
    pairs_examined: int = 0
    unpaired_examined: int = 0
    pair_duplicates: int = 0
    unpaired_duplicates: int = 0
    optical_duplicates: int = 0
    estimated_library_size: int | None = None


def _optical_key(name: bytes) -> tuple[bytes, int, int, int] | None:
    """(prefix, tile, x, y) from an Illumina-style read name.

    Picard's default READ_NAME_REGEX semantics: the last three
    colon-separated fields of a 5- or 7-field name are tile, x, y."""
    parts = name.split(b":")
    if len(parts) < 5:
        return None
    try:
        tile, x, y = (int(parts[-3]), int(parts[-2]), int(parts[-1]))
    except ValueError:
        return None
    return b":".join(parts[:-3]), tile, x, y


def _estimate_library_size(pairs_examined: int, unique_pairs: int
                           ) -> int | None:
    """Solve unique = L·(1 − exp(−total/L)) for L (Picard's estimator)."""
    n, u = pairs_examined, unique_pairs
    if n <= 0 or u <= 0 or u >= n:
        return None
    import math
    lo, hi = 1.0, float(u) * 100.0

    def f(L):
        return L * (1.0 - math.exp(-n / L)) - u
    while f(hi) < 0:
        hi *= 10.0
        if hi > 1e18:
            return None
    for _ in range(80):
        mid = (lo + hi) / 2.0
        if f(mid) > 0:
            hi = mid
        else:
            lo = mid
    return int(round((lo + hi) / 2.0))


def name_key_columns(cols) -> tuple[np.ndarray, np.ndarray]:
    """(h, nk2) per-record name keys: 64-bit name hash + a 24-bit
    (length, first byte, last byte) confirmation key.  Shared by the
    scan phase and the streamed markdup's final marking pass (which
    re-derives keys per bucket instead of holding them all)."""
    from .io.columns import F_LNAME

    f = cols.fixed
    h = cols.name_hashes().astype(np.int64)
    lname = f[:, F_LNAME].astype(np.int64)
    no = cols.name_off.astype(np.int64)
    fb = cols.names[np.where(lname > 0, no, 0)].astype(np.int64)
    lb = cols.names[np.where(lname > 0, no + lname - 1, 0)].astype(np.int64)
    nk2 = (lname << np.int64(16)) | (fb << np.int64(8)) | lb
    return h, nk2


def dup_scan_columns(cols, rg_to_lib: dict[str, str] | None = None
                     ) -> dict[str, np.ndarray]:
    """Compact per-record duplicate-scan arrays for one record chunk.

    The streamed markdup's phase-1 product: everything the duplicate
    decision needs, ~33 bytes/record instead of whole columns (the
    bucket tree never has to be resident at once).  Keys match
    :func:`mark_duplicates_columns` exactly.
    """
    from .io.columns import F_FLAG

    f = cols.fixed
    n = len(cols)
    h, nk2 = name_key_columns(cols)

    primary = (f[:, F_FLAG] & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
    mapped = primary & ((f[:, F_FLAG] & 0x4) == 0)
    mp = np.flatnonzero(mapped)
    ekey = np.zeros(n, np.int64)
    if len(mp):
        ucoord, rev = _unclipped_coords_columns(cols, mp)
        tid = f[mp, 0].astype(np.int64)
        ek = (((tid + 1) << np.int64(35))
              + ((ucoord + (np.int64(1) << 31)) << np.int64(1))
              + rev.astype(np.int64))
        if rg_to_lib and len(set(rg_to_lib.values())) > 1:
            # library covariate in the top key bits (tid is bounded by
            # the header so (tid+1)<<35 stays below bit 56 for any real
            # genome); Picard/sambamba group duplicates per library
            from .io.columns import tag_string_values
            libs = sorted(set(rg_to_lib.values()))
            lib_index = {lib: i for i, lib in enumerate(libs)}
            vals = tag_string_values(cols, b"RG", idx=mp)
            lib_of = np.asarray(
                [lib_index.get(rg_to_lib.get(v or "", ""), 0)
                 for v in vals], np.int64)
            ek = ek + (lib_of << np.int64(56))
        ekey[mp] = ek
    return {"h": h, "nk2": nk2, "ekey": ekey, "mapped": mapped,
            "qsum": _qual_sums_columns(cols)}


def _name_group_aggregate(h: np.ndarray, nk2: np.ndarray, ekey: np.ndarray,
                          mapped: np.ndarray, qsum: np.ndarray,
                          gidx: np.ndarray | None = None):
    """Level A of the duplicate decision: group records by name key
    (h, nk2) and reduce to per-LIVE-group rows (live = has ≥1 mapped
    primary).

    Returns (group dict, gid, live) where the dict's arrays are indexed
    by live group and gid maps every input record to its (all-groups)
    id.  ``gidx`` supplies global record indices (the streamed caller's
    partition rows carry them); default is 0..n-1.

    The group dict fields: k0..k3 (the duplicate sort key: pair-ness /
    min end key / max end key / multi-fragment sum), score, first
    (smallest record index of the group — the name representative), cnt,
    and the (h, nk2) name key itself (the streamed caller uses it to
    mark members in a later pass).
    """
    n = len(h)
    if gidx is None:
        gidx = np.arange(n, dtype=np.int64)
    nk = np.stack([h, nk2], axis=1)
    _, gid = np.unique(nk, axis=0, return_inverse=True)
    gid = gid.reshape(-1)
    ngroups = int(gid.max()) + 1 if n else 0
    mp = np.flatnonzero(mapped)

    cnt = np.zeros(ngroups, np.int64)
    np.add.at(cnt, gid[mp], 1)
    kmin = np.full(ngroups, np.iinfo(np.int64).max, np.int64)
    kmax = np.full(ngroups, np.iinfo(np.int64).min, np.int64)
    ek = ekey[mp]
    np.minimum.at(kmin, gid[mp], ek)
    np.maximum.at(kmax, gid[mp], ek)
    ksum = np.zeros(ngroups, np.int64)
    np.add.at(ksum, gid[mp], ek)
    score = np.zeros(ngroups, np.int64)
    np.add.at(score, gid[mp], qsum[mp])
    first = np.full(ngroups, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, gid, gidx)

    live = np.flatnonzero(cnt > 0)
    is_pair = (cnt[live] > 1).astype(np.int64)
    k1, k2 = kmin[live], np.where(cnt[live] > 1, kmax[live], 0)
    # groups with >2 mapped primaries (malformed multi-fragment names)
    # key on (count, min, max, sum) — count>2 can't collide with a real
    # pair's (1, min, max, ·)
    k0 = np.where(cnt[live] > 2, cnt[live], is_pair)
    k3 = np.where(cnt[live] > 2, ksum[live], 0)
    g = {"k0": k0, "k1": k1, "k2": k2, "k3": k3,
         "score": score[live], "first": first[live], "cnt": cnt[live]}
    # name key per live group, taken from any member row (all share it)
    rep = np.full(ngroups, n, np.int64)
    np.minimum.at(rep, gid, np.arange(n))
    g["h"] = h[rep[live]]
    g["nk2"] = nk2[rep[live]]
    return g, gid, live


def _dup_decide(g: dict, names_for, optical_pixel_dist: int = 100,
                return_metrics: bool = False
                ) -> tuple[np.ndarray, DupMetrics]:
    """Level B of the duplicate decision, on per-live-group arrays →
    (dup mask over live groups, metrics).

    ``names_for(idx_array) -> {index: qname bytes}`` is called once with
    every record index whose name the decision needs (score-tie keeper
    choice + optical keys) — the streamed caller reads only the name
    sidecars those indices live in.

    Runs sharing the full duplicate key (k0..k3) are independent, so the
    streamed markdup may partition groups by any function of k1 and call
    this per partition: the verdicts and metrics are identical to one
    global call.
    """
    metrics = DupMetrics()
    nlive = len(g["k0"])
    dup_mask = np.zeros(nlive, bool)
    if nlive == 0:
        return dup_mask, metrics
    k0, k1, k2, k3 = g["k0"], g["k1"], g["k2"], g["k3"]
    score, first, cnt = g["score"], g["first"], g["cnt"]
    order = np.lexsort((-score, k3, k2, k1, k0))
    ok0, ok1, ok2, ok3 = k0[order], k1[order], k2[order], k3[order]
    new_grp = np.ones(len(order), bool)
    new_grp[1:] = ((ok0[1:] != ok0[:-1]) | (ok1[1:] != ok1[:-1])
                   | (ok2[1:] != ok2[:-1]) | (ok3[1:] != ok3[:-1]))

    run_start = np.flatnonzero(new_grp)
    run_end = np.append(run_start[1:], len(order))
    s_live = score[order]
    f_live = first[order]
    cnt_live = cnt[order]
    metrics.pairs_examined = int((cnt > 1).sum())
    metrics.unpaired_examined = int((cnt == 1).sum())

    # batch name fetch: one request covering every multi-member run
    needed: list[int] = []
    for a, b in zip(run_start, run_end):
        if b - a >= 2:
            needed.extend(int(f_live[j]) for j in range(a, b))
    names = names_for(np.asarray(sorted(set(needed)), np.int64)) \
        if needed else {}

    for a, b in zip(run_start, run_end):
        if b - a < 2:
            continue
        top = s_live[a]
        ties = [j for j in range(a, b) if s_live[j] == top]
        if len(ties) > 1:
            keeper = min(ties, key=lambda j: names[int(f_live[j])])
        else:
            keeper = a
        for j in range(a, b):
            if j != keeper:
                dup_mask[order[j]] = True
        if return_metrics:
            # ---- optical-duplicate detection within the duplicate set --
            # grid-hashed neighbor probe: cells of side pixel_dist, so a
            # member only compares against its own + 8 adjacent cells —
            # expected O(k) per set (the naive all-pairs scan was O(k²),
            # millions of compares on a pathological PCR stack)
            D = max(1, optical_pixel_dist)
            keys = [(j, _optical_key(names[int(f_live[j])]))
                    for j in range(a, b)]
            grid: dict[tuple, list[int]] = {}
            for i, (_, kd) in enumerate(keys):
                if kd is not None:
                    cell = (kd[0], kd[1], kd[2] // D, kd[3] // D)
                    grid.setdefault(cell, []).append(i)
            for i, (j, kd) in enumerate(keys):
                if j == keeper:
                    continue
                if cnt_live[a] > 1:
                    metrics.pair_duplicates += 1
                else:
                    metrics.unpaired_duplicates += 1
                if kd is None:
                    continue
                found = False
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        cell = (kd[0], kd[1],
                                kd[2] // D + dx, kd[3] // D + dy)
                        for o in grid.get(cell, ()):
                            ko = keys[o][1]
                            if (o != i
                                    and abs(ko[2] - kd[2])
                                    <= optical_pixel_dist
                                    and abs(ko[3] - kd[3])
                                    <= optical_pixel_dist):
                                found = True
                                break
                        if found:
                            break
                    if found:
                        break
                if found:
                    metrics.optical_duplicates += 1

    if return_metrics:
        # Picard: estimateLibrarySize(PAIRS_EXAMINED − OPTICAL_DUPS,
        #                             PAIRS_EXAMINED − PAIR_DUPLICATES)
        metrics.estimated_library_size = _estimate_library_size(
            metrics.pairs_examined - metrics.optical_duplicates,
            metrics.pairs_examined - metrics.pair_duplicates)
    return dup_mask, metrics


def _dup_core(h: np.ndarray, nk2: np.ndarray, ekey: np.ndarray,
              mapped: np.ndarray, qsum: np.ndarray, names_for,
              optical_pixel_dist: int = 100,
              return_metrics: bool = False
              ) -> tuple[np.ndarray, DupMetrics]:
    """The duplicate decision on compact arrays → (per-record dup mask,
    metrics): name-group aggregation (level A) + group decision (level
    B).  The streamed bucket-tree markdup runs the same two levels
    out-of-core (h-partitioned aggregation, k1-partitioned decision) —
    both paths share this exact code, so they decide identically.
    """
    n = len(h)
    metrics = DupMetrics()
    if n == 0:
        return np.zeros(0, bool), metrics
    g, gid, live = _name_group_aggregate(h, nk2, ekey, mapped, qsum)
    if len(live) == 0:
        return np.zeros(n, bool), metrics
    dup_live, metrics = _dup_decide(g, names_for, optical_pixel_dist,
                                    return_metrics)
    ngroups = int(gid.max()) + 1
    dup_mask_g = np.zeros(ngroups, bool)
    dup_mask_g[live[dup_live]] = True
    return dup_mask_g[gid], metrics


def mark_duplicates_columns(cols, optical_pixel_dist: int = 100,
                            return_metrics: bool = False,
                            rg_to_lib: dict[str, str] | None = None):
    """Vectorized MARKDUP on RecordColumns: sets FLAG_DUP in the flag
    column in place; returns (cols, n newly marked) — or, with
    ``return_metrics``, (cols, n newly marked, DupMetrics).

    Same criteria as :func:`mark_duplicates` (Picard keys: (library,
    tid, unclipped 5', strand) per mapped primary, pairs keyed by both
    ends; best base-quality sum kept, ties by lexicographic qname).
    ``rg_to_lib`` maps RG id → LB; Picard/sambamba group duplicates per
    library, so identical coordinates from different libraries are NOT
    duplicates of each other.  With no map (or one library) the key
    degenerates to the library-less form and the per-record RG walk is
    skipped entirely.

    Optical duplicates (Picard MarkDuplicates semantics): within each
    duplicate set, a duplicate whose read name parses to the same
    flowcell/lane prefix and tile as another member, with |Δx| and |Δy|
    both ≤ ``optical_pixel_dist``, is counted optical.  Optical dups are
    still FLAG_DUP-marked like any duplicate; the count feeds the
    duplication metrics and the library-size estimate.

    Implementation: the compact scan (:func:`dup_scan_columns`) + the
    shared decision core (``_dup_core``) — the same pair the streamed
    bucket-tree markdup uses, so both paths decide identically.
    """
    from .io.columns import F_FLAG, F_LNAME

    f = cols.fixed
    n = len(cols)
    if n == 0:
        return (cols, 0, DupMetrics()) if return_metrics else (cols, 0)
    scan = dup_scan_columns(cols, rg_to_lib)
    names_blob = cols.names.tobytes()
    no = cols.name_off.astype(np.int64)
    lname = f[:, F_LNAME].astype(np.int64)

    def names_for(idx: np.ndarray) -> dict[int, bytes]:
        return {int(i): names_blob[int(no[i]):int(no[i]) + int(lname[i])]
                for i in idx}

    hit, metrics = _dup_core(
        scan["h"], scan["nk2"], scan["ekey"], scan["mapped"],
        scan["qsum"], names_for, optical_pixel_dist, return_metrics)
    newly = hit & ((f[:, F_FLAG] & FLAG_DUP) == 0)
    f[:, F_FLAG] = np.where(hit, f[:, F_FLAG] | FLAG_DUP, f[:, F_FLAG])
    ndup = int(newly.sum())
    return (cols, ndup, metrics) if return_metrics else (cols, ndup)



# ---------------------------------------------------------------------------
# merge (ref: SambambaWorker MERGE / MergeBamWorker)
# ---------------------------------------------------------------------------

def merge_sorted(shards: list[list[SamRecord]]) -> list[SamRecord]:
    """K-way merge of coordinate-sorted shards (bucket merge)."""
    all_recs = [r for shard in shards for r in shard]
    return sort_records(all_recs)
