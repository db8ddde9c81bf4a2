"""``markdup`` stage (and BAM-folder handling).

Mirrors src/worker-markdup.cpp:15-57 — a single markdup pass over a BAM
file or a bucket folder of ``part-%06d.bam`` shards (the reference's
SambambaWorker MARKDUP with its bucket-tree input, SambambaWorker.cpp).

The data plane is columnar end-to-end: BAM bytes → native scan →
RecordColumns → vectorized dup keys → native encode, with no per-record
Python objects (records materialize only for the irregular consumers —
HaplotypeCaller active regions — via ``records_for``).

Port of ``falcon_genome_tpu/stages/bamstages.py``: host code, with the
coordinate sort on the host lexsort (``parallel.coordinate_order``).
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..bamops import mark_duplicates_columns
from ..config import Config
from ..io.bam import (
    BamColumnsWriter, BamReader, read_bam_columns, read_bam_region_columns,
    write_bam_columns)
from ..io.columns import (
    F_ENDPOS, F_FLAG, F_LNAME, F_POS, F_TID, RecordColumns)
from ..io.sam import FLAG_DUP, FLAG_UNMAPPED
from ..utils.common import (
    check_input, check_output, get_input_list, rss_suffix)

from ..parallel import coordinate_order

log = logging.getLogger("falcon_genome_tpu")


def _columns_sorted(cols: RecordColumns) -> RecordColumns:
    order = coordinate_order(cols)
    if np.array_equal(order, np.arange(len(cols))):
        return cols            # already coordinate-sorted: no copy
    return cols.take(order)


def load_bam_input_columns(path: str) -> tuple[object, RecordColumns]:
    """BAM file or bucket folder → (header, coordinate-sorted columns)
    (ref BamInput, src/BamInput.cpp:27-59)."""
    p = Path(path)
    if p.is_dir():
        parts = get_input_list(p, r"part-\d+.*\.bam")
        header = None
        shards = []
        for part in parts:
            h, cols = read_bam_columns(part)
            header = header or h
            shards.append(cols)
        return header, _columns_sorted(RecordColumns.concat(shards))
    check_input(path)
    return read_bam_columns(path)


class BamInputSource:
    """Shard-aware columnar BAM input for scatter stages.

    Small inputs load whole as RecordColumns (one native decode shared by
    every shard task); inputs above the ``tpu.bam.stream_mb`` threshold
    with a ``.bai`` stream each shard's region straight from the indexed
    BGZF blocks — bounded memory at WGS scale, no whole-file
    materialization.

    A bucket-FOLDER input whose parts carry ``.list``/``.bed`` region
    sidecars (printreads writes them, stages/bqsr.py) is pruned per
    shard: only parts whose declared regions intersect the shard are
    decoded — the reference's per-bucket region merge
    (src/BamInput.cpp:73-149)."""

    def __init__(self, path: str, stream_threshold_bytes: int = 256 << 20):
        p = Path(path)
        self.path = p
        self.parts: list[str] | None = None
        self._cols: RecordColumns | None = None
        self.stream = False
        if p.is_dir():
            parts = get_input_list(p, r"part-\d+.*\.bam")
            regions = []
            for part in parts:
                have = None
                for ext in (".list", ".bed"):
                    side = Path(part).with_suffix(ext)
                    if side.exists():
                        from ..io.intervals import read_interval_list
                        have = read_interval_list(side)
                        break
                regions.append(have)
            total = sum(Path(x).stat().st_size for x in parts)
            if (parts and all(r is not None for r in regions)
                    and total > stream_threshold_bytes):
                # region-pruned streaming over the bucket tree
                self.parts = parts
                self.part_regions = regions
                with BamReader(parts[0]) as r:
                    self.header = r.header
                return
            self.header, self._cols = load_bam_input_columns(path)
            return
        self.stream = (p.is_file()
                       and Path(str(p) + ".bai").exists()
                       and p.stat().st_size > stream_threshold_bytes)
        if self.stream:
            with BamReader(p) as r:
                self.header = r.header
        else:
            self.header, self._cols = load_bam_input_columns(path)

    @classmethod
    def from_conf(cls, conf: Config, path: str) -> "BamInputSource":
        return cls(path, conf.get("tpu.bam.stream_mb") << 20)

    def columns_for(self, shard, by_start: bool = False) -> RecordColumns:
        """Columns of mapped records overlapping a shard's intervals.

        ``by_start=True`` selects by record START instead (a partition:
        every record lands in exactly one shard) — for partitioning
        stages like printreads where overlap selection would emit
        boundary-spanning reads twice."""
        if self.parts is not None:
            # bucket folder: decode only region-intersecting parts
            picked = []
            for part, regions in zip(self.parts, self.part_regions):
                hit = any(
                    iv.contig == pr.contig
                    and iv.start <= pr.end and pr.start <= iv.end
                    for iv in shard for pr in regions)
                if hit:
                    picked.append(read_bam_columns(part)[1])
            cols = (RecordColumns.concat(picked) if picked
                    else RecordColumns.from_records([]))
            return self._filter_shard(cols, shard, by_start)
        if self.stream:
            _, cols = read_bam_region_columns(
                self.path,
                [(iv.contig, iv.start - 1, iv.end) for iv in shard])
            if not by_start:
                return cols
            f = cols.fixed
            m = np.zeros(len(cols), bool)
            for iv in shard:
                t = self.header.tid(iv.contig)
                m |= ((f[:, F_TID] == t) & (f[:, F_POS] >= iv.start - 1)
                      & (f[:, F_POS] < iv.end))
            return cols.take(np.flatnonzero(m))
        return self._filter_shard(self._cols, shard, by_start)

    def _filter_shard(self, cols: RecordColumns, shard,
                      by_start: bool) -> RecordColumns:
        f = cols.fixed
        m = np.zeros(len(cols), bool)
        for iv in shard:
            t = self.header.tid(iv.contig)
            if by_start:
                m |= ((f[:, F_TID] == t) & (f[:, F_POS] >= iv.start - 1)
                      & (f[:, F_POS] < iv.end))
            else:
                m |= ((f[:, F_TID] == t) & (f[:, F_POS] < iv.end)
                      & (f[:, F_ENDPOS] > iv.start - 1))
        m &= (f[:, F_FLAG] & FLAG_UNMAPPED) == 0
        return cols.take(np.flatnonzero(m))

    def records_for(self, shard) -> list:
        """Records overlapping a shard (list of Intervals), mapped only."""
        return self.columns_for(shard).to_records()


def stream_merge_sorted_parts(output: str, header, parts: list[str],
                              next_keys: list[tuple[int, int] | None],
                              slack: int = 1000) -> str:
    """Merge per-shard BAM parts into one coordinate-sorted BAM with one
    part resident at a time.

    Each part is internally coordinate-sorted; records may stray up to
    ``slack`` bp across the declared part boundaries (indel realignment
    moves reads by at most the active-region pad).  ``next_keys[i]`` is
    the (tid, pos) lower bound of part i+1 (None for the last part):
    records at or beyond ``next_key - slack`` are carried into the next
    part's sort instead of being emitted, so boundary strays land in
    order.  Replaces whole-genome RecordColumns.concat merges
    (the round-3 O(genome) RAM spikes in printreads/indel).
    """

    writer = BamColumnsWriter(output, header)
    carry: RecordColumns | None = None
    try:
        for i, p in enumerate(parts):
            _, cols = read_bam_columns(p)
            if carry is not None and len(carry):
                cols = RecordColumns.concat([carry, cols])
                carry = None
            if len(cols) == 0:
                continue
            order = coordinate_order(cols)
            nk = next_keys[i] if i < len(next_keys) else None
            if nk is None:
                writer.write_columns(cols, order=order)
                continue
            f = cols.fixed
            key = ((f[:, F_TID].astype(np.int64) << 32)
                   | np.clip(f[:, F_POS], 0, None).astype(np.int64))
            thresh = (np.int64(nk[0]) << 32) | np.int64(max(nk[1] - slack,
                                                            0))
            ks = key[order]
            cut = int(np.searchsorted(ks, thresh))
            if cut:
                # take() (not a partial order=): encode expects a full
                # permutation when given one
                writer.write_columns(cols.take(order[:cut]))
            carry = cols.take(order[cut:]) if cut < len(order) else None
        if carry is not None and len(carry):
            writer.write_columns(carry, order=coordinate_order(carry))
    finally:
        writer.close()
    return output


_SCAN_DT = np.dtype([("h", "<i8"), ("nk2", "<i8"), ("ekey", "<i8"),
                     ("qsum", "<i8"), ("gidx", "<i8"), ("mapped", "u1")])
_GRP_DT = np.dtype([("k0", "<i8"), ("k1", "<i8"), ("k2", "<i8"),
                    ("k3", "<i8"), ("score", "<i8"), ("first", "<i8"),
                    ("cnt", "<i8"), ("h", "<i8"), ("nk2", "<i8")])


def _stream_markdup(parts: list[str], output: str,
                    rg_to_lib: dict[str, str], remove_dups: bool,
                    optical_pixel_dist: int = 100,
                    partition_bytes: int = 512 << 20,
                    spill_dir: str | None = None):
    """Bounded-memory MARKDUP over a ``part-%06d`` bucket tree.

    Truly out-of-core (the reference's streaming sambamba markdup with
    its bounded fd/overflow budget, SambambaWorker.cpp:59-72,
    config.cpp:311-313): nothing O(total records) is ever resident —
    peak memory is max(one bucket, one spill partition, the duplicate
    key set), regardless of input size.  Five passes:

    1. **scan** — each bucket decodes once; its compact duplicate-scan
       rows (41 B/record) spill to ``P1`` partition files keyed by name
       hash (all records of a name group share ``h``, so a group never
       spans partitions), and its name blob+offsets are written to a
       sidecar (so later name fetches never re-decode a bucket);
    2. **aggregate** — each h-partition loads alone and reduces to
       per-name-group rows (``bamops._name_group_aggregate``), which
       spill to ``P2`` partition files keyed by ``hash(k1)`` (a
       duplicate run shares its full k-key, hence its k1, so runs never
       span partitions);
    3. **decide** — each k1-partition loads alone and runs the shared
       decision core (``bamops._dup_decide``) with sidecar-backed name
       fetches; verdicts are collected as the (h, nk2) name keys of
       duplicate groups — the only global product, sized by the
       duplicate *rate*, not the input;
    4. **mark+rewrite** — buckets stream in genome order through the
       BamColumnsWriter; each re-derives its records' name keys and
       FLAG_DUPs members of the duplicate key set.

    Returns (ndup, metrics, header) or None when the bucket ranges
    overlap (a foreign, non-position-bucketed tree → caller falls back
    to the in-memory path).
    """
    import shutil
    import tempfile

    from ..bamops import (
        DupMetrics, _dup_decide, _estimate_library_size, dup_scan_columns,
        name_key_columns)
    from ..bamops import _name_group_aggregate
    from ..io import native_ext

    if not native_ext.available():
        return None
    if spill_dir and not Path(spill_dir).is_dir():
        spill_dir = None
    spill = Path(tempfile.mkdtemp(
        prefix="markdup-spill-", dir=spill_dir))
    try:
        return _stream_markdup_inner(
            parts, output, rg_to_lib, remove_dups, optical_pixel_dist,
            partition_bytes, spill, DupMetrics, _dup_decide,
            _estimate_library_size, dup_scan_columns, name_key_columns,
            _name_group_aggregate, BamColumnsWriter, FLAG_DUP)
    finally:
        shutil.rmtree(spill, ignore_errors=True)


def _stream_markdup_inner(parts, output, rg_to_lib, remove_dups,
                          optical_pixel_dist, partition_bytes, spill,
                          DupMetrics, _dup_decide, _estimate_library_size,
                          dup_scan_columns, name_key_columns,
                          _name_group_aggregate, BamColumnsWriter,
                          FLAG_DUP):
    header = None
    bounds: list[tuple[int, int] | None] = []
    offsets = [0]

    # ---- pass 1: scan buckets → h-partition spills + name sidecars ----
    # partition count comes from an actual RECORD estimate (first
    # bucket's records scaled by byte share) — compressed size alone
    # misjudges highly-compressible data by an order of magnitude
    total_in = sum(Path(x).stat().st_size for x in parts)
    P1 = None
    p1_files: list = []
    for pi, part in enumerate(parts):
        h_, cols = read_bam_columns(part)
        header = header or h_
        if P1 is None and (len(cols) or pi == len(parts) - 1):
            # estimate from the first NON-EMPTY bucket (an empty first
            # bucket would collapse P1 to 1 regardless of input size)
            sz0 = max(Path(part).stat().st_size, 1)
            est_records = int(len(cols) * (total_in / sz0)) + 1
            est_scan = est_records * _SCAN_DT.itemsize
            # ~5× headroom: the aggregation's transients (unique over a
            # stacked (n,2) int64, argsort workspace, gid arrays) are a
            # small multiple of the partition's row bytes
            P1 = int(min(512, max(1, -(-est_scan
                                       // max(partition_bytes // 5, 1)))))
            p1_files = [open(spill / f"scan-{i:04d}.bin", "wb")
                        for i in range(P1)]
        base = offsets[-1]
        scan = dup_scan_columns(cols, rg_to_lib)
        n = len(cols)
        rows = np.empty(n, _SCAN_DT)
        rows["h"] = scan["h"]
        rows["nk2"] = scan["nk2"]
        rows["ekey"] = scan["ekey"]
        rows["qsum"] = scan["qsum"]
        rows["gidx"] = np.arange(base, base + n, dtype=np.int64)
        rows["mapped"] = scan["mapped"]
        if n:   # P1 may still be deferred while leading buckets are empty
            part_of = (scan["h"].astype(np.uint64)
                       * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(40)
            part_of = (part_of % np.uint64(P1)).astype(np.int64)
            for i in range(P1):
                sel = rows[part_of == i]
                if len(sel):
                    p1_files[i].write(sel.tobytes())
        # name sidecar: (offset, length) per record + the raw blob
        no = cols.name_off.astype(np.int64)
        ln = cols.fixed[:, F_LNAME].astype(np.int64)
        np.save(spill / f"names-{pi:06d}.off.npy",
                np.stack([no, ln], axis=1))
        cols.names.tofile(spill / f"names-{pi:06d}.blob")

        f = cols.fixed
        m = (f[:, F_FLAG] & FLAG_UNMAPPED) == 0
        if m.any():
            key = ((f[m, F_TID].astype(np.int64) << 32)
                   | f[m, F_POS].astype(np.int64))
            bounds.append((int(key.min()), int(key.max())))
        else:
            bounds.append(None)
        offsets.append(base + n)
        del cols, scan, rows
    for fobj in p1_files:
        fobj.close()

    # genome order = buckets by min mapped key, all-unmapped trees last;
    # ranges must be disjoint for the concatenation to stay sorted
    order = sorted(range(len(parts)),
                   key=lambda i: (bounds[i] is None,
                                  bounds[i][0] if bounds[i] else 0))
    prev_max = None
    for i in order:
        if bounds[i] is None:
            continue
        if prev_max is not None and bounds[i][0] <= prev_max:
            log.warning("markdup: bucket ranges overlap — falling back "
                        "to the in-memory path")
            return None
        prev_max = bounds[i][1]
    offs = np.asarray(offsets, np.int64)

    def names_for(idx: np.ndarray) -> dict[int, bytes]:
        """Global record indices → qname bytes, via the name sidecars
        (no bucket re-decode)."""
        out: dict[int, bytes] = {}
        if len(idx) == 0:
            return out
        bis = np.searchsorted(offs, idx, "right") - 1
        for bi in np.unique(bis):
            ol = np.load(spill / f"names-{int(bi):06d}.off.npy",
                         mmap_mode="r")
            with open(spill / f"names-{int(bi):06d}.blob", "rb") as bf:
                for i in idx[bis == bi]:
                    j = int(i - offs[bi])
                    bf.seek(int(ol[j, 0]))
                    out[int(i)] = bf.read(int(ol[j, 1]))
        return out

    # ---- pass 2: aggregate each h-partition → k1-partition spills ----
    P2 = P1
    p2_files = [open(spill / f"grp-{i:04d}.bin", "wb") for i in range(P2)]
    metrics = DupMetrics()
    for i in range(P1):
        fp = spill / f"scan-{i:04d}.bin"
        rows = np.fromfile(fp, _SCAN_DT)
        fp.unlink()
        if len(rows) == 0:
            continue
        g, _, live = _name_group_aggregate(
            rows["h"].copy(), rows["nk2"].copy(), rows["ekey"].copy(),
            rows["mapped"].astype(bool), rows["qsum"].copy(),
            gidx=rows["gidx"].copy())
        del rows
        if len(live) == 0:
            continue
        grows = np.empty(len(g["k0"]), _GRP_DT)
        for k in ("k0", "k1", "k2", "k3", "score", "first", "cnt", "h",
                  "nk2"):
            grows[k] = g[k]
        part_of = (g["k1"].astype(np.uint64)
                   * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(40)
        part_of = (part_of % np.uint64(P2)).astype(np.int64)
        for j in range(P2):
            sel = grows[part_of == j]
            if len(sel):
                p2_files[j].write(sel.tobytes())
        del g, grows
    for fobj in p2_files:
        fobj.close()

    # ---- pass 3: decide each k1-partition → duplicate name-key set ----
    dup_keys: list[np.ndarray] = []
    for j in range(P2):
        fp = spill / f"grp-{j:04d}.bin"
        grows = np.fromfile(fp, _GRP_DT)
        fp.unlink()
        if len(grows) == 0:
            continue
        g = {k: grows[k].copy()
             for k in ("k0", "k1", "k2", "k3", "score", "first", "cnt")}
        dup_live, pm = _dup_decide(g, names_for, optical_pixel_dist,
                                   return_metrics=True)
        metrics.pairs_examined += pm.pairs_examined
        metrics.unpaired_examined += pm.unpaired_examined
        metrics.pair_duplicates += pm.pair_duplicates
        metrics.unpaired_duplicates += pm.unpaired_duplicates
        metrics.optical_duplicates += pm.optical_duplicates
        if dup_live.any():
            dup_keys.append(np.stack(
                [grows["h"][dup_live], grows["nk2"][dup_live]], axis=1))
        del grows, g
    metrics.estimated_library_size = _estimate_library_size(
        metrics.pairs_examined - metrics.optical_duplicates,
        metrics.pairs_examined - metrics.pair_duplicates)
    if dup_keys:
        dk = np.concatenate(dup_keys)
        # sort by (h, nk2) for the per-bucket membership probe
        dk = dk[np.lexsort((dk[:, 1], dk[:, 0]))]
        dk_h, dk_n = dk[:, 0].copy(), dk[:, 1].copy()
    else:
        dk_h = dk_n = np.zeros(0, np.int64)

    # ---- pass 4: mark + rewrite in genome order -----------------------
    writer = BamColumnsWriter(output, header)
    ndup = 0
    try:
        for bi in order:
            _, cols = read_bam_columns(parts[bi])
            if len(dk_h):
                h, nk2 = name_key_columns(cols)
                lo = np.searchsorted(dk_h, h, "left")
                hit = np.zeros(len(cols), bool)
                # verify nk2 within each h run (runs are tiny: h is a
                # 64-bit hash, so almost always length 1)
                cand = np.flatnonzero(lo < len(dk_h))
                while len(cand):
                    ok = dk_h[lo[cand]] == h[cand]
                    eq = ok & (dk_n[lo[cand]] == nk2[cand])
                    hit[cand[eq]] = True
                    cand = cand[ok & ~eq]
                    lo[cand] += 1
                    cand = cand[lo[cand] < len(dk_h)]
            else:
                hit = np.zeros(len(cols), bool)
            f = cols.fixed
            newly = hit & ((f[:, F_FLAG] & FLAG_DUP) == 0)
            ndup += int(newly.sum())
            f[:, F_FLAG] = np.where(hit, f[:, F_FLAG] | FLAG_DUP,
                                    f[:, F_FLAG])
            if remove_dups:
                cols = cols.take(np.flatnonzero(
                    (f[:, F_FLAG] & FLAG_DUP) == 0))
            writer.write_columns(cols, order=coordinate_order(cols))
    finally:
        writer.close()
    return ndup, metrics, header


def run_markdup(conf: Config, input_path: str, output: str,
                force: bool = False,
                extra_opts: list[str] | None = None) -> str:
    from ..utils.extraopts import ExtraOpts
    xo = ExtraOpts(extra_opts)
    # sambamba markdup surface (SambambaWorker.cpp:74-91): -r removes
    # duplicate records instead of flagging them
    remove_dups = xo.has("-r", "--remove-duplicates")
    xo.warn_unused("markdup")
    output = check_output(output, force)

    p = Path(input_path)
    if p.is_dir():
        parts = get_input_list(p, r"part-\d+.*\.bam")
        total = sum(Path(x).stat().st_size for x in parts)
        if parts and total > (conf.get("tpu.bam.stream_mb") << 20):
            with BamReader(parts[0]) as r:
                rg_to_lib = {rg.get("ID", ""): rg.get("LB", "")
                             for rg in r.header.read_groups}
            res = _stream_markdup(parts, output, rg_to_lib, remove_dups,
                                  spill_dir=conf.get("temp_dir"))
            if res is not None:
                ndup, metrics, _ = res
                log.info(
                    "markdup (streamed, %d buckets): %d duplicates "
                    "(%d optical), %d pairs / %d unpaired examined, "
                    "est. library size %s → %s%s",
                    len(parts), ndup, metrics.optical_duplicates,
                    metrics.pairs_examined, metrics.unpaired_examined,
                    metrics.estimated_library_size, output, rss_suffix())
                return output

    header, cols = load_bam_input_columns(input_path)
    cols, ndup, metrics = mark_duplicates_columns(
        cols, return_metrics=True,
        rg_to_lib={rg.get("ID", ""): rg.get("LB", "")
                   for rg in header.read_groups})
    if remove_dups:
        cols = cols.take(np.flatnonzero(
            (cols.fixed[:, F_FLAG] & FLAG_DUP) == 0))
    write_bam_columns(output, header, cols, order=coordinate_order(cols))
    log.info(
        "markdup: %d records, %d duplicates (%d optical), "
        "%d pairs / %d unpaired examined, est. library size %s → %s%s",
        len(cols), ndup, metrics.optical_duplicates,
        metrics.pairs_examined, metrics.unpaired_examined,
        metrics.estimated_library_size, output, rss_suffix())
    return output
