"""Markdup scale harness of the port: prove the streamed bucket-tree
markdup is O(partition)-memory, not O(records), at 100M+ records.

The reference streams markdup through sambamba with a bounded fd/overflow
budget (src/workers/SambambaWorker.cpp:59-72, src/config.cpp:311-313);
round 3's streamed path was still O(total records) in RAM (~60 GB at a
human 30× WGS).  This harness generates a synthetic bucket tree with an
exactly-known duplicate structure, runs `_stream_markdup` in a fresh
subprocess, and reports that subprocess's peak RSS plus correctness
gates:

* every planted duplicate copy (and only those) is FLAG_DUP'd — the
  keeper is the higher-qual original by construction, and fragment
  coordinates are distinct by construction (pos = fragment_id·37), so
  the expected duplicate count is exact;
* at --check-memory scale, the same tree also runs through the
  in-memory path and per-record flags must match exactly.

Port of ``benchmarks/markdup_scale.py`` onto the port's
``stages.bamstages._stream_markdup`` (host code; the out-of-core markdup
that a whole-genome ``germline`` takes).  The tree goes under ``--out``
(default a fresh directory under ``build/``) and is removed unless
``--keep``.

Usage:
  python -m falcon_genome_tpu_torch.benchmarks.markdup_scale \
      --records 100000000 --out build/md
  python -m falcon_genome_tpu_torch.benchmarks.markdup_scale \
      --records 4000000 --check-memory
"""
import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

L = 36                  # read length
FRAG = 300              # mate offset
STRIDE = 37             # fragment position stride (distinct coordinates)
DUP_RATE = 0.04


def _digits(ids: np.ndarray, width: int) -> np.ndarray:
    """(n, width) uint8 ASCII digits of ids."""
    out = np.empty((len(ids), width), np.uint8)
    v = ids.copy()
    for k in range(width - 1, -1, -1):
        out[:, k] = (v % 10) + 48
        v //= 10
    return out


def generate(out_dir: str, n_records: int, n_buckets: int, seed: int = 0):
    """Bucket tree of paired-end records with planted duplicates.

    Fragment i sits at pos=i*STRIDE (mate at +FRAG-L); a deterministic
    DUP_RATE subset is emitted twice (the copy with uniformly lower
    quals, so the original is always the keeper).  Records land in the
    bucket of their own start — mates near a boundary cross buckets.
    Returns (parts, n_total, n_planted_dup_records).
    """
    from ..io.bam import BamColumnsWriter
    from ..io.columns import RecordColumns
    from ..io.sam import FLAG_REVERSE, SamHeader

    n_frag = n_records // 2
    genome = n_frag * STRIDE + FRAG + L + 1
    header = SamHeader(contigs=[("chr1", int(genome))],
                       read_groups=[{"ID": "rg1", "LB": "lib1"}],
                       sort_order="coordinate")
    os.makedirs(out_dir, exist_ok=True)
    span = (genome + n_buckets - 1) // n_buckets
    writers = [BamColumnsWriter(
        os.path.join(out_dir, f"part-{i:06d}.bam"), header)
        for i in range(n_buckets)]

    CH = 1 << 20        # fragments per generation chunk
    ndup_records = 0
    name_w = 11
    for a in range(0, n_frag, CH):
        b = min(a + CH, n_frag)
        gid = np.arange(a, b, dtype=np.int64)
        # deterministic dup choice: every k-th fragment duplicated
        k = max(2, int(round(1.0 / DUP_RATE)))
        is_dup = (gid % k) == 1
        reps = 1 + is_dup.astype(np.int64)
        frag_ids = np.repeat(gid, reps)
        copy_no = np.ones(len(frag_ids), np.int64)
        first = np.ones(len(frag_ids), bool)
        first[1:] = frag_ids[1:] != frag_ids[:-1]
        copy_no[first] = 0
        nfr = len(frag_ids)
        n = 2 * nfr                       # two mates per emitted fragment
        ndup_records += 2 * int((copy_no == 1).sum())

        pos1 = frag_ids * STRIDE
        pos2 = pos1 + FRAG - L
        fixed = np.zeros((n, 12), np.int32)
        fixed[0::2, 1] = pos1
        fixed[1::2, 1] = pos2
        fixed[:, 2] = 60                                      # mapq
        fixed[0::2, 3] = 0x1 | 0x40
        fixed[1::2, 3] = 0x1 | 0x80 | FLAG_REVERSE
        fixed[:, 4] = L                                       # lseq
        fixed[0::2, 6] = pos2
        fixed[1::2, 6] = pos1                                 # mpos
        fixed[:, 8] = 1                                       # ncigar
        fixed[:, 9] = name_w + 2                              # lname
        fixed[:, 11] = fixed[:, 1] + L                        # endpos

        # names: "d########## :c" per fragment (same for both mates)
        nm = np.empty((nfr, name_w + 2), np.uint8)
        nm[:, 0] = ord("d")
        nm[:, 1:name_w + 1] = _digits(frag_ids, name_w)
        nm[:, name_w + 1] = 48 + copy_no
        names = np.repeat(nm, 2, axis=0).reshape(-1)
        name_off = np.arange(n, dtype=np.int64) * (name_w + 2)

        cigar_ops = np.zeros(n, np.int32)                     # M
        cigar_lens = np.full(n, L, np.int32)
        cig_off = np.arange(n, dtype=np.int64)
        seq = np.full(n * L, ord("A"), np.uint8)
        qual = np.empty((n, L), np.uint8)
        qual[:] = ord("I")
        qual[np.repeat(copy_no == 1, 2)] = ord("5")           # lower qual
        seq_off = np.arange(n, dtype=np.int64) * L

        cols = RecordColumns(
            fixed=fixed, names=names, name_off=name_off,
            cigar_ops=cigar_ops, cigar_lens=cigar_lens, cig_off=cig_off,
            seq=seq, qual=qual.reshape(-1), seq_off=seq_off,
            tags=np.zeros(0, np.uint8),
            tag_off=np.zeros(n, np.int64), tag_len=np.zeros(n, np.int64))
        bucket = fixed[:, 1] // span
        for bi in np.unique(bucket):
            sel = np.flatnonzero(bucket == bi)
            writers[int(bi)].write_columns(cols.take(sel))
    parts = []
    for w in writers:
        w.close()
        parts.append(w.path)
    return parts, ndup_records


def run_markdup(tree_dir: str, out_bam: str, partition_mb: int):
    """Subprocess body: run _stream_markdup, print JSON result: the
    subprocess's peak RSS (``ru_maxrss``) and its split, the peaks of
    ``RssAnon`` and ``RssFile`` and what the process held once its imports
    were done (``rss_probe.snapshot``)."""
    from ..stages.bamstages import _stream_markdup
    from ..utils.common import get_input_list
    from .rss_probe import snapshot
    from .wgs_rehearsal import RssSampler

    imported = snapshot()
    sampler = RssSampler()
    parts = get_input_list(tree_dir, r"part-\d+.*\.bam")
    t0 = time.perf_counter()
    res = _stream_markdup(parts, out_bam, {"rg1": "lib1"},
                          remove_dups=False,
                          partition_bytes=partition_mb << 20,
                          spill_dir=os.path.dirname(out_bam))
    wall = time.perf_counter() - t0
    if res is None:
        sys.exit("streamed path fell back (no native library, or the "
                 "bucket ranges overlap)")
    ndup, metrics, _ = res
    sampler.stop()
    end = snapshot()
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(json.dumps({
        "ndup": ndup, "wall_s": round(wall, 1),
        "peak_rss_gb": round(peak_gb, 2),
        **{f"peak_rss_{k}_gb": None if v is None else round(v, 2)
           for k, v in (("anon", sampler.peak_anon),
                        ("file", sampler.peak_file))},
        "after_imports": {k: imported[k] for k in (
            "rss_gb", "anon_gb", "file_gb", "threads", "torch_threads")},
        "at_end": {k: end.get(k) for k in (
            "rss_gb", "anon_gb", "file_gb", "huge_gb", "malloc_arena_gb",
            "malloc_free_gb", "threads")},
        "pairs_examined": metrics.pairs_examined,
        "pair_duplicates": metrics.pair_duplicates,
    }))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=100_000_000)
    ap.add_argument("--buckets", type=int, default=64)
    ap.add_argument("--partition-mb", type=int, default=512)
    ap.add_argument("--out", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--check-memory", action="store_true",
                    help="also run the in-memory path and diff flags")
    ap.add_argument("--_run", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args._run:
        run_markdup(args._run[0], args._run[1], args.partition_mb)
        return 0

    if args.out is None:
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    base = args.out or tempfile.mkdtemp(
        prefix="markdup-scale-", dir=os.path.join(REPO, "build"))
    tree = os.path.join(base, "tree")
    try:
        t0 = time.perf_counter()
        parts, ndup_expect = generate(tree, args.records, args.buckets)
        gen_s = time.perf_counter() - t0
        tree_gb = sum(os.path.getsize(p) for p in parts) / 1e9
        print(f"# generated {args.records} records, {len(parts)} buckets, "
              f"{tree_gb:.1f} GB, {gen_s:.0f}s, expect ndup="
              f"{ndup_expect}", file=sys.stderr)

        out_bam = os.path.join(base, "marked.bam")
        r = subprocess.run(
            [sys.executable, "-m", __spec__.name,
             "--partition-mb", str(args.partition_mb),
             "--_run", tree, out_bam],
            capture_output=True, text=True, cwd=REPO)
        print(r.stderr, file=sys.stderr, end="")
        if r.returncode != 0:
            sys.exit(f"markdup subprocess failed:\n{r.stdout}\n{r.stderr}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["records"] = args.records
        res["ndup_expected"] = ndup_expect
        res["dup_exact"] = (res["ndup"] == ndup_expect)

        if args.check_memory:
            from ..bamops import mark_duplicates_columns
            from ..io.bam import read_bam_columns
            from ..io.columns import F_FLAG, RecordColumns
            ref = RecordColumns.concat(
                [read_bam_columns(p)[1] for p in parts])
            ref = ref.take(ref.coordinate_order())
            ref, ndup_m, _ = mark_duplicates_columns(
                ref, return_metrics=True, rg_to_lib={"rg1": "lib1"})
            _, got = read_bam_columns(out_bam)
            got = got.take(got.coordinate_order())
            res["in_memory_ndup"] = ndup_m
            res["flags_equal"] = bool(np.array_equal(
                got.fixed[:, F_FLAG], ref.fixed[:, F_FLAG]))
        print(json.dumps(res))
    finally:
        if not args.keep:
            shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
