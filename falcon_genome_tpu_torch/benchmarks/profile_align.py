"""Phase profile of the port's paired alignment on the rehearsal dataset.

Port of ``benchmarks/profile_align.py``: times each phase of one batch of
``AlignerEngine``'s paired path, as ``align`` runs it (FASTQ decode, the
jobs (seeding and chaining), shipping the reads, the device chain (K1
score → pair choice → K2 extend → K3 traceback), collecting (NM, mapq,
mate rescue) and column emission), over ``--batches`` batches of
``--batch`` pairs after one warm-up batch.  On the card every phase ends
at ``torch.cuda.synchronize()``, so device time is billed to the phase
that queued it.  The phases run serially here; ``align`` overlaps the
host phases of one batch with the device chain of the next.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.profile_align [WORKDIR]
        [--batches 4] [--batch 4096] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .wgs_rehearsal import DEFAULT_WORK, card_label, dataset_files

WORK = DEFAULT_WORK
BATCH = 4096


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work", nargs="?", default=str(WORK))
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..aligner import AlignerEngine, AlignerParams, alignments_to_columns
    from ..device import resolve_device
    from ..io.fastq import FastqReader
    from ..stages.common import load_index
    device = resolve_device(args.device)
    ds = dataset_files(Path(args.work))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    idx = load_index(ds["ref"])
    index_s = time.perf_counter() - t0
    print(f"index load: {index_s:.1f}s ({len(idx.hashes) / 1e6:.0f}M "
          "entries)")
    eng = AlignerEngine(idx, AlignerParams(), device=device)

    T: dict[str, float] = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        sync()
        T[name] = T.get(name, 0.0) + time.perf_counter() - t
        return out

    reader = FastqReader(ds["fq1"], ds["fq2"], batch_size=args.batch)
    it = iter(reader)

    # warm the kernels
    b1, b2 = next(it)
    eng.align_pair_batch(b1.codes, b1.lengths, b2.codes, b2.lengths)
    sync()

    n_reads = 0
    t_all = time.perf_counter()
    for _ in range(args.batches):
        b1, b2 = timed("fastq_decode", next, it)
        n_reads += len(b1.lengths) + len(b2.lengths)
        # align_pair_dispatch, phase by phase
        B1 = b1.codes.shape[0]
        L = max(b1.codes.shape[1], b2.codes.shape[1])
        codes = np.full((2 * B1, L), 4, b1.codes.dtype)
        codes[:B1, :b1.codes.shape[1]] = b1.codes
        codes[B1:, :b2.codes.shape[1]] = b2.codes
        lengths = np.concatenate([np.asarray(b1.lengths),
                                  np.asarray(b2.lengths)])
        jobs = timed("seed+chain+jobs", eng._build_jobs, codes, lengths)
        j_read, j_rev, j_rlen, j_start, j_wlen, slice_of = jobs
        reads8_dev = timed("ship_reads", eng._ship_reads, codes, lengths)

        def device_chain():
            from ..ops.smith_waterman import PairPolicy, sw_pair_dispatch
            p = eng.params
            pair = PairPolicy(
                max_candidates=p.max_candidates, window_pad=p.window_pad,
                min_insert=p.min_insert, max_insert=p.max_insert,
                unpaired_penalty=p.unpaired_penalty)
            return sw_pair_dispatch(
                reads8_dev, j_read, j_rev, j_rlen, eng.genome_dev, j_start,
                j_wlen, slice_of, lengths, p.sw, eng.bucket, pair)

        sw_handle = timed("sw_score+pair+extend+traceback", device_chain)
        handle = (codes, lengths, B1, (j_rev, j_rlen, j_start), sw_handle,
                  reads8_dev)
        ab1, ab2 = timed("collect(NM,mapq,rescue)",
                         eng.align_pair_collect, handle)
        timed("emit_columns", lambda: alignments_to_columns(
            b1, ab1, b2, ab2, params=eng.params, read_group="rg0"))

    total = time.perf_counter() - t_all
    print(f"\n{n_reads} reads in {total:.2f}s = {n_reads / total:.0f} "
          "reads/s (serial phases, no overlap)")
    for k, v in sorted(T.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<31} {v:7.2f}s  {100 * v / total:5.1f}%")
    print(f"  {'(untimed)':<31} {total - sum(T.values()):7.2f}s")
    print(json.dumps({"reads": n_reads, "wall_s": round(total, 3),
                      "reads_per_s": round(n_reads / total, 1),
                      "index_load_s": round(index_s, 2),
                      "phases_s": {k: round(v, 4) for k, v in T.items()},
                      "card": card_label(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
