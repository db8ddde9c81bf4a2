"""Aligner throughput of the port: index build on a random genome, then
``AlignerEngine.align_batch`` of single reads with 1% substitutions on
both strands, timed after two warm-up calls.

Port of ``benchmarks/bench_align.py`` (1 Mb genome, 5000 reads of 150 bp
by default).  Ends with a JSON row.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.bench_align
        [--genome-mb 1] [--reads 5000] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .wgs_rehearsal import card_label

L = 150


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-mb", type=float, default=1.0)
    ap.add_argument("--reads", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..aligner import (
        AlignerEngine, AlignerParams, IndexParams, MinimizerIndex)
    from ..device import resolve_device
    from ..io.dna import revcomp_codes
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    genome_len = int(round(args.genome_mb * 1e6))
    chrom = rng.integers(0, 4, genome_len).astype(np.uint8)
    t0 = time.perf_counter()
    idx = MinimizerIndex([("chr1", chrom)], IndexParams(k=17, w=7))
    index_s = time.perf_counter() - t0
    print(f"index build {genome_len / 1e6:g}Mb: {index_s:.2f}s  "
          f"entries={len(idx.hashes)}")

    n = args.reads
    reads = np.zeros((n, L), np.uint8)
    for i in range(n):
        p = rng.integers(0, genome_len - L)
        r = chrom[p:p + L].copy()
        mut = rng.random(L) < 0.01
        r = np.where(mut, (r + rng.integers(1, 4, L)) % 4, r).astype(np.uint8)
        reads[i] = revcomp_codes(r) if rng.random() < 0.5 else r
    lens = np.full(n, L, np.int32)

    eng = AlignerEngine(idx, AlignerParams(), device=device)
    # warm up (build the kernels, first launches)
    eng.align_batch(reads[:64], lens[:64])
    eng.align_batch(reads, lens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = eng.align_batch(reads, lens)
    dt = time.perf_counter() - t0
    mapped = sum(a.mapped for a in res)
    print(f"align {n} reads: {dt:.2f}s -> {n / dt:.0f} reads/s  "
          f"(mapped {mapped / n:.1%})")
    print(json.dumps({"index_build_s": round(index_s, 3),
                      "entries": int(len(idx.hashes)),
                      "reads": n, "align_s": round(dt, 4),
                      "reads_per_s": round(n / dt, 1),
                      "mapped": round(mapped / n, 4),
                      "card": card_label(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
