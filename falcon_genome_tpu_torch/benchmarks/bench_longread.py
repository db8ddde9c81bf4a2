"""Long-read aligner throughput (Mbp/s) and its host-loop profile, on the
port.

Port of ``benchmarks/bench_longread.py``: ``n_reads`` reads of
``read_len`` bases (5% ONT-class errors: 60% substitutions, 40%
deletions) from a random 1 Mb genome (``default_rng(3)``) through
``LongReadAligner.align_batch`` on ``--device`` (which replaces the JAX
script's ``LR_CPU``): one warm pass (on the card, the kernels' build and
first launches), then the best of three timed passes, the last under
``cProfile``.  Prints the mapped count as the JAX script does, then the
profile's top 18 by cumulative time, then one JSON line with the peak
device memory and each kernel's launches over the timed passes, and the
card.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.bench_longread
        [N_READS] [READ_LEN] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import sys
import time

import numpy as np

G = 1_000_000


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=64)
    ap.add_argument("read_len", nargs="?", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..aligner import IndexParams, MinimizerIndex
    from ..device import resolve_device
    from ..longread import LongReadAligner, LongReadParams
    from .wgs_rehearsal import Measured, card_label
    device = resolve_device(args.device)
    n_reads, read_len = args.n_reads, args.read_len

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    lp = LongReadParams(index=IndexParams(k=19, w=10, max_hits=256))
    idx = MinimizerIndex([("chr1", genome)], lp.index)
    eng = LongReadAligner(idx, lp, device=device)

    reads = []
    for _ in range(n_reads):
        p = int(rng.integers(0, G - read_len))
        r = genome[p:p + read_len].copy()
        err = rng.random(read_len) < 0.05         # 5% ONT-class error
        sub = rng.random(read_len) < 0.6
        r[err & sub] = (r[err & sub] + 1) % 4
        keep = ~(err & ~sub)                      # rest are deletions
        reads.append(r[keep])

    eng.align_batch(reads)                        # build, first launches
    bp = sum(len(r) for r in reads)
    best = float("inf")
    prof = cProfile.Profile()
    with Measured(device) as m:
        for it in range(3):                       # steady state
            t0 = time.perf_counter()
            if it == 2:
                prof.enable()
            res = eng.align_batch(reads)
            if it == 2:
                prof.disable()
            best = min(best, time.perf_counter() - t0)
    mapped = sum(a.mapped for a in res)
    print(f"{n_reads} reads x ~{read_len}bp: {best:.2f}s steady "
          f"({bp / best / 1e6:.2f} Mbp/s)  mapped {mapped}/{n_reads}")
    st = pstats.Stats(prof, stream=sys.stdout)
    st.sort_stats("cumulative").print_stats(18)
    print(json.dumps({"reads": n_reads, "read_len": read_len, "bp": bp,
                      "best_s": round(best, 4),
                      "mbp_per_s": round(bp / best / 1e6, 3),
                      "mapped": mapped,
                      "peak_device_gb": m.row(n_reads)["peak_device_gb"],
                      "launches": m.launches, "card": card_label(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
