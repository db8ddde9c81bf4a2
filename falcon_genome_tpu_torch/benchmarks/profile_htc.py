"""Profile the port's HaplotypeCaller at mid scale.

Port of ``benchmarks/profile_htc.py``: simulates a 2 Mb contig at ~15x
with planted het SNPs and runs ``HaplotypeCaller.call_interval`` over it
under ``cProfile`` (kernels on ``--device``), to find where the host time
goes.  Prints the 25 costliest functions by cumulative time, writes the
profile to ``--pstats`` and ends with a JSON row (wall, reads/s, calls,
true positives, kernel launches, the 15 costliest functions by own time).

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.profile_htc
        [--genome-mb 2] [--device cuda|cpu] [--pstats PATH]
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import sys
import time
from pathlib import Path

import numpy as np

from .wgs_rehearsal import DEFAULT_WORK, card_label, launch_counts

G = 2_000_000
READ_LEN = 150
STEP = 10   # one 150 bp read per 10 bp start = 15x (half ref, half alt hap)


def simulate(genome_len: int):
    """(reference codes, planted SNP positions, reads) from
    ``default_rng(7)`` in the JAX script's draw order."""
    from ..io.dna import decode_seq
    from ..io.sam import CIGAR_M, SamRecord

    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, genome_len).astype(np.uint8)
    alt = ref.copy()
    # planted het SNPs on a strided grid (>= 900 bp apart) so adjacent
    # sites can't merge into MNP/complex calls whose pos matches neither
    # truth site
    grid = np.arange(1000, genome_len - 1000, 900)
    snps = np.sort(rng.choice(grid, genome_len // 1000, replace=False))
    for p in snps:
        alt[p] = (alt[p] + 1) % 4
    records = []
    for i, start in enumerate(range(0, genome_len - READ_LEN, STEP)):
        hap = alt if i % 2 else ref
        seq = hap[start:start + READ_LEN].copy()
        # 0.2% sequencing error
        errs = rng.random(READ_LEN) < 0.002
        seq[errs] = (seq[errs] + rng.integers(1, 4, errs.sum())) % 4
        records.append(SamRecord(
            qname=f"r{i}", flag=0, tid=0, pos=start, mapq=60,
            cigar=[(CIGAR_M, READ_LEN)], seq=decode_seq(seq),
            qual="I" * READ_LEN))
    return ref, snps, records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-mb", type=float, default=G / 1e6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pstats", default=str(DEFAULT_WORK / "htc.pstats"))
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..models.haplotypecaller import HaplotypeCaller, HTCParams
    device = resolve_device(args.device)
    genome_len = int(round(args.genome_mb * 1e6))
    ref, snps, records = simulate(genome_len)
    print(f"{len(records)} reads over {genome_len / 1e6:.1f} Mb "
          f"(~{len(records) * READ_LEN / genome_len:.0f}x)")

    hc = HaplotypeCaller(HTCParams(device=device))
    launches0 = launch_counts()
    t0 = time.perf_counter()
    prof = cProfile.Profile()
    prof.enable()
    out = hc.call_interval(records, ref, "chr1", 0, genome_len)
    prof.disable()
    dt = time.perf_counter() - t0
    launches = {k: n - launches0[k] for k, n in launch_counts().items()}

    called = {r.pos - 1 for r in out}
    tp = sum(1 for p in snps if p in called)
    print(f"call_interval: {dt:.1f}s  ({len(records) / dt:.0f} reads/s)  "
          f"calls={len(out)} tp={tp}/{len(snps)}")
    st = pstats.Stats(prof)
    Path(args.pstats).parent.mkdir(parents=True, exist_ok=True)
    st.dump_stats(args.pstats)
    st.sort_stats("cumulative").print_stats(25)
    own = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    print(json.dumps({
        "reads": len(records), "genome_mb": genome_len / 1e6,
        "call_interval_s": round(dt, 2),
        "reads_per_s": round(len(records) / dt, 1),
        "calls": len(out), "tp": tp, "snps": len(snps),
        "launches": launches,
        "top_own_s": [[f"{Path(f).name}:{line}({fn})", round(v[2], 3)]
                      for (f, line, fn), v in own],
        "card": card_label(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
