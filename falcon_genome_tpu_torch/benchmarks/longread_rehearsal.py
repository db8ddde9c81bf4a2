"""Long-read alignment of the port at rehearsal scale.

Port of ``benchmarks/longread_rehearsal.py``: an ONT-class read set over
the WGS rehearsal's reference (``ref.fa`` of ``wgs_rehearsal``'s work
directory) — log-normal lengths (~5-25 kb, median ~10 kb, cut to
3-30 kb), 5% errors (60% substitutions, 40% deletions), both strands;
``long_reads.fastq`` equals the JAX script's byte for byte
(``default_rng(77)``) — through the production ``align --long-reads``
stage (``stages.run_align(long_reads=True)``) on ``--device``: FASTQ →
chained, checkpointed piecewise Smith-Waterman → sorted BAM.

Eight reads go through the same stage first, out of the timed run: on the
card that takes the kernels' build and first launches, as the warm-up
took XLA's compiles on the TPU.  The ``longread`` row (wall, peak RSS,
reads, Mbp, Mbp/s, reads/s, mapped fraction) adds the card, the peak
device memory and each kernel's launches in the timed run; it merges into
``--out`` under ``longread`` at the default 60 Mbp and under
``longread@<Mbp>mbp`` at any other total (:func:`result_key`).

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.longread_rehearsal
        [WORKDIR] [TOTAL_MBP] [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

from .wgs_rehearsal import (
    DEFAULT_OUT, DEFAULT_WORK, Measured, card_label, make_conf, row_key,
    save_row)

DEFAULT_MBP = 60.0


def gen_reads(work: Path, ref_codes, total_bp: int, rng) -> Path:
    """``long_reads.fastq`` of ``total_bp`` bases drawn from ``rng`` in the
    JAX script's order; reused where it exists."""
    from ..io.dna import decode_seq, revcomp_codes
    fq = work / "long_reads.fastq"
    if fq.exists():
        print("long-read FASTQ cached")
        return fq
    G = len(ref_codes)
    t0 = time.perf_counter()
    done = 0
    i = 0
    with open(fq, "w") as f:
        while done < total_bp:
            L = int(np.clip(rng.lognormal(np.log(10_000), 0.45),
                            3_000, 30_000))
            p = int(rng.integers(0, G - L))
            r = ref_codes[p:p + L].copy()
            err = rng.random(L) < 0.05
            sub = rng.random(L) < 0.6
            r[err & sub] = (r[err & sub] + 1) % 4
            r = r[~(err & ~sub)]                  # deletions
            if rng.random() < 0.5:
                r = revcomp_codes(r)
            f.write(f"@lr{i}\n{decode_seq(r)}\n+\n{'I' * len(r)}\n")
            done += len(r)
            i += 1
    print(f"{i} reads / {done / 1e6:.0f} Mbp in "
          f"{time.perf_counter() - t0:.0f}s")
    return fq


def result_key(total_mbp: float) -> str:
    """The row's key in the results JSON for a run of ``total_mbp``."""
    return row_key("longread", total_mbp, DEFAULT_MBP, "mbp")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work", nargs="?", default=str(DEFAULT_WORK))
    ap.add_argument("total_mbp", nargs="?", type=float, default=DEFAULT_MBP)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="results JSON (merged with what it holds)")
    args = ap.parse_args(argv)
    from .. import stages
    from ..device import resolve_device
    from ..io.bam import read_bam
    from ..io.fasta import FastaFile
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    work = Path(args.work)
    ref = work / "ref.fa"
    if not ref.exists():
        raise SystemExit("needs the rehearsal reference")
    fa = FastaFile(str(ref))
    codes = fa.contig_codes(fa.dict.contigs[0].name)
    rng = np.random.default_rng(77)
    fq = gen_reads(work, codes, int(args.total_mbp * 1e6), rng)
    with open(fq) as f:
        lens = [len(line) - 1 for i, line in enumerate(f) if i % 4 == 1]
    n_reads, total_bp = len(lens), sum(lens)

    conf = make_conf(work)
    out = work / "long_aligned.bam"

    # warm-up: a tiny slice through the same stage builds the kernels and
    # makes their first launches; the row measures steady throughput
    warm_fq = work / "long_warm.fastq"
    with open(fq) as src, open(warm_fq, "w") as dst:
        for i, line in enumerate(src):
            if i >= 4 * 8:
                break
            dst.write(line)
    stages.run_align(conf, str(ref), str(work / "long_warm.bam"),
                     fastq1=str(warm_fq), sample_id="warm",
                     long_reads=True, force=True, device=device)

    with Measured(device) as m:
        stages.run_align(conf, str(ref), str(out), fastq1=str(fq),
                         sample_id="lr", long_reads=True, force=True,
                         device=device)

    _, recs = read_bam(str(out))
    mapped = sum(1 for r in recs if not r.is_unmapped)
    row = {"wall_s": round(m.wall, 1), **m.memory(),
           "reads": n_reads, "total_mbp": round(total_bp / 1e6, 1),
           "mbp_per_s": round(total_bp / 1e6 / m.wall, 3),
           "reads_per_s": round(n_reads / m.wall, 1),
           "mapped_frac": round(mapped / max(n_reads, 1), 4),
           "launches": m.launches,
           "card": card_label(device)}
    save_row(Path(args.out), result_key(args.total_mbp), row)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
