"""Indel realignment of the port at the germline rehearsal's scale.

Port of ``benchmarks/indel_rehearsal.py``: ``stages.run_indel`` over the
WGS rehearsal's ``dedup.bam`` on ``--device`` (the reference runs
IndelWorker over the same whole-genome scatter as every other
subcommand, worker-indel.cpp:17-125).  The ``indel`` row has the JAX
script's wall, peak RSS, genome and reads, and seconds a Mb; the genome
and reads are those of the dataset that ran (the sizes that
``wgs_rehearsal.gen_dataset`` records in ``dataset.json``), where the JAX
script wrote 60 Mb and 10 M reads whatever ran.  It adds the reads
realigned (from the stage's closing log line), the card, the peak device
memory and each kernel's launches.  It merges into ``--out`` under
``indel`` on the default 60 Mb genome and under ``indel@<Mb>mb`` on any
other (:func:`result_key`).

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.indel_rehearsal
        [WORKDIR] [--device cuda|cpu] [--out PATH] [--series PATH]
"""
from __future__ import annotations

import argparse
import json
import logging
import re
import sys
from pathlib import Path

from .wgs_rehearsal import (
    DEFAULT_MB, DEFAULT_OUT, DEFAULT_WORK, Measured, card_label, make_conf,
    row_key, save_row, save_series)


def realigned(log_lines: list[str]) -> int | None:
    """The reads realigned, from ``run_indel``'s closing log line."""
    for line in log_lines:
        m = re.match(r"indel: (\d+) reads realigned", line)
        if m:
            return int(m.group(1))
    return None


def result_key(genome_mb: float) -> str:
    """The row's key in the results JSON for a dataset of ``genome_mb``:
    ``indel`` at the rehearsal's default genome, ``indel@<Mb>mb`` else."""
    return row_key("indel", genome_mb, DEFAULT_MB, "mb")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work", nargs="?", default=str(DEFAULT_WORK))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="results JSON (merged with what it holds)")
    ap.add_argument("--series", default=None, metavar="PATH",
                    help="also sample the stage's memory every second; "
                         "the snapshots merge into PATH")
    args = ap.parse_args(argv)
    from .. import stages
    from ..device import resolve_device
    device = resolve_device(args.device)
    work = Path(args.work)
    bam = work / "dedup.bam"
    if not bam.exists():
        raise SystemExit("needs the rehearsal dedup BAM "
                         "(run wgs_rehearsal first)")
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    conf = make_conf(work)
    out = work / "realigned.bam"
    with Measured(device, series=args.series is not None) as m:
        stages.run_indel(conf, str(work / "ref.fa"), str(bam), str(out),
                         force=True, device=device)

    sizes = json.loads((work / "dataset.json").read_text())
    genome_mb, reads = sizes["G"] / 1e6, 2 * sizes["N_PAIRS"]
    row = {"wall_s": round(m.wall, 1), **m.memory(),
           "genome_mb": genome_mb,
           "reads": reads,
           "s_per_mb": round(m.wall / genome_mb, 1),
           "realigned_reads": realigned(m.log.lines),
           "launches": m.launches,
           "card": card_label(device)}
    key = result_key(genome_mb)
    save_row(Path(args.out), key, row)
    if args.series is not None:
        save_series(Path(args.series), {key: {
            "start": m.start, "end": m.end, "samples": m.series}})
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
