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
memory and each kernel's launches.  It merges into ``--out``.

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
    DEFAULT_OUT, DEFAULT_WORK, Measured, card_label, load_results, make_conf,
    save_series)


def realigned(log_lines: list[str]) -> int | None:
    """The reads realigned, from ``run_indel``'s closing log line."""
    for line in log_lines:
        m = re.match(r"indel: (\d+) reads realigned", line)
        if m:
            return int(m.group(1))
    return None


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
    results_path = Path(args.out)
    results = load_results(results_path)
    results["indel"] = {"wall_s": round(m.wall, 1), **m.memory(),
                        "genome_mb": genome_mb,
                        "reads": reads,
                        "s_per_mb": round(m.wall / genome_mb, 1),
                        "realigned_reads": realigned(m.log.lines),
                        "launches": m.launches,
                        "card": card_label(device)}
    results_path.parent.mkdir(parents=True, exist_ok=True)
    results_path.write_text(json.dumps(results, indent=1))
    if args.series is not None:
        save_series(Path(args.series), {"indel": {
            "start": m.start, "end": m.end, "samples": m.series}})
    print(json.dumps(results["indel"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
