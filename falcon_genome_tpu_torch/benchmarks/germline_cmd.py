"""One-command germline rehearsal of the port.

Port of ``benchmarks/germline_cmd.py``: the single ``germline`` entry
(align → markdup → bqsr → htc in one call, worker-germline.cpp:21-337) on
the dataset that ``wgs_rehearsal`` cached in the work directory, with its
wall, reads/s, peak RSS, peak device memory, kernel launches, the path
align and markdup took, and accuracy against the planted truth.  The row
goes into ``--out`` under ``germline_cmd`` on the default 60 Mb genome and
under ``germline_cmd@<Mb>mb`` on any other.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.germline_cmd [WORKDIR]
        [--device cuda|cpu] [-O KEY=VALUE ...] [--out PATH]
"""
from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

import numpy as np

from .wgs_rehearsal import (
    DEFAULT_MB, Measured, card_label, dataset_files, dataset_pairs,
    input_path, logged_paths, make_conf, parse_args, row_key, save_row)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv, __doc__.splitlines()[0], stages=False)
    from .. import stages
    from ..device import resolve_device
    from ..io.vcf import read_vcf
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    work = Path(args.work)
    ds = dataset_files(work)
    n_reads = 2 * dataset_pairs(work)
    conf = make_conf(work, args.option)
    out = work / "germline_cmd.vcf.gz"
    gwork = work / "germline_cmd_work"

    with Measured(device) as m:
        stages.run_germline(conf, ds["ref"], str(out),
                            fastq1=ds["fq1"], fastq2=ds["fq2"],
                            sample_id="s", produce_vcf=True, force=True,
                            work_dir=str(gwork), device=device)

    truth = set(np.load(work / "truth.npy").tolist())
    _, recs = read_vcf(str(out))
    called = {r.pos - 1 for r in recs if not r.is_gvcf_block}
    tp = len(truth & called)
    row = {**m.row(n_reads),
           "sensitivity": round(tp / len(truth), 4),
           "extra_calls": len(called - truth),
           "precision": round(tp / max(len(called), 1), 5),
           "path": {
               **logged_paths(m.log),
               "bqsr": input_path(conf, str(gwork / "dedup.bam")),
               "htc": input_path(conf, str(gwork / "recal"))},
           "card": card_label(device)}
    genome_mb = json.loads((work / "dataset.json").read_text())["G"] / 1e6
    save_row(Path(args.out),
             row_key("germline_cmd", genome_mb, DEFAULT_MB, "mb"), row)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
