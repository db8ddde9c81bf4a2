"""``germline`` stage: fused align → markdup → bqsr → htc per sample.

Mirrors src/worker-germline.cpp:21-337 — the reference's one-command
end-to-end germline pipeline (align per read group, per-bucket sort,
HaplotypeCaller scatter, concat/zip) — the "minimum end-to-end slice"
(SURVEY.md §3.3).

Resume: each completed sub-stage leaves its artifact in ``work/`` plus a
``.done`` marker; a re-run (after a kill) reuses completed artifacts and
restarts at the first unfinished stage.  ``-f`` discards the work dir
and recomputes everything — the reference's per-subcommand re-runnability
against deterministic artifacts (scripts/pipeline.sh:24-63,
common.h:232-245) fused into one driver.

Port of ``falcon_genome_tpu/stages/germline.py`` (short reads): align and
htc run their kernels on ``device``; markdup and bqsr run on the host.
"""
from __future__ import annotations

import logging
import shutil
from pathlib import Path

import torch

from ..config import Config
from ..utils.common import check_output

from .align import run_align
from .bamstages import run_markdup
from .bqsr import run_bqsr
from .calling import run_htc

log = logging.getLogger("falcon_genome_tpu")


def _done_marker(work: Path, name: str) -> Path:
    return work / f".{name}.done"


def _reusable(work: Path, name: str, artifact: Path) -> bool:
    """Artifact complete from a previous (killed) run?  The marker is
    written only after the artifact is fully on disk, so marker+artifact
    together mean the stage finished."""
    return _done_marker(work, name).exists() and artifact.exists()


def run_germline(conf: Config, ref: str, output_vcf: str,
                 fastq1: str | None = None, fastq2: str | None = None,
                 sample_sheet: str | None = None,
                 sample_id: str = "sample", read_group: str = "rg0",
                 produce_vcf: bool = False, markdup: bool = True,
                 work_dir: str | None = None, long_reads: bool = False,
                 force: bool = False,
                 extra_opts: list[str] | None = None,
                 device: torch.device = torch.device("cpu")) -> str:
    # validate the final output BEFORE any alignment work (the reference
    # checks outputs in Worker::check() ahead of execution —
    # src/common.cpp:75-114); run_htc re-checks, by then it's gone/allowed
    check_output(output_vcf, force)
    work = Path(work_dir or (str(output_vcf) + ".work"))
    if force and work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True, exist_ok=True)

    # reference chain (worker-germline.cpp:21-337): align (bucketed
    # sorted output) → markdup (streams the bucket tree out-of-core) →
    # baserecal + printreads → htc on the RECALIBRATED reads.  The
    # aligner emits the part-%06d tree unmerged so markdup never holds
    # the sample in memory; bqsr's empirical quals are what suppress
    # error-pileup het calls downstream.
    aligned = work / "aligned.bam"
    bucket_dir = work / "aligned"
    if _reusable(work, "align", bucket_dir):
        log.info("germline: resume — reusing %s", bucket_dir)
    else:
        run_align(
            conf, ref, str(aligned), fastq1=fastq1, fastq2=fastq2,
            sample_sheet=sample_sheet, sample_id=sample_id,
            read_group=read_group, long_reads=long_reads, force=True,
            num_buckets=conf.get("bwa.num_buckets"),
            merge=False, extra_opts=extra_opts, device=device)
        _done_marker(work, "align").touch()
    bam = str(bucket_dir)
    if markdup:
        dedup = work / "dedup.bam"
        if _reusable(work, "markdup", dedup):
            log.info("germline: resume — reusing %s", dedup)
        else:
            run_markdup(conf, bam, str(dedup), force=True,
                        extra_opts=extra_opts)
            _done_marker(work, "markdup").touch()
        bam = str(dedup)
    recal = work / "recal"
    if _reusable(work, "bqsr", recal):
        log.info("germline: resume — reusing %s", recal)
    else:
        run_bqsr(conf, ref, bam, str(recal), force=True,
                 extra_opts=extra_opts)
        _done_marker(work, "bqsr").touch()
    return run_htc(conf, ref, str(recal), output_vcf,
                   produce_vcf=produce_vcf, sample=sample_id, force=force,
                   extra_opts=extra_opts, device=device)
