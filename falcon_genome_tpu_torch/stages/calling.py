"""Caller stage ``htc`` (HaplotypeCaller).

Port of ``falcon_genome_tpu/stages/calling.py``, the ``htc`` driver only
(``mutect2`` and ``ug`` are not ported yet).  Mirrors the reference
driver: per-contig-shard caller scatter over the gatk.ncontigs interval
plan, per-shard ``part-%06d.gvcf``/``.vcf`` outputs, then concat → bgzip
(src/worker-htc.cpp:19-181).
"""
from __future__ import annotations

import logging
import os
from pathlib import Path

import torch

from ..config import Config
from ..io.intervals import (
    Interval, intersect_intervals, read_interval_list)
from ..io.vcf import (
    STANDARD_META, VcfHeader, concat_vcfs, write_vcf)
from ..utils.common import check_output, get_contig_fname
from ..utils.extraopts import ExtraOpts

from ..models.haplotypecaller import HaplotypeCaller, HTCParams
from ..parallel import is_primary, sync_processes
from ..pipeline.runner import PipelineRunner, stage
from .bamstages import BamInputSource
from .common import interval_shards, load_fasta

log = logging.getLogger("falcon_genome_tpu")

# Shard-boundary analysis padding (GATK interval padding): covers the
# active-region pad + smoothing window + one read length, so a site near
# a shard edge sees the same pileup it would mid-shard.  Emission stays
# inside the unpadded shard — each site is emitted by exactly one shard.
SHARD_PAD = 400


def _vcf_header(fa, samples: list[str]) -> VcfHeader:
    return VcfHeader(
        contigs=[(c.name, c.length) for c in fa.dict],
        samples=samples, meta=list(STANDARD_META))


def _user_intervals(conf: Config, intervals: str | None, fa):
    if not intervals:
        return None
    return read_interval_list(intervals, fa.dict)


def _write_part(path: str, header: VcfHeader, recs) -> str:
    """Atomic per-shard VCF write (tmp + rename): a crashed task never
    leaves a half-written part that resume would trust."""
    tmp = str(path) + ".tmp"
    write_vcf(tmp, header, recs)
    os.replace(tmp, path)
    return str(path)


def _shard_plan(conf: Config, fa, intervals: str | None
                ) -> list[list[Interval]]:
    shards = interval_shards(conf, fa)
    user = _user_intervals(conf, intervals, fa)
    if user is None:
        return shards
    # -L <user> -L <shard> -isr INTERSECTION (HTCWorker.cpp:64-68)
    return [intersect_intervals(s, user) for s in shards]


def _htc_params_with_extras(emit_gvcf: bool, sample: str,
                            xo: ExtraOpts,
                            device: torch.device) -> HTCParams:
    """Apply --extra-options overrides (reference override-wins semantics:
    Worker.h:38-58, pinned by extra-opts-check.bats)."""
    erc = xo.get("-ERC", "--emitRefConfidence", "--emit-ref-confidence")
    if erc is not None:
        emit_gvcf = erc.upper() != "NONE"
    p = HTCParams(emit_gvcf=emit_gvcf, sample=sample, device=device)
    p.min_call_qual = xo.get_float(
        "-stand_call_conf",
        "--standard_min_confidence_threshold_for_calling",
        "--standard-min-confidence-threshold-for-calling",
        default=p.min_call_qual)
    p.min_mapq = xo.get_int(
        "-mmq", "--min_mapping_quality_score",
        "--minimum-mapping-quality", default=p.min_mapq)
    p.max_reads_per_region = xo.get_int(
        "--maxReadsInRegionPerSample", "--max-reads-per-alignment-start",
        default=p.max_reads_per_region)
    p.gcp = xo.get_int("--gcpHMM", "--gcp-hmm", default=p.gcp)
    sn = xo.get("--sample_name", "-sn")
    if sn:
        p.sample = sn
    # GATK-side indexing knobs: output is always indexed here
    xo.has("--variant_index_type", "--variant_index_parameter")
    xo.warn_unused("htc")
    return p


def run_htc(conf: Config, ref: str, input_path: str, output: str,
            produce_vcf: bool = False, intervals: str | None = None,
            sample: str = "SAMPLE", force: bool = False,
            extra_opts: list[str] | None = None,
            device: torch.device = torch.device("cpu")) -> str:
    """HaplotypeCaller scatter → per-shard gVCF parts → merged vcf.gz."""
    emit_gvcf = not produce_vcf or str(output).endswith(
        (".g.vcf", ".g.vcf.gz", ".gvcf", ".gvcf.gz"))
    output = check_output(output, force)
    fa = load_fasta(ref)
    src = BamInputSource.from_conf(conf, input_path)
    shards = _shard_plan(conf, fa, intervals)
    params = _htc_params_with_extras(emit_gvcf, sample,
                                     ExtraOpts(extra_opts), device)
    emit_gvcf = params.emit_gvcf
    sample = params.sample
    hc = HaplotypeCaller(params)
    vcf_header = _vcf_header(fa, [sample])
    part_dir = Path(output).parent / (Path(output).name + ".parts")
    part_dir.mkdir(parents=True, exist_ok=True)
    ext = "gvcf" if emit_gvcf else "vcf"
    part_paths = [get_contig_fname(part_dir, i, ext)
                  for i in range(len(shards))]

    def one(shard, idx):
        recs = []
        for iv in shard:
            contig_codes = fa.contig_codes(iv.contig)
            # boundary padding (GATK interval padding): analyze ±PAD so
            # activity smoothing and read evidence are complete at the
            # shard edges; emit only sites inside the unpadded interval
            pad = SHARD_PAD
            a0 = max(0, iv.start - 1 - pad)
            a1 = min(len(contig_codes), iv.end + pad)
            sub = src.records_for(
                [Interval(iv.contig, a0 + 1, a1)])
            recs.extend(hc.call_interval(
                sub, contig_codes, iv.contig, a0, a1,
                emit_start=iv.start - 1, emit_end=iv.end))
        return _write_part(part_paths[idx], vcf_header, recs)

    runner = PipelineRunner.from_conf("Haplotype Caller", conf,
                                      force=force)
    tasks = [(lambda s=s, i=i: one(s, i)) for i, s in enumerate(shards)]
    (parts,) = runner.run([stage(
        "HaplotypeCaller", tasks, outputs=part_paths,
        nprocs=conf.get("gatk.htc.nprocs"))]).values()
    # multi-process: every process computed its task slice (runner
    # round-robin); only the primary gathers the shared-FS parts
    if is_primary():
        concat_vcfs(parts, output, sort=False)  # shards in genome order
    sync_processes("htc:gather")
    log.info("htc → %s", output)
    return output
