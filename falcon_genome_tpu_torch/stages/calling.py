"""Caller stages: ``htc`` (HaplotypeCaller), ``mutect2``, ``ug``.

Port of ``falcon_genome_tpu/stages/calling.py``.  Mirrors the reference
drivers: per-contig-shard caller scatter over the gatk.ncontigs interval
plan, per-shard ``part-%06d.gvcf``/``.vcf`` outputs, then concat → bgzip
(src/worker-htc.cpp:19-181, worker-mutect2.cpp:17-277,
worker-ug.cpp:16-160).  ``htc`` and ``mutect2`` run their device batches
on ``device``; ``ug`` is host code.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path

import torch

from ..config import Config
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.intervals import (
    Interval, intersect_intervals, read_interval_list)
from ..io.vcf import (
    STANDARD_META, VcfHeader, concat_vcfs, write_vcf)
from ..utils.common import check_output, get_contig_fname
from ..utils.extraopts import ExtraOpts

from ..models.haplotypecaller import HaplotypeCaller, HTCParams
from ..models.mutect2 import (
    Mutect2, Mutect2Params, SomaticResources, annotate_resources,
    filter_mutect_calls)
from ..models.ug import UGParams, call_pileup
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
            device: torch.device = DEFAULT_DEVICE) -> str:
    """HaplotypeCaller scatter → per-shard gVCF parts → merged vcf.gz."""
    device = resolve_device(device)
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


def run_mutect2(conf: Config, ref: str, tumor_path: str, output: str,
                normal_path: str | None = None,
                intervals: str | None = None,
                run_filter: bool = True, force: bool = False,
                tumor_name: str = "TUMOR", normal_name: str = "NORMAL",
                dbsnp: list[str] | None = None,
                cosmic: list[str] | None = None,
                germline: str | None = None,
                panels_of_normals: str | None = None,
                contamination_table: str | None = None,
                extra_opts: list[str] | None = None,
                device: torch.device = DEFAULT_DEVICE) -> str:
    """Mutect2 scatter → per-shard VCF parts (annotated against the
    resources, filtered unless ``run_filter`` is off) → merged VCF."""
    device = resolve_device(device)
    output = check_output(output, force)
    fa = load_fasta(ref)
    t_src = BamInputSource.from_conf(conf, tumor_path)
    n_src = (BamInputSource.from_conf(conf, normal_path)
             if normal_path else None)
    shards = _shard_plan(conf, fa, intervals)
    xo = ExtraOpts(extra_opts)
    params = Mutect2Params(tumor_sample=tumor_name,
                           normal_sample=normal_name, device=device)
    params.tlod_threshold = xo.get_float(
        "--tumor_lod", "-tumor-lod-to-emit", "--tumor-lod-to-emit",
        default=params.tlod_threshold)
    params.nlod_threshold = xo.get_float(
        "--normal_lod", "--normal-lod", default=params.nlod_threshold)
    params.min_mapq = xo.get_int(
        "-mmq", "--min_mapping_quality_score",
        "--minimum-mapping-quality", default=params.min_mapq)
    xo.warn_unused("mutect2")
    # resource surface (Mutect2Worker.cpp:124-168, filter :66-68)
    res = SomaticResources.load(
        pon=panels_of_normals, germline=germline, dbsnp=dbsnp,
        cosmic=cosmic, contamination_table=contamination_table)
    m2 = Mutect2(params)
    samples = [tumor_name] + ([normal_name] if normal_path else [])
    vcf_header = _vcf_header(fa, samples)
    vcf_header.meta.append(
        '##INFO=<ID=TLOD,Number=A,Type=Float,Description='
        '"Tumor log-odds of variant">')
    vcf_header.meta.append(
        '##INFO=<ID=NLOD,Number=A,Type=Float,Description='
        '"Normal log-odds of being reference">')
    if res.pon:
        vcf_header.meta.append(
            '##INFO=<ID=PON,Number=0,Type=Flag,Description='
            '"site found in panel of normals">')
    if res.germline:
        vcf_header.meta.append(
            '##INFO=<ID=POPAF,Number=A,Type=Float,Description='
            '"negative log10 population allele frequency">')
    part_dir = Path(output).parent / (Path(output).name + ".parts")
    part_dir.mkdir(parents=True, exist_ok=True)
    part_paths = [get_contig_fname(part_dir, i, "vcf")
                  for i in range(len(shards))]

    def one(shard, idx):
        recs = []
        for iv in shard:
            codes = fa.contig_codes(iv.contig)
            a0 = max(0, iv.start - 1 - SHARD_PAD)
            a1 = min(len(codes), iv.end + SHARD_PAD)
            piv = Interval(iv.contig, a0 + 1, a1)
            t_sub = t_src.records_for([piv])
            n_sub = n_src.records_for([piv]) if n_src is not None else None
            iv_recs = m2.call_interval(
                t_sub, n_sub, codes, iv.contig, a0, a1,
                emit_start=iv.start - 1, emit_end=iv.end)
            recs.extend(annotate_resources(
                iv_recs, iv.contig, iv.start - 1, iv.end, res))
        if run_filter:
            recs = filter_mutect_calls(
                recs, contamination=res.contamination)
        return _write_part(part_paths[idx], vcf_header, recs)

    runner = PipelineRunner.from_conf("Mutect2", conf, force=force)
    tasks = [(lambda s=s, i=i: one(s, i)) for i, s in enumerate(shards)]
    (parts,) = runner.run([stage(
        "Mutect2", tasks, outputs=part_paths,
        nprocs=conf.get("gatk.mutect2.nprocs"))]).values()
    if is_primary():
        concat_vcfs(parts, output, sort=False)
    sync_processes("mutect2:gather")
    log.info("mutect2 → %s", output)
    return output


def run_ug(conf: Config, ref: str, input_path: str, output: str,
           intervals: str | None = None, sample: str = "SAMPLE",
           force: bool = False,
           extra_opts: list[str] | None = None) -> str:
    output = check_output(output, force)
    fa = load_fasta(ref)
    src = BamInputSource.from_conf(conf, input_path)
    shards = _shard_plan(conf, fa, intervals)
    xo = ExtraOpts(extra_opts)
    ug_params = UGParams()
    ug_params.min_call_qual = xo.get_float(
        "-stand_call_conf",
        "--standard_min_confidence_threshold_for_calling",
        default=ug_params.min_call_qual)
    ug_params.min_base_qual = xo.get_int(
        "-mbq", "--min_base_quality_score", default=ug_params.min_base_qual)
    ug_params.min_mapq = xo.get_int(
        "-mmq", "--min_mapping_quality_score", default=ug_params.min_mapq)
    xo.warn_unused("ug")
    vcf_header = _vcf_header(fa, [sample])
    part_dir = Path(output).parent / (Path(output).name + ".parts")
    part_dir.mkdir(parents=True, exist_ok=True)
    part_paths = [get_contig_fname(part_dir, i, "vcf")
                  for i in range(len(shards))]

    def one(shard, idx):
        recs = []
        for iv in shard:
            codes = fa.contig_codes(iv.contig)
            sub = src.records_for([iv])
            recs.extend(call_pileup(sub, codes, iv.contig,
                                    iv.start - 1, iv.end, ug_params))
        return _write_part(part_paths[idx], vcf_header, recs)

    runner = PipelineRunner.from_conf("Unified Genotyper", conf,
                                      force=force)
    tasks = [(lambda s=s, i=i: one(s, i)) for i, s in enumerate(shards)]
    (parts,) = runner.run([stage(
        "UnifiedGenotyper", tasks, outputs=part_paths,
        nprocs=conf.get("gatk.ug.nprocs"))]).values()
    if is_primary():
        concat_vcfs(parts, output, sort=False)
    sync_processes("ug:gather")
    log.info("ug → %s", output)
    return output
