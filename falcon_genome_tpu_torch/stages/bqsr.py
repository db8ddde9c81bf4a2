"""``baserecal`` / ``printreads`` / ``bqsr`` stages.

Mirrors src/worker-bqsr.cpp: baserecal = per-shard BaseRecalibrator scatter
+ table gather (BQSRWorker ×ncontigs → BQSRGatherWorker, :19-79);
printreads = per-shard ApplyBQSR emitting ``part-%06d.bam`` shards
(PRWorker, :90-143); bqsr chains both (:352-363).  The per-shard tables
merge by addition.

The data plane is columnar: shard columns come from the shared decode or
the ``.bai`` stream (BamInputSource), covariates extract vectorized
(bqsr.extract_covariates_columns), and ApplyBQSR rewrites the qual blob in
one vectorized remap — no per-record/per-base Python in the hot path.

Port of ``falcon_genome_tpu/stages/bqsr.py``: host code, single process.
"""
from __future__ import annotations

import logging
from pathlib import Path

from falcon_genome_tpu.config import Config
from falcon_genome_tpu.io.bam import write_bam_columns
from falcon_genome_tpu.utils.common import (
    check_input, check_output, check_vcf_index, get_contig_fname)

from ..bqsr import (
    RecalModel, RecalTable, apply_bqsr_columns, baserecal_shard_table,
    write_gatk_report)
from ..parallel import coordinate_order, is_primary, sync_processes
from ..pipeline.runner import PipelineRunner, stage
from .bamstages import BamInputSource
from .common import interval_shards, load_fasta

log = logging.getLogger("falcon_genome_tpu")


class KnownSites:
    """Per-shard streamed known-sites masks.

    The reference streams ``-knownSites`` inside GATK per contig
    (BQSRWorker.cpp:43-53) — whole-file parsing of human dbSNP (~150M
    sites) into Python objects is tens of GB.  Here every input is
    bgzip+tabix'd once (streaming, ``ensure_indexed_vcf``) and each
    shard pulls only its own region as numpy position arrays: memory is
    O(shard), independent of the known-sites file size."""

    def __init__(self, paths: list[str], header, work_dir: str):
        self.header = header
        self.paths: list[str] = []
        for p in paths or []:
            # index freshness check (ref BQSRWorker.cpp:50-53 +
            # config.cpp:776-824); strict for .gz (the .tbi is needed
            # to stream), advisory for plain .vcf (re-indexed below)
            check_vcf_index(p, strict=str(p).endswith(".gz"))
            from falcon_genome_tpu.io.vcf import ensure_indexed_vcf
            self.paths.append(ensure_indexed_vcf(check_input(p), work_dir))

    def __bool__(self) -> bool:
        return bool(self.paths)

    def for_shard(self, shard) -> dict[int, "np.ndarray"]:
        """{tid: sorted per-base 0-based positions} for the shard."""
        import numpy as np

        from falcon_genome_tpu.io.tabix import query_vcf_positions
        out: dict[int, list] = {}
        for iv in shard:
            tid = self.header.tid(iv.contig)
            if tid < 0:
                continue
            for p in self.paths:
                pos0, lens = query_vcf_positions(
                    p, iv.contig, iv.start, iv.end)
                if len(pos0) == 0:
                    continue
                total = int(lens.sum())
                base = np.cumsum(lens) - lens
                per_base = (np.repeat(pos0, lens)
                            + np.arange(total)
                            - np.repeat(base, lens))
                out.setdefault(tid, []).append(per_base)
        return {t: np.unique(np.concatenate(parts))
                for t, parts in out.items()}


def run_baserecal(conf: Config, ref: str, input_path: str, output: str,
                  known_sites: list[str] | None = None,
                  force: bool = False,
                  extra_opts: list[str] | None = None) -> str:
    """Scatter + gather the recalibration table; writes <output>.npz."""
    from falcon_genome_tpu.utils.extraopts import ExtraOpts
    xo = ExtraOpts(extra_opts)
    # GATK BaseRecalibrator accepts repeated -knownSites through
    # --extra-options too (Worker.h:38-58 forwards every key verbatim)
    known_sites = list(known_sites or []) + xo.get_all(
        "-knownSites", "--knownSites", "--known-sites")
    xo.warn_unused("baserecal")
    output = check_output(output, force)
    fa = load_fasta(ref)
    src = BamInputSource.from_conf(conf, input_path)
    header = src.header
    ref_by_tid = {i: fa.contig_codes(name)
                  for i, (name, _) in enumerate(header.contigs)
                  if name in fa.dict.by_name}
    rgs = [rg["ID"] for rg in header.read_groups] or ["default"]
    rg_index = {rg: i for i, rg in enumerate(rgs)}
    ks = KnownSites(known_sites or [], header,
                    str(Path(output).parent / ".known_sites_idx"))

    shards = [s for s in interval_shards(conf, fa) if s]
    runner = PipelineRunner.from_conf("Base Recalibration", conf,
                                      force=force)
    # per-shard recal tables persist (part-%06d.recal.npz) so a killed
    # scatter resumes at shard granularity — the reference's per-contig
    # BQSRWorker artifacts gathered by a separate worker
    # (src/workers/BQSRWorker.cpp:111-150)
    parts_dir = Path(str(output) + ".parts")
    parts_dir.mkdir(parents=True, exist_ok=True)
    part_paths = [str(parts_dir / f"part-{i:06d}.recal.npz")
                  for i in range(len(shards))]

    def one(shard, path):
        # per-shard tabix stream of the known-sites mask: O(shard)
        # memory at dbSNP scale (BQSRWorker.cpp:43-53 semantics)
        known = ks.for_shard(shard) if ks else None
        t = baserecal_shard_table(src.columns_for(shard), ref_by_tid,
                                  known, rg_index, rgs)
        t.save(path + ".tmp.npz")
        import os
        os.replace(path + ".tmp.npz", path)
        return path

    tasks = [(lambda s=s, p=p: one(s, p))
             for s, p in zip(shards, part_paths)]
    (results,) = runner.run([stage(
        "BaseRecalibrator", tasks, outputs=part_paths,
        nprocs=conf.get("gatk.bqsr.nprocs"))]).values()
    if not is_primary():
        # peers computed their task slice; the primary gathers/writes
        sync_processes("baserecal:gather")
        return output
    total = None
    for p in results:
        t = RecalTable.load(p)
        total = t if total is None else total + t  # gather = addition
    import os
    import shutil
    if str(output).endswith(".npz"):
        total.save(str(output) + ".tmp.npz")
        os.replace(str(output) + ".tmp.npz", output)
    else:
        # the reference's interchange format: a GATK recalibration report
        # (BQSRGatherWorker merges these; any GATK-era tool can read it);
        # an .npz sidecar keeps reloads fast.  tmp+rename so a killed run
        # never leaves a half-written table behind (resume treats an
        # existing table as complete)
        write_gatk_report(total, str(output) + ".tmp")
        os.replace(str(output) + ".tmp", output)
        total.save(str(output) + ".tmp.npz")
        os.replace(str(output) + ".tmp.npz", str(output) + ".npz")
    shutil.rmtree(parts_dir, ignore_errors=True)   # gathered → done
    sync_processes("baserecal:gather")
    log.info("baserecal: %d observations → %s",
             int(total.qual_obs.sum()), output)
    return output


def run_printreads(conf: Config, ref: str, input_path: str, table: str,
                   output: str, force: bool = False,
                   extra_opts: list[str] | None = None) -> str:
    """ApplyBQSR per shard → bucketed BAM shards, or one merged BAM."""
    from falcon_genome_tpu.utils.extraopts import ExtraOpts
    xo = ExtraOpts(extra_opts)
    preserve_below = xo.get_int(
        "-preserveQ", "--preserve_qscores_less_than",
        "--preserve-qscores-less-than")
    xo.warn_unused("printreads")
    output = check_output(output, force)
    fa = load_fasta(ref)
    src = BamInputSource.from_conf(conf, input_path)
    header = src.header
    rtable = RecalTable.load(check_input(
        table if Path(table).exists() else table + ".npz"))
    model = RecalModel.fit(rtable)
    rg_index = {rg: i for i, rg in enumerate(rtable.read_groups)}

    shards = interval_shards(conf, fa)
    out_is_dir = Path(output).suffix != ".bam"
    runner = PipelineRunner.from_conf("Print Reads", conf, force=force)
    # single-.bam output goes through the same per-shard part files
    # (in a sibling work dir) and then STREAMS them shard-by-shard into
    # one BAM — peak memory is one shard, never the whole genome
    parts_root = (Path(output) if out_is_dir
                  else Path(str(output) + ".parts"))
    part_paths = [get_contig_fname(str(parts_root), i, "bam")
                  for i in range(len(shards))]

    def one(shard, idx):
        # by_start: a partition — boundary-spanning reads are emitted by
        # exactly one shard (output record count == input record count)
        cols = apply_bqsr_columns(src.columns_for(shard, by_start=True),
                                  model, rg_index,
                                  preserve_below=preserve_below)
        import os
        parts_root.mkdir(parents=True, exist_ok=True)
        path = part_paths[idx]
        tmp = path + ".tmp.bam"
        write_bam_columns(tmp, header, cols, order=coordinate_order(cols))
        if Path(tmp + ".bai").exists():
            os.replace(tmp + ".bai", path + ".bai")
        os.replace(tmp, path)
        if out_is_dir:
            # sidecar .list with the shard's regions (PRWorker writes
            # .bed/.list shard metadata, BQSRWorker.cpp:180-228)
            from falcon_genome_tpu.io.intervals import write_interval_list
            write_interval_list(get_contig_fname(output, idx, "list"),
                                shard)
        return path

    tasks = [(lambda s=s, i=i: one(s, i)) for i, s in enumerate(shards)]
    (results,) = runner.run([stage(
        "PrintReads", tasks, outputs=part_paths,
        nprocs=conf.get("gatk.pr.nprocs"))]).values()
    if not out_is_dir and is_primary():
        import shutil

        from .bamstages import stream_merge_sorted_parts
        next_keys = [
            (header.tid(shards[i + 1][0].contig),
             shards[i + 1][0].start - 1) if i + 1 < len(shards) else None
            for i in range(len(shards))]
        stream_merge_sorted_parts(output, header, results, next_keys)
        shutil.rmtree(parts_root, ignore_errors=True)
    sync_processes("printreads:gather")
    log.info("printreads → %s", output)
    return output


def run_bqsr(conf: Config, ref: str, input_path: str, output: str,
             known_sites: list[str] | None = None,
             force: bool = False,
             extra_opts: list[str] | None = None) -> str:
    """baserecal + printreads chained (ref worker-bqsr.cpp:352-363).

    Resume: without ``-f`` an existing (atomically written) recal table
    from a previous killed run is reused and only printreads re-runs —
    each phase individually re-runnable (scripts/pipeline.sh:24-63)."""
    table = str(Path(output).with_suffix("")) + ".recal.npz"
    if not force and Path(table).exists():
        log.info("bqsr: resume — reusing recalibration table %s", table)
    else:
        # force=force (not True): a killed scatter's surviving
        # part-%06d.recal.npz tables are reused at shard granularity
        run_baserecal(conf, ref, input_path, table, known_sites,
                      force=force, extra_opts=extra_opts)
    return run_printreads(conf, ref, input_path, table, output, force,
                          extra_opts=extra_opts)
