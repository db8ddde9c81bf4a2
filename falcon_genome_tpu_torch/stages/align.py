"""``align`` stage: FASTQ → coordinate-sorted (optionally bucketed) BAM.

Port of ``falcon_genome_tpu/stages/align.py`` for short reads (the
long-read ``--long-reads`` path is not ported yet).  Mirrors the
reference's align driver (src/worker-align.cpp:19-255): per sample
(sample-sheet loop), per read-group alignment, bucketed sorted output with
``part-%06d.bam`` naming, then merge.  Compute is the in-repo aligner
engine (minimizer seeding on the host, Smith-Waterman on the device).

Record emission is columnar end-to-end: alignments become RecordColumns,
sorting is a lexsort permutation, and the native encoder writes BAM bytes
with the permutation applied on the fly.  Above ``tpu.align.spill_mb`` of
FASTQ each batch's records are appended to per-bucket spill files and
finalization sorts one bucket at a time, so peak RSS is one batch + one
bucket.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from falcon_genome_tpu.config import Config
from falcon_genome_tpu.io import native_ext
from falcon_genome_tpu.io.bam import BamColumnsWriter, write_bam_columns
from falcon_genome_tpu.io.columns import F_FLAG, F_POS, F_TID, RecordColumns
from falcon_genome_tpu.io.fastq import FastqReader
from falcon_genome_tpu.io.sam import FLAG_UNMAPPED
from falcon_genome_tpu.samples import SampleDetails, load_sample_sheet
from falcon_genome_tpu.utils.common import (
    check_input, check_output, get_bucket_fname)
from falcon_genome_tpu.utils.errors import InvalidParam, MissingParam
from falcon_genome_tpu.utils.extraopts import ExtraOpts

from ..aligner import AlignerEngine, AlignerParams, alignments_to_columns
from ..parallel import coordinate_order
from ..pipeline.runner import PipelineRunner, stage
from .common import header_from_fasta, load_fasta, load_index

log = logging.getLogger("falcon_genome_tpu")


def _bucket_ids(cols: RecordColumns, offs: np.ndarray, total: int,
                per: int, nb: int) -> np.ndarray:
    tid = cols.fixed[:, F_TID].astype(np.int64)
    pos = cols.fixed[:, F_POS].astype(np.int64)
    unmapped = (cols.fixed[:, F_FLAG] & FLAG_UNMAPPED) != 0
    gpos = np.where(unmapped, total,
                    offs[np.maximum(tid, 0)] + np.maximum(pos, 0))
    return np.minimum(gpos // per, nb - 1).astype(np.int64)


class AlignSink:
    """Collects aligned RecordColumns batches for one sample.

    ``spill=False``: batches accumulate in RAM (small inputs).
    ``spill=True``: each batch is bucket-partitioned by genome position
    and its native-encoded record bytes are appended to per-bucket spill
    files (uncompressed BAM record stream — re-readable by the native
    scan).  Buckets then sort independently at finalize.
    """

    def __init__(self, fa, nb: int, spill: bool, temp_dir: str):
        self.fa = fa
        self.nb = max(1, nb)
        self.spill = spill and native_ext.available()
        self.parts: list[RecordColumns] = []
        self.n_records = 0
        if self.spill:
            if temp_dir:
                os.makedirs(temp_dir, exist_ok=True)
            self.dir = Path(tempfile.mkdtemp(prefix="align-buckets-",
                                             dir=temp_dir or None))
            self.files = [None] * self.nb
        total = fa.dict.total_length()
        self.total = total
        self.per = (total + self.nb - 1) // self.nb
        self.offs = np.zeros(len(fa.dict.contigs) + 1, np.int64)
        np.cumsum([c.length for c in fa.dict.contigs], out=self.offs[1:])

    def add(self, cols: RecordColumns) -> None:
        self.n_records += len(cols)
        if not self.spill:
            self.parts.append(cols)
            return
        bids = _bucket_ids(cols, self.offs, self.total, self.per, self.nb)
        order = np.argsort(bids, kind="stable")
        body = cols.encode(order)
        sizes = cols.record_sizes()[order]
        bounds = np.zeros(len(cols) + 1, np.int64)
        np.cumsum(sizes, out=bounds[1:])
        bids_sorted = bids[order]
        splits = np.searchsorted(bids_sorted, np.arange(self.nb + 1))
        raw = body.tobytes()
        for bi in range(self.nb):
            lo, hi = int(splits[bi]), int(splits[bi + 1])
            if lo == hi:
                continue
            if self.files[bi] is None:
                self.files[bi] = open(self.dir / f"bucket-{bi:06d}", "ab")
            self.files[bi].write(raw[bounds[lo]:bounds[hi]])

    def bucket_columns(self, bi: int) -> RecordColumns | None:
        """Sorted columns of one spill bucket (None if empty)."""
        f = self.files[bi]
        if f is None:
            return None
        f.close()
        blob = (self.dir / f"bucket-{bi:06d}").read_bytes()
        cols = RecordColumns.from_scan(blob)
        return cols.take(coordinate_order(cols))

    def cleanup(self) -> None:
        if self.spill:
            for f in self.files:
                if f is not None and not f.closed:
                    f.close()
            shutil.rmtree(self.dir, ignore_errors=True)


def _align_read_group(engine, det: SampleDetails,
                      batch_size: int, sink: AlignSink) -> int:
    reader = FastqReader(check_input(det.fastq1),
                         check_input(det.fastq2) if det.fastq2 else None,
                         batch_size=batch_size)
    n = 0
    if det.fastq2:
        # paired reads (the hot path): the engine's dispatch/collect split
        # pipelines WITHOUT threads — while the device computes batch N,
        # this thread decodes + seeds batch N+1 and emits batch N-1's
        # columns.
        pending = None            # (b1, b2, handle)
        for b1, b2 in reader:
            n += len(b1.lengths) + len(b2.lengths)
            h = engine.align_pair_dispatch(b1.codes, b1.lengths,
                                           b2.codes, b2.lengths)
            if pending is not None:
                p1, p2, ph = pending
                ab1, ab2 = engine.align_pair_collect(ph)
                pending = (b1, b2, h)
                sink.add(alignments_to_columns(
                    p1, ab1, p2, ab2, params=engine.params,
                    read_group=det.read_group))
            else:
                pending = (b1, b2, h)
        if pending is not None:
            p1, p2, ph = pending
            ab1, ab2 = engine.align_pair_collect(ph)
            sink.add(alignments_to_columns(
                p1, ab1, p2, ab2, params=engine.params,
                read_group=det.read_group))
        return n

    # single-end: batch N+1's device work runs in a worker thread while
    # this thread builds batch N's record columns
    def emit(b1, res1):
        sink.add(alignments_to_columns(b1, res1, read_group=det.read_group))

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None            # (b1, future)
        for b1, _ in reader:
            n += len(b1.lengths)
            fut = pool.submit(engine.align_batch, b1.codes, b1.lengths)
            if pending is not None:
                p1, pf = pending
                pending = (b1, fut)
                emit(p1, pf.result())
            else:
                pending = (b1, fut)
        if pending is not None:
            p1, pf = pending
            emit(p1, pf.result())
    return n


def _finalize_sample(sink: AlignSink, header, out_path: str,
                     num_buckets: int, merge: bool) -> None:
    """Write the sample's sorted BAM (and/or part-%06d bucket files)."""
    nb = num_buckets or 0
    if not sink.spill:
        cols = RecordColumns.concat(sink.parts)
        order = coordinate_order(cols)
        if nb > 1:
            bucket_dir = Path(out_path).with_suffix("")
            bucket_dir.mkdir(parents=True, exist_ok=True)
            bids = _bucket_ids(cols, sink.offs, sink.total,
                               (sink.total + nb - 1) // nb, nb)
            bid_sorted = bids[order]
            splits = np.searchsorted(np.sort(bid_sorted, kind="stable"),
                                     np.arange(nb + 1))
            order_by_bucket = order[np.argsort(bid_sorted, kind="stable")]
            for bi in range(nb):
                lo, hi = int(splits[bi]), int(splits[bi + 1])
                if lo == hi:
                    continue
                write_bam_columns(get_bucket_fname(bucket_dir, bi), header,
                                  cols, order=order_by_bucket[lo:hi])
        if merge or nb <= 1:
            write_bam_columns(out_path, header, cols, order=order)
        return

    # spill mode: buckets sort independently; stream into the merged BAM
    bucket_dir = Path(out_path).with_suffix("")
    if nb > 1:
        bucket_dir.mkdir(parents=True, exist_ok=True)
    writer = BamColumnsWriter(out_path, header) if (merge or nb <= 1) \
        else None
    try:
        for bi in range(sink.nb):
            cols = sink.bucket_columns(bi)
            if cols is None:
                continue
            if nb > 1:
                write_bam_columns(get_bucket_fname(bucket_dir, bi), header,
                                  cols)
            if writer is not None:
                writer.write_columns(cols)
    finally:
        if writer is not None:
            writer.close()
        sink.cleanup()


def _parse_rg_line(line: str) -> dict[str, str]:
    """bwa-style ``-R '@RG\\tID:x\\tSM:y…'`` → tag dict (accepts literal
    backslash-t or real tabs)."""
    out: dict[str, str] = {}
    for fld in line.replace("\\t", "\t").split("\t"):
        if ":" in fld and not fld.startswith("@"):
            k, v = fld.split(":", 1)
            out[k] = v
    return out


def run_align(conf: Config, ref: str, output: str,
              fastq1: str | None = None, fastq2: str | None = None,
              sample_sheet: str | None = None,
              sample_id: str = "sample", read_group: str = "rg0",
              platform: str = "illumina", library: str = "lib0",
              num_buckets: int | None = None, merge: bool = True,
              long_reads: bool = False, force: bool = False,
              extra_opts: list[str] | None = None,
              device: torch.device = torch.device("cpu")) -> list[str]:
    """Returns the list of written BAM paths (one per sample)."""
    if long_reads:
        raise InvalidParam("--long-reads: not yet ported")
    xo = ExtraOpts(extra_opts)
    # bwa-flow surface (BWAWorker.cpp:134-147): --chunk_size batches the
    # offload, --num_buckets overrides the bucket-spill width, -R sets
    # the @RG header line
    chunk_override = xo.get_int("--chunk_size", "--chunk-size")
    num_buckets = num_buckets or xo.get_int("--num_buckets",
                                            "--num-buckets", default=0)
    rg_tags = _parse_rg_line(xo.get("-R", default="") or "")
    if rg_tags:
        read_group = rg_tags.get("ID", read_group)
        library = rg_tags.get("LB", library)
        platform = rg_tags.get("PL", platform)
        if not sample_sheet:
            sample_id = rg_tags.get("SM", sample_id)
    xo.warn_unused("align")
    fa = load_fasta(ref)
    engine = AlignerEngine(load_index(ref), AlignerParams(), device=device)
    batch_size = chunk_override or conf.get("tpu.batch.reads")

    if sample_sheet:
        sheet = load_sample_sheet(sample_sheet)
    else:
        if not fastq1:
            raise MissingParam("fastq1")
        sheet = {sample_id: [SampleDetails(fastq1, fastq2 or "",
                                           read_group, platform, library)]}

    spill_bytes = conf.get("tpu.align.spill_mb") << 20
    outputs: list[str] = []
    multi = len(sheet) > 1
    for sid, details in sheet.items():
        out_path = str(Path(output) / f"{sid}.bam") if multi else output
        out_path = check_output(out_path, force)
        rgs = [{"ID": d.read_group, "SM": sid, "PL": d.platform_id,
                "LB": d.library_id} for d in details]
        header = header_from_fasta(fa, read_groups=rgs)

        fastq_bytes = sum(
            Path(p).stat().st_size
            for d in details for p in (d.fastq1, d.fastq2)
            if p and Path(p).exists())
        spill = fastq_bytes > spill_bytes
        nb_spill = (num_buckets or conf.get("bwa.num_buckets")) if spill \
            else (num_buckets or 1)
        sink = AlignSink(fa, nb_spill, spill, conf.get("temp_dir"))
        if sink.spill:
            log.info("align[%s]: bucket-spill dataflow (%d buckets, "
                     "%.1f GB FASTQ)", sid, sink.nb, fastq_bytes / 1e9)

        runner = PipelineRunner.from_conf(f"align[{sid}]", conf, force=True)
        align_stage = stage(
            "bwa mem alignment",
            [(lambda d=d: _align_read_group(engine, d, batch_size, sink))
             for d in details],
            nprocs=1)  # engine batches internally; one RG at a time
        runner.run([align_stage])
        _finalize_sample(sink, header, out_path, num_buckets or 0, merge)
        if merge or (num_buckets or 0) <= 1:
            outputs.append(out_path)
        log.info("align[%s]: %d records → %s", sid, sink.n_records,
                 out_path)
    return outputs
