"""``depth`` stage: DepthOfCoverage scatter + in-process reduce.

Mirrors src/worker-depth.cpp:16-148 — per-shard DepthWorker over the
interval plan (with optional geneList intersection, DepthWorker.cpp:46-91)
then DepthCombineWorker's in-process merge of per-shard tables keyed by
sample with vector ``operator+`` (DepthCombineWorker.cpp:80-160).

Output surface (GATK3 DepthOfCoverage analogs):
  <out>                                per-base coverage (omitBaseOutput)
  <out>.sample_summary                 per-sample mean/quartiles/%above
  <out>.sample_statistics              per-sample depth histogram
  <out>.sample_cumulative_coverage_counts / _proportions
  <out>.sample_interval_summary        per-interval coverage (omitIntervals)
  <out>.sample_gene_summary            per-gene coverage (geneList)

Samples come from the BAM's read groups (RG SM tags); a BAM without read
groups is one sample named by --sample-id.  The pileup itself is the
vectorized diff-array (no per-read Python; VERDICT round-1 item 3).

geneList format: one gene per line, ``name contig start end``
(whitespace-separated, 1-based inclusive) — a flat simplification of the
refseq table the reference forwards to GATK.

Port of ``falcon_genome_tpu/stages/depth.py`` (host code, no kernel).
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np

from ..config import Config
from ..io.intervals import Interval
from ..pipeline.runner import PipelineRunner, stage
from ..utils.common import check_input, check_output
from .bamstages import BamInputSource
from .calling import _shard_plan
from .common import load_fasta

log = logging.getLogger("falcon_genome_tpu")

MAX_DEPTH_BIN = 500


@dataclasses.dataclass
class Gene:
    name: str
    contig: str
    start: int   # 1-based inclusive
    end: int


def _parse_refseq_row(parts: list[str]) -> Gene | None:
    """One UCSC refseq/refFlat row → Gene, or None if not that shape.

    The reference forwards an operator's refseq-format gene table to
    GATK DepthOfCoverage verbatim (DepthWorker.cpp:61-66); GATK accepts
    the UCSC refGene table (bin, name, chrom, strand, txStart, txEnd, …,
    name2 at col 12) and refFlat (geneName, name, chrom, strand,
    txStart, txEnd, …).  txStart is 0-based half-open → 1-based."""
    if len(parts) >= 11 and parts[3] in ("+", "-"):
        # refGene: col 0 is the UCSC bin (integer), gene symbol at 12
        try:
            int(parts[0])
            name = parts[12] if len(parts) > 12 and parts[12] else parts[1]
            return Gene(name, parts[2], int(parts[4]) + 1, int(parts[5]))
        except ValueError:
            pass
    if len(parts) >= 6 and parts[3] in ("+", "-"):
        # refFlat: geneName, transcript, chrom, strand, txStart, txEnd
        return Gene(parts[0], parts[2], int(parts[4]) + 1, int(parts[5]))
    return None


def read_gene_list(path: str) -> list[Gene]:
    """Gene table: UCSC refseq/refFlat format (what the reference hands
    GATK) or the flat ``name contig start end`` form (1-based
    inclusive)."""
    genes = []
    for i, line in enumerate(Path(check_input(path)).read_text()
                             .splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        parts = line.split("\t") if "\t" in line else line.split()
        g = _parse_refseq_row(parts)
        if g is None:
            if len(parts) < 4:
                raise ValueError(
                    f"{path}:{i}: expected a refseq/refFlat row or "
                    f"'name contig start end', got {line!r}")
            g = Gene(parts[0], parts[1], int(parts[2]), int(parts[3]))
        genes.append(g)
    # multiple transcripts of one gene merge under the same name; the
    # per-gene reduction (gene_totals) already accumulates by name
    return genes


@dataclasses.dataclass
class DepthShardResult:
    """Per-shard coverage tables; merge = keyed vector addition
    (DepthCombineWorker.cpp:80-160)."""
    samples: list[str]
    histogram: dict[str, np.ndarray]       # sample -> depth counts
    total: dict[str, int]                  # sample -> sum of depths
    n_positions: int
    interval_rows: list[tuple]             # (contig, start, end, {s: tot})
    gene_totals: dict[str, dict[str, int]]  # gene -> sample -> total
    gene_lengths: dict[str, int]
    base_file: str | None = None           # per-shard base coverage part

    def __add__(self, other: "DepthShardResult") -> "DepthShardResult":
        samples = list(dict.fromkeys(self.samples + other.samples))
        hist = {s: (self.histogram.get(s, 0) + other.histogram.get(s, 0))
                for s in samples}
        total = {s: self.total.get(s, 0) + other.total.get(s, 0)
                 for s in samples}
        genes = dict(self.gene_totals)
        for g, m in other.gene_totals.items():
            cur = genes.setdefault(g, {})
            for s, v in m.items():
                cur[s] = cur.get(s, 0) + v
        glen = {**self.gene_lengths, **other.gene_lengths}
        for g, n in other.gene_lengths.items():
            if g in self.gene_lengths:
                glen[g] = self.gene_lengths[g] + n
        return DepthShardResult(
            samples, hist, total, self.n_positions + other.n_positions,
            self.interval_rows + other.interval_rows, genes, glen)


def _sample_of_records(cols, header, default: str) -> tuple[list[str],
                                                            np.ndarray]:
    """(samples, per-record sample index) from RG SM tags."""
    rg_to_sm = {rg.get("ID", ""): rg.get("SM", default)
                for rg in header.read_groups}
    samples = sorted(set(rg_to_sm.values())) or [default]
    if len(samples) <= 1:
        return ([samples[0] if samples else default],
                np.zeros(len(cols), np.int64))
    from ..io.columns import tag_string_values
    sm_index = {s: i for i, s in enumerate(samples)}
    vals = tag_string_values(cols, b"RG")
    idx = np.asarray(
        [sm_index.get(rg_to_sm.get(v or "", default), 0) for v in vals],
        np.int64)
    return samples, idx


def _interval_depths(src: BamInputSource, iv: Interval, header,
                     default_sample: str, min_mapq: int = 0
                     ) -> tuple[list[str], np.ndarray]:
    """(samples, (n_samples, len(iv)) coverage) — diff-array pileup."""
    from ..io.columns import F_ENDPOS, F_MAPQ, F_POS
    n = len(iv)
    cols = src.columns_for([iv])
    if min_mapq > 0:
        cols = cols.take(np.flatnonzero(
            cols.fixed[:, F_MAPQ] >= min_mapq))
    samples, sidx = _sample_of_records(cols, header, default_sample)
    f = cols.fixed
    base = iv.start - 1
    lo = np.clip(f[:, F_POS].astype(np.int64), base, iv.end) - base
    hi = np.clip(f[:, F_ENDPOS].astype(np.int64), base, iv.end) - base
    depth = np.zeros((len(samples), n + 1), np.int64)
    np.add.at(depth, (sidx, lo), 1)
    np.add.at(depth, (sidx, hi), -1)
    # GATK DepthOfCoverage excludes deletion/N-gap bases by default
    # (--includeDeletions off): subtract every D/N sub-span so an
    # aligned-span diff-array matches the per-base pileup semantics
    if cols.cigar_ops.size:
        from ..io.columns import expand_cigar_ops
        ops, lens, op_rec, _, roff = expand_cigar_ops(
            cols, np.arange(len(cols)))
        dn = (ops == 2) | (ops == 3)          # D, N
        if dn.any():
            rstart = (f[op_rec[dn], F_POS].astype(np.int64) + roff[dn])
            rend = rstart + lens[dn]
            lo_d = np.clip(rstart, base, iv.end) - base
            hi_d = np.clip(rend, base, iv.end) - base
            np.add.at(depth, (sidx[op_rec[dn]], lo_d), -1)
            np.add.at(depth, (sidx[op_rec[dn]], hi_d), 1)
    return samples, np.cumsum(depth[:, :-1], axis=1)


def _shard_depth(src: BamInputSource, shard: list[Interval], header,
                 default_sample: str, genes: list[Gene],
                 emit_base: str | None,
                 emit_intervals: bool,
                 min_mapq: int = 0) -> DepthShardResult:
    all_samples: list[str] = []
    hist: dict[str, np.ndarray] = {}
    total: dict[str, int] = {}
    npos = 0
    interval_rows: list[tuple] = []
    gene_totals: dict[str, dict[str, int]] = {}
    gene_lengths: dict[str, int] = {}
    base_f = open(emit_base, "w") if emit_base else None
    for iv in shard:
        samples, depth = _interval_depths(src, iv, header, default_sample,
                                          min_mapq=min_mapq)
        for s in samples:
            if s not in all_samples:
                all_samples.append(s)
        tot_per_pos = depth.sum(axis=0)
        npos += len(iv)
        for si, s in enumerate(samples):
            h = np.bincount(np.minimum(depth[si], MAX_DEPTH_BIN),
                            minlength=MAX_DEPTH_BIN + 1)
            hist[s] = hist.get(s, 0) + h
            total[s] = total.get(s, 0) + int(depth[si].sum())
        if emit_intervals:
            interval_rows.append((
                iv.contig, iv.start, iv.end,
                {s: int(depth[si].sum()) for si, s in enumerate(samples)}))
        for g in genes:
            if g.contig != iv.contig:
                continue
            lo = max(g.start, iv.start) - iv.start
            hi = min(g.end, iv.end) - iv.start + 1
            if lo >= hi:
                continue
            m = gene_totals.setdefault(g.name, {})
            for si, s in enumerate(samples):
                m[s] = m.get(s, 0) + int(depth[si, lo:hi].sum())
            gene_lengths[g.name] = gene_lengths.get(g.name, 0) + (hi - lo)
        if base_f is not None:
            nsam = max(1, len(samples))
            for off in range(len(iv)):
                t = int(tot_per_pos[off])
                cols_txt = "\t".join(str(int(depth[si, off]))
                                     for si in range(len(samples)))
                base_f.write(f"{iv.contig}:{iv.start + off}\t{t}\t"
                             f"{t / nsam:.2f}\t{cols_txt}\n")
    if base_f is not None:
        base_f.close()
    return DepthShardResult(all_samples, hist, total, npos, interval_rows,
                            gene_totals, gene_lengths, emit_base)


def _granular_quartiles(hist: np.ndarray) -> tuple[int, int, int]:
    """(Q1, median, Q3) of the per-position depth distribution."""
    c = np.cumsum(hist)
    n = c[-1]
    if n == 0:
        return 0, 0, 0
    return tuple(int(np.searchsorted(c, q * n, side="left"))
                 for q in (0.25, 0.5, 0.75))


def run_depth(conf: Config, ref: str, input_path: str, output: str,
              intervals: str | None = None, sample: str = "SAMPLE",
              gene_list: str | None = None,
              omit_base_output: bool = True,
              omit_intervals: bool = False,
              omit_sample_summary: bool = False,
              thresholds: tuple[int, ...] = (1, 10, 15, 30),
              force: bool = False,
              extra_opts: list[str] | None = None) -> str:
    from ..utils.extraopts import ExtraOpts
    xo = ExtraOpts(extra_opts)
    # GATK DepthOfCoverage surface forwarded by the reference's depth
    # worker (DepthWorker.cpp:46-91 passes --extra-options verbatim)
    ct = xo.get_all("-ct", "--summaryCoverageThreshold",
                    "--summary-coverage-threshold")
    if ct:
        thresholds = tuple(sorted(min(int(v), MAX_DEPTH_BIN) for v in ct))
    min_mapq = xo.get_int("-mmq", "--minMappingQuality",
                          "--min_mapping_quality_score", default=0)
    xo.warn_unused("depth")
    output = check_output(output, force)
    fa = load_fasta(ref)
    src = BamInputSource.from_conf(conf, input_path)
    header = src.header
    shards = _shard_plan(conf, fa, intervals)
    genes = read_gene_list(gene_list) if gene_list else []

    runner = PipelineRunner.from_conf("Depth of Coverage", conf,
                                      force=force)
    part_dir = Path(str(output) + ".parts")
    part_dir.mkdir(parents=True, exist_ok=True)
    base_dir = part_dir if not omit_base_output else None

    live = [(i, s) for i, s in enumerate(shards) if s]
    pkl_paths = [str(part_dir / f"part-{i:06d}.depth.pkl")
                 for i, _ in live]

    def one(s, idx, pkl):
        # per-shard result persisted atomically → kill-and-rerun reuses
        # completed shards (resume; the stage skips when all parts exist)
        import os
        import pickle
        emit_base = (str(base_dir / f"part-{idx:06d}.cov")
                     if base_dir is not None else None)
        res = _shard_depth(src, s, header, sample, genes, emit_base,
                           not omit_intervals, min_mapq=min_mapq)
        with open(pkl + ".tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(pkl + ".tmp", pkl)
        return pkl

    tasks = [(lambda s=s, i=i, p=p: one(s, i, p))
             for (i, s), p in zip(live, pkl_paths)]
    (parts,) = runner.run([stage(
        "DepthOfCoverage", tasks, outputs=pkl_paths,
        nprocs=conf.get("gatk.depth.nprocs"))]).values()

    import pickle
    loaded = []
    for p in parts:
        with open(p, "rb") as f:
            loaded.append(pickle.load(f))
    parts = loaded
    combined = parts[0]
    for p in parts[1:]:
        combined = combined + p  # DepthCombineWorker reduce

    samples = combined.samples or [sample]
    out = Path(output)

    if not omit_base_output:
        with open(out, "w") as f:
            f.write("Locus\tTotal_Depth\tAverage_Depth_sample\t"
                    + "\t".join(f"Depth_for_{s}" for s in samples) + "\n")
            for p in parts:
                if p.base_file and Path(p.base_file).exists():
                    f.write(Path(p.base_file).read_text())

    if not omit_sample_summary:
        with open(str(out) + ".sample_summary", "w") as f:
            cols = ["sample_id", "total", "mean",
                    "granular_third_quartile", "granular_median",
                    "granular_first_quartile"] + \
                [f"%_bases_above_{t}" for t in thresholds]
            f.write("\t".join(cols) + "\n")
            npos = max(1, combined.n_positions)
            for s in samples:
                h = np.asarray(combined.histogram.get(
                    s, np.zeros(MAX_DEPTH_BIN + 1)))
                q1, med, q3 = _granular_quartiles(h)
                cum = np.cumsum(h[::-1])[::-1]
                f.write("\t".join(
                    [s, str(combined.total.get(s, 0)),
                     f"{combined.total.get(s, 0) / npos:.2f}",
                     str(q3), str(med), str(q1)]
                    + [f"{100.0 * cum[t] / npos:.1f}"
                       for t in thresholds]) + "\n")

        with open(str(out) + ".sample_statistics", "w") as f:
            f.write("Source_of_reads\t" + "\t".join(
                f"depth_{d}" for d in range(MAX_DEPTH_BIN + 1)) + "\n")
            for s in samples:
                h = np.asarray(combined.histogram.get(
                    s, np.zeros(MAX_DEPTH_BIN + 1)), np.int64)
                f.write(f"sample_{s}\t" + "\t".join(map(str, h.tolist()))
                        + "\n")

        cum_rows = {}
        for s in samples:
            h = np.asarray(combined.histogram.get(
                s, np.zeros(MAX_DEPTH_BIN + 1)), np.int64)
            cum_rows[s] = np.cumsum(h[::-1])[::-1]  # ≥ depth counts
        with open(str(out) + ".sample_cumulative_coverage_counts",
                  "w") as f:
            f.write("Source_of_reads\t" + "\t".join(
                f"gte_{d}" for d in range(MAX_DEPTH_BIN + 1)) + "\n")
            for s in samples:
                f.write(f"sample_{s}\t" + "\t".join(
                    map(str, cum_rows[s].tolist())) + "\n")
        with open(str(out) + ".sample_cumulative_coverage_proportions",
                  "w") as f:
            f.write("Source_of_reads\t" + "\t".join(
                f"gte_{d}" for d in range(MAX_DEPTH_BIN + 1)) + "\n")
            for s in samples:
                mx = max(1, int(cum_rows[s].max()))
                vals = cum_rows[s] / mx
                vals = np.where(vals < 0.01, 0.0, vals)
                f.write(f"sample_{s}\t" + "\t".join(
                    f"{v:.2f}" for v in vals.tolist()) + "\n")

    if not omit_intervals:
        with open(str(out) + ".sample_interval_summary", "w") as f:
            f.write("Target\ttotal_coverage\taverage_coverage\t" + "\t".join(
                f"{s}_total_cvg" for s in samples) + "\n")
            for contig, start, end, per_s in sorted(combined.interval_rows):
                tot = sum(per_s.values())
                n = max(1, end - start + 1)
                f.write(f"{contig}:{start}-{end}\t{tot}\t{tot / n:.2f}\t"
                        + "\t".join(str(per_s.get(s, 0)) for s in samples)
                        + "\n")

    if genes:
        with open(str(out) + ".sample_gene_summary", "w") as f:
            f.write("Gene\ttotal_cvg\taverage_cvg\t" + "\t".join(
                f"{s}_total_cvg" for s in samples) + "\n")
            for g in genes:
                m = combined.gene_totals.get(g.name, {})
                tot = sum(m.values())
                glen = max(1, combined.gene_lengths.get(g.name, 0))
                f.write(f"{g.name}\t{tot}\t{tot / glen:.2f}\t"
                        + "\t".join(str(m.get(s, 0)) for s in samples)
                        + "\n")

    mean = (sum(combined.total.values())
            / max(1, combined.n_positions * max(1, len(samples))))
    log.info("depth: mean %.2f over %d positions, %d sample(s) → %s",
             mean, combined.n_positions, len(samples), output)
    return str(out) + (".sample_summary" if not omit_sample_summary
                       else "")
