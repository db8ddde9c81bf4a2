"""Mutect2 scale rehearsal of the port: tumor/normal somatic calling at
10 Mb.

Port of ``benchmarks/mutect2_rehearsal.py``: a 10 Mb tumor and normal pair
(25x each, 150 bp, half the reads on the reverse strand) with 1,000
planted somatic SNVs (35% of the tumor's reads), 2,000 germline hets in
both samples (the matched normal must suppress them) and calibrated q30
qualities at 0.1% sequencing error, then ``stages.run_mutect2`` with the
normal on ``--device``.  ``ref.fa``, ``tumor.bam``, ``normal.bam`` and
``somatic.npy`` equal the JAX script's byte for byte at the same sizes
(``default_rng(23)``, its draws in its order); they are cached in the
work directory.

The ``mutect2`` row (wall, peak RSS, reads/s, somatic sensitivity, extra
calls and precision, as the JAX script's) adds the card, the peak device
memory, each kernel's launches in the run, the pairs of its PairHMM
calls (``call_sizes.summary``) and the path each BAM was read by
(``input_paths``: ``in memory`` or ``stream``, the out-of-core reader).
It merges into ``--out`` under ``mutect2`` at the default 10 Mb and under
``mutect2@<Mb>mb`` at any other genome (:func:`result_key`).

``M2_G_MB`` in the environment sets the genome in Mb (default 10); the
somatic and germline site counts follow it.

Usage:
    [M2_G_MB=10] python -m \
        falcon_genome_tpu_torch.benchmarks.mutect2_rehearsal [WORKDIR]
        [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

from .wgs_rehearsal import (
    DEFAULT_OUT, REPO, Measured, card_label, input_path, row_key, save_row)

DEFAULT_MB = 10
G_MB = int(os.environ.get("M2_G_MB", str(DEFAULT_MB)))
G = G_MB * 1_000_000
DEPTH = 25
READ_LEN = 150
N_SOMATIC = 100 * G_MB          # 1,000 at the 10 Mb baseline scale
N_GERMLINE = 200 * G_MB
SOMATIC_VAF = 0.35
ERR = 0.001
QUAL_CHR = "?"          # phred 30 == the actual error rate (calibrated)
CHUNK = 200_000         # records a RecordColumns chunk, as the JAX script


def _write_bam(path, ref, alt_hap, somatic, rng, sample, somatic_vaf):
    """Directly-constructed sorted BAM at DEPTH x (vectorized chunks);
    its draws from ``rng`` in the JAX script's order."""
    from ..io.bam import BamColumnsWriter
    from ..io.sam import SamHeader

    n_reads = G * DEPTH // READ_LEN
    header = SamHeader(
        contigs=[("chr1", G)],
        read_groups=[{"ID": f"rg-{sample}", "SM": sample}],
        sort_order="coordinate")
    w = BamColumnsWriter(str(path), header)
    starts_all = np.sort(rng.integers(0, G - READ_LEN, n_reads))
    for a in range(0, n_reads, CHUNK):
        b = min(a + CHUNK, n_reads)
        starts = starts_all[a:b]
        seqs = ref[starts[:, None] + np.arange(READ_LEN)[None, :]].copy()
        # germline hets: random half of covering reads take the alt hap
        # base; somatic (tumor only): somatic_vaf of covering reads
        for sites, frac in ((np.flatnonzero(alt_hap != ref), 0.5),
                            (somatic, somatic_vaf)):
            if len(sites) == 0:
                continue
            lo = np.searchsorted(starts, sites - READ_LEN + 1, "left")
            hi = np.searchsorted(starts, sites, "right")
            for si, site in enumerate(sites):
                cov = np.arange(lo[si], hi[si])
                if len(cov) == 0:
                    continue
                pick = cov[rng.random(len(cov)) < frac]
                col = site - starts[pick]
                ok = (col >= 0) & (col < READ_LEN)
                seqs[pick[ok], col[ok]] = (ref[site] + 1) % 4
        err = rng.random(seqs.shape) < ERR
        seqs = np.where(err, (seqs + rng.integers(1, 4, seqs.shape)) % 4,
                        seqs).astype(np.uint8)
        w.write_columns(chunk_columns(sample, a, starts, seqs))
    w.close()
    return n_reads


def chunk_columns(sample: str, first: int, starts: np.ndarray,
                  seqs: np.ndarray):
    """The records ``{sample}{first + i}`` of one chunk as RecordColumns,
    built from arrays: what ``RecordColumns.from_records`` makes of the
    JAX script's ``SamRecord`` objects (flag 0x10 on odd reads, tid 0,
    mapq 60, ``READ_LEN``M, qualities ``QUAL_CHR``, tag ``RG:Z:rg-{sample}``),
    without one Python object a read."""
    from ..io.bam import _encode_tags
    from ..io.columns import RecordColumns

    n = len(starts)
    i = np.arange(n)
    names = [f"{sample}{first + k}".encode() for k in range(n)]
    name_len = np.fromiter(map(len, names), np.int64, n)
    name_off = np.zeros(n, np.int64)
    np.cumsum(name_len[:-1], out=name_off[1:])
    fixed = np.zeros((n, 12), np.int32)
    fixed[:, 1] = starts                     # tid 0, pos
    fixed[:, 2] = 60                         # mapq
    fixed[:, 3] = 0x10 * (i % 2)             # flag
    fixed[:, 4] = READ_LEN                   # l_seq
    fixed[:, 5] = -1                         # mate tid
    fixed[:, 6] = -1                         # mate pos
    fixed[:, 8] = 1                          # cigar ops
    fixed[:, 9] = name_len                   # l_read_name
    fixed[:, 11] = starts + READ_LEN         # end
    tag = _encode_tags({"RG": ("Z", f"rg-{sample}")})
    return RecordColumns(
        fixed=fixed,
        names=np.frombuffer(b"".join(names), np.uint8),
        name_off=name_off,
        cigar_ops=np.zeros(n, np.int32),
        cigar_lens=np.full(n, READ_LEN, np.int32),
        cig_off=i.astype(np.int64),
        seq=np.frombuffer(b"ACGTN", np.uint8)[seqs.reshape(-1)],
        qual=np.full(n * READ_LEN, ord(QUAL_CHR), np.uint8),
        seq_off=i.astype(np.int64) * READ_LEN,
        tags=np.frombuffer(tag * n, np.uint8),
        tag_off=i.astype(np.int64) * len(tag),
        tag_len=np.full(n, len(tag), np.int64),
        seq_mode="ascii", qual_mode="ascii")


def gen_dataset(work: Path) -> None:
    """``ref.fa``, ``tumor.bam``, ``normal.bam`` and ``somatic.npy`` from
    ``default_rng(23)``, reused where the three files exist (as the JAX
    script)."""
    from ..io.dna import decode_seq
    from ..io.fasta import write_fasta

    rng = np.random.default_rng(23)
    ref_fa, tumor, normal = (work / n for n in ("ref.fa", "tumor.bam",
                                                "normal.bam"))
    if ref_fa.exists() and tumor.exists() and normal.exists():
        print("dataset cached")
        return
    t0 = time.perf_counter()
    ref = rng.integers(0, 4, G).astype(np.uint8)
    write_fasta(ref_fa, {"chr1": decode_seq(ref)})
    sites = np.sort(rng.choice(np.arange(1000, G - 1000),
                               N_SOMATIC + N_GERMLINE, replace=False))
    pick = rng.permutation(len(sites))
    somatic = np.sort(sites[pick[:N_SOMATIC]])
    germline = np.sort(sites[pick[N_SOMATIC:]])
    np.save(work / "somatic.npy", somatic)
    alt_hap = ref.copy()
    alt_hap[germline] = (alt_hap[germline] + 1) % 4
    n_t = _write_bam(tumor, ref, alt_hap, somatic, rng, "TUMOR",
                     SOMATIC_VAF)
    n_n = _write_bam(normal, ref, alt_hap, np.zeros(0, np.int64), rng,
                     "NORMAL", 0.0)
    print(f"dataset: {n_t + n_n} reads in {time.perf_counter() - t0:.0f}s")


def result_key() -> str:
    """The row's key in the results JSON at this module's genome."""
    return row_key("mutect2", G / 1e6, DEFAULT_MB, "mb")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work", nargs="?",
                    default=str(REPO / "build" / f"m2_{G_MB}mb"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="results JSON (merged with what it holds)")
    args = ap.parse_args(argv)
    from .. import stages
    from ..device import resolve_device
    from ..io.vcf import read_vcf
    from .call_sizes import PairHMMCalls, summary
    from .wgs_rehearsal import make_conf
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    gen_dataset(work)
    conf = make_conf(work)
    out = work / "somatic.vcf.gz"
    calls = PairHMMCalls()
    with Measured(device) as m, calls:
        stages.run_mutect2(conf, str(work / "ref.fa"),
                           str(work / "tumor.bam"), str(out),
                           normal_path=str(work / "normal.bam"), force=True,
                           device=device)

    truth = set(np.load(work / "somatic.npy").tolist())
    _, recs = read_vcf(str(out))
    called = {r.pos - 1 for r in recs
              if not r.filter or r.filter in ("PASS", ".")}
    tp = len(truth & called)
    n_reads = 2 * (G * DEPTH // READ_LEN)
    row = {"wall_s": round(m.wall, 1), **m.memory(),
           "reads_per_s": round(n_reads / m.wall, 1),
           "genome_mb": G / 1e6,
           "somatic_sensitivity": round(tp / len(truth), 4),
           "extra_calls": len(called - truth),
           "precision": round(tp / max(len(called), 1), 5),
           "launches": m.launches,
           "pairhmm_call_sizes": summary(calls.sizes),
           "input_paths": {n: input_path(conf, str(work / f"{n}.bam"))
                           for n in ("tumor", "normal")},
           "card": card_label(device)}
    save_row(Path(args.out), result_key(), row)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
