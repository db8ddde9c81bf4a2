"""``germline`` end to end through the port on a small simulated sample:
a 200 kb contig with 100 planted het SNPs, 150 bp pairs every 11 bp
(~27x, no sequencing errors), then SNP sensitivity and extra calls.

Port of ``benchmarks/bench_germline.py``.  Ends with a JSON row.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.bench_germline
        [--genome-mb 0.2] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .wgs_rehearsal import card_label

G = 200_000


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-mb", type=float, default=G / 1e6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import stages
    from ..config import Config, Machine
    from ..device import resolve_device
    from ..io.dna import decode_seq, revcomp_codes
    from ..io.fasta import write_fasta
    from ..io.fastq import write_fastq
    from ..io.vcf import read_vcf
    device = resolve_device(args.device)

    rng = np.random.default_rng(1)
    genome_len = int(round(args.genome_mb * 1e6))
    chrom = rng.integers(0, 4, genome_len).astype(np.uint8)
    with tempfile.TemporaryDirectory(prefix="bench-germline-") as tmp:
        ref = os.path.join(tmp, "ref.fa")
        write_fasta(ref, {"chr20": decode_seq(chrom)})

        # planted het SNPs
        alt = chrom.copy()
        truth_snps = sorted(rng.choice(np.arange(1000, genome_len - 1000),
                                       genome_len // 2000, replace=False))
        for p in truth_snps:
            alt[p] = (alt[p] + 1) % 4

        read_len, frag = 150, 350
        names, s1, q1, s2, q2 = [], [], [], [], []
        for i, start in enumerate(range(0, genome_len - frag, 11)):
            hap = alt if i % 2 else chrom
            names.append(f"f{start}")
            s1.append(decode_seq(hap[start:start + read_len]))
            q1.append("I" * read_len)
            s2.append(decode_seq(revcomp_codes(
                hap[start + frag - read_len:start + frag])))
            q2.append("I" * read_len)
        print(f"{len(names)} fragments ({2 * len(names)} reads)")
        fq1 = os.path.join(tmp, "r_1.fastq")
        fq2 = os.path.join(tmp, "r_2.fastq")
        write_fastq(fq1, names, s1, q1)
        write_fastq(fq2, names, s2, q2)

        conf = Config(machine=Machine(8, 16), environ={}, load_files=False)
        conf.set("gatk.ncontigs", 8)
        conf.set("temp_dir", tmp)
        out = os.path.join(tmp, "out.vcf.gz")
        t0 = time.perf_counter()
        stages.run_germline(conf, ref, out, fastq1=fq1, fastq2=fq2,
                            sample_id="s", produce_vcf=True, force=True,
                            device=device)
        dt = time.perf_counter() - t0
        _, recs = read_vcf(out)
    called = {r.pos - 1 for r in recs if not r.is_gvcf_block}
    tp = sum(1 for p in truth_snps if p in called)
    n_reads = 2 * len(names)
    print(f"germline e2e: {dt:.1f}s ({n_reads / dt:.0f} reads/s "
          "end-to-end)")
    print(f"sensitivity: {tp}/{len(truth_snps)}  extra calls: "
          f"{len(called) - tp}")
    print(json.dumps({"reads": n_reads, "wall_s": round(dt, 2),
                      "reads_per_s": round(n_reads / dt, 1),
                      "tp": tp, "snps": len(truth_snps),
                      "extra_calls": len(called) - tp,
                      "card": card_label(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
