"""Population-scale joint-genotyping gate of the port.

Port of ``benchmarks/joint_cohort.py``: a cohort of ``n_samples``
single-sample gVCFs (default 60) over the first 10 Mb of the WGS
rehearsal's reference (``ref.fa`` of ``wgs_rehearsal``'s work directory,
where the JAX script read ``/tmp/wgs60/ref.fa``) — genotypes drawn per
truth site from ``default_rng(7)``, hom-ref evidence as gVCF reference
blocks; the records equal the JAX script's — then the production
``run_joint`` scatter (a tabix-streamed merge a shard over
``gatk.joint.ncontigs`` shards) on the host, and the gate:

  * every truth site is in the joint VCF with each sample's genotype
    (``gt_errors == 0``) and the right AC;
  * hom-ref samples are reconstituted from their covering ref block.

The ``joint_cohort`` row (samples, sites, wall, peak RSS, the gate's
counts and ``pass``, the kernels' launches (none) and the card) merges into ``--out``; a failed gate
exits 1.  No kernel runs: joint genotyping is host work, and ``--device``
only names the machine the row is taken on (``cuda`` without a card
raises, as in every rehearsal script).

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.joint_cohort
        [WORKDIR] [N_SAMPLES] [--device cuda|cpu] [--out PATH]
    (the cohort goes to WORKDIR/joint_cohort)
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from .wgs_rehearsal import (
    DEFAULT_OUT, DEFAULT_WORK, Measured, card_label, load_results, make_conf)

REGION_MB = 10
N_SITES = 8000
DP = 30


def gen_cohort(work: Path, ref: str, n_samples: int, rng) -> tuple:
    """Write n_samples indexed gVCFs; returns (dir, contig, truth_pos,
    gt_matrix).  Draws from ``rng`` in the JAX script's order."""
    from ..io.fasta import FastaFile
    from ..io.vcf import STANDARD_META, VcfHeader, VcfRecord, write_vcf

    fa = FastaFile(ref)
    contig = fa.dict.contigs[0].name
    clen = fa.dict.contigs[0].length
    region = min(REGION_MB * 1_000_000, clen)
    codes = fa.contig_codes(contig)[:region]

    pos = np.sort(rng.choice(np.arange(1000, region - 1000), N_SITES,
                             replace=False))
    # drop sites whose reference base is N
    pos = pos[codes[pos] != 4]
    refb = np.array(list("ACGTN"))[codes[pos]]
    altb = np.array(list("ACGTN"))[(codes[pos] + 1) % 4]
    # per-sample genotype: 0=homref, 1=het, 2=homalt
    gts = rng.choice([0, 1, 2], size=(n_samples, len(pos)),
                     p=[0.4, 0.4, 0.2])
    # every site needs at least one carrier or joint drops it — force
    # site 0 of each carrier-less column to het
    none = (gts > 0).sum(axis=0) == 0
    gts[0, none] = 1

    gdir = work / "gvcfs"
    gdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for s in range(n_samples):
        hdr = VcfHeader(contigs=[(c.name, c.length) for c in fa.dict],
                        samples=[f"s{s:03d}"], meta=list(STANDARD_META))
        recs = []
        prev_end = 1          # 1-based; block [prev_end, site-1]
        for i in range(len(pos)):
            p1 = int(pos[i]) + 1          # VCF 1-based
            g = gts[s, i]
            if g == 0:
                continue
            if p1 > prev_end:
                recs.append(VcfRecord(
                    contig=contig, pos=prev_end, ref="A",
                    alts=["<NON_REF>"], info={"END": p1 - 1},
                    fmt=["GT", "DP", "GQ"],
                    samples=[{"GT": "0/0", "DP": DP, "GQ": 60}]))
            if g == 1:
                ad = [DP // 2, DP - DP // 2, 0]
                pl = [80, 0, 90, 120, 110, 160]
                gt = "0/1"
            else:
                ad = [0, DP, 0]
                pl = [320, 90, 0, 330, 95, 340]
                gt = "1/1"
            recs.append(VcfRecord(
                contig=contig, pos=p1, ref=str(refb[i]),
                alts=[str(altb[i]), "<NON_REF>"], qual=100.0,
                fmt=["GT", "AD", "DP", "GQ", "PL"],
                samples=[{"GT": gt, "AD": ad, "DP": DP, "GQ": 99,
                          "PL": pl}]))
            prev_end = p1 + 1
        if region >= prev_end:
            recs.append(VcfRecord(
                contig=contig, pos=prev_end, ref="A", alts=["<NON_REF>"],
                info={"END": region}, fmt=["GT", "DP", "GQ"],
                samples=[{"GT": "0/0", "DP": DP, "GQ": 60}]))
        write_vcf(gdir / f"s{s:03d}.g.vcf.gz", hdr, recs)
    print(f"wrote {n_samples} gVCFs in {time.perf_counter() - t0:.0f}s")
    return gdir, contig, pos, gts


def gate(recs, pos, gts) -> dict:
    """The joint VCF's records against the truth: sites missing or extra,
    per-sample genotype errors and AC errors."""
    n_samples = gts.shape[0]
    by_pos = {r.pos - 1: r for r in recs}
    missing = gt_errors = ac_errors = 0
    for i, p in enumerate(pos):
        r = by_pos.get(int(p))
        if r is None:
            missing += 1
            continue
        want_ac = int((gts[:, i] == 1).sum() + 2 * (gts[:, i] == 2).sum())
        ac = int(str(r.info.get("AC", "0")).split(",")[0])
        if ac != want_ac:
            ac_errors += 1
        for s in range(n_samples):
            gt = r.samples[s].get("GT", "./.")
            alleles = sorted(gt.replace("|", "/").split("/"))
            want = [["0", "0"], ["0", "1"], ["1", "1"]][gts[s, i]]
            if alleles != want:
                gt_errors += 1
    return {"missing_sites": missing,
            "extra_sites": len(by_pos) - (len(pos) - missing),
            "gt_errors": gt_errors, "ac_errors": ac_errors,
            "pass": missing == 0 and gt_errors == 0 and ac_errors == 0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("work", nargs="?", default=str(DEFAULT_WORK))
    ap.add_argument("n_samples", nargs="?", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="results JSON (merged with what it holds)")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..io.fasta import FastaFile
    from ..io.vcf import read_vcf
    from ..stages.vcfstages import run_joint
    device = resolve_device(args.device)

    ref = Path(args.work) / "ref.fa"
    if not ref.exists():
        raise SystemExit("needs the rehearsal reference "
                         "(run wgs_rehearsal first)")
    work = Path(args.work) / "joint_cohort"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    conf = make_conf(work)
    gdir, contig, pos, gts = gen_cohort(work, str(ref), args.n_samples, rng)

    out = str(work / "joint.vcf.gz")
    with Measured(device) as m:
        run_joint(conf, str(ref), str(gdir), out, force=True)

    _, recs = read_vcf(out)
    row = {"samples": args.n_samples, "sites": int(len(pos)),
           "genome_mb": min(REGION_MB * 1e6, FastaFile(str(ref)).dict
                            .contigs[0].length) / 1e6,
           "wall_s": round(m.wall, 1), **m.memory(),
           **gate(recs, pos, gts), "launches": m.launches,
           "card": card_label(device)}
    print(json.dumps(row))
    results_path = Path(args.out)
    results = load_results(results_path)
    results["joint_cohort"] = row
    results_path.parent.mkdir(parents=True, exist_ok=True)
    results_path.write_text(json.dumps(results, indent=1))
    if not row["pass"]:
        print("joint cohort gate FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
