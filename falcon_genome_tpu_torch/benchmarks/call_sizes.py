"""The sizes of the PairHMM calls that the callers really make, on NVIDIA
GPUs.

    python -m falcon_genome_tpu_torch.benchmarks.call_sizes [--mb 1]
        [--work DIR]

Runs, on the card, ``germline`` on ``chip_smoke.py``'s phase-4 sample (one
contig of ``--mb`` Mb, 30x, seed 1) and ``mutect2`` on its phase-8 pair
(tumor 60x / normal 30x, seed 5; ``align`` and ``markdup`` of each
first), counting the pairs of every ``pairhmm_logp`` and
``pairhmm_logp_pairs`` call (:class:`PairHMMCalls`).  Prints one JSON
line with the card's name and power limit, then one a command with the
distribution of its call sizes (:func:`summary`).  Without a CUDA device
it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ENTRY_POINTS = ("pairhmm_logp", "pairhmm_logp_pairs")


class PairHMMCalls:
    """Counts the pairs of every PairHMM call while a run is driven: wraps
    ``pairhmm_logp`` (the pairs are its reads' rows) and
    ``pairhmm_logp_pairs`` (its pair indices) where the HaplotypeCaller,
    and through it ``mutect2``, looks them up.  It launches nothing."""

    def __init__(self):
        self.sizes: dict[str, list[int]] = {k: [] for k in ENTRY_POINTS}

    def __enter__(self):
        from ..models import haplotypecaller as hc
        self.hc = hc
        self.real = {k: getattr(hc, k) for k in ENTRY_POINTS}

        def wrap(name, pairs):
            def call(*a, **k):
                self.sizes[name].append(int(pairs(a)))
                return self.real[name](*a, **k)
            return call
        hc.pairhmm_logp = wrap("pairhmm_logp", lambda a: len(a[0]))
        hc.pairhmm_logp_pairs = wrap("pairhmm_logp_pairs",
                                     lambda a: len(a[5]))
        return self

    def __exit__(self, *exc):
        for k, f in self.real.items():
            setattr(self.hc, k, f)


def summary(sizes: dict[str, list[int]]) -> dict:
    """Calls per entry point, pairs in all, and the quantiles of the
    pairs a call over every call (min, 10%, 25%, median, 75%, 90%, max;
    ``np.percentile``'s linear interpolation), with the calls counted by
    power-of-two bins (``"<=256"`` holds 129-256)."""
    every = np.array([n for v in sizes.values() for n in v], np.int64)
    out = {"calls": {k: len(v) for k, v in sizes.items()},
           "pairs": int(every.sum())}
    if len(every) == 0:
        return out
    qs = (0, 10, 25, 50, 75, 90, 100)
    names = ("min", "p10", "p25", "median", "p75", "p90", "max")
    out.update({n: float(np.percentile(every, q))
                for n, q in zip(names, qs)})
    bins: dict[str, int] = {}
    for n in sorted(every.tolist()):
        top = 1 << max(0, int(n - 1).bit_length())
        bins[f"<={top}"] = bins.get(f"<={top}", 0) + 1
    out["bins"] = bins
    return out


def main(argv: list[str]) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=1.0)
    ap.add_argument("--work", default="build/call_sizes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("call_sizes: no CUDA device; it drives the port on the card",
              file=sys.stderr)
        return 1
    from .. import cli, validate
    work = Path(args.work).resolve()
    length = int(args.mb * 1e6)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"nvidia_smi": smi.stdout.strip().splitlines(),
                      "mb": args.mb}), flush=True)
    sample = validate.simulate_sample(work / "germline", length, 30, seed=1)
    with PairHMMCalls() as rec:
        rc = cli.main(["--device", "cuda", "germline", "-r", sample.ref,
                       "-1", sample.fastq1, "-2", sample.fastq2,
                       "-o", str(work / "germline" / "calls.vcf.gz"),
                       "-f"])
    print(json.dumps({"command": "germline", "rc": rc,
                      **summary(rec.sizes)}), flush=True)
    tn = validate.simulate_tumor_normal(work / "tn", length, seed=5)
    bams = {}
    for name, reads in (("tumor", tn.tumor), ("normal", tn.normal)):
        aligned = work / "tn" / f"{name}.aligned.bam"
        bams[name] = str(work / "tn" / f"{name}.bam")
        rc |= cli.main(["--device", "cuda", "align", "-r", tn.ref,
                        "-1", reads.fastq1, "-2", reads.fastq2,
                        "-o", str(aligned), "-S", name, "-R", name, "-f"])
        rc |= cli.main(["--device", "cuda", "markdup", "-i", str(aligned),
                        "-o", bams[name], "-f"])
    with PairHMMCalls() as rec:
        rc_m = cli.main(["--device", "cuda", "mutect2", "-r", tn.ref,
                         "-t", bams["tumor"], "-n", bams["normal"],
                         "-o", str(work / "tn" / "somatic.vcf.gz"), "-f"])
    print(json.dumps({"command": "mutect2", "rc": rc_m,
                      **summary(rec.sizes)}), flush=True)
    return 1 if rc or rc_m else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
