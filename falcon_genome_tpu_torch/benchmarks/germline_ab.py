"""End-to-end ``germline`` walls of several checkouts of the port,
interleaved on one NVIDIA GPU.

    python -m falcon_genome_tpu_torch.benchmarks.germline_ab ROOT [ROOT ...]
        [--mb 1] [--work DIR]

Simulates ``chip_smoke.py``'s phase-4 sample once with this checkout's
``validate.simulate_sample`` (one contig of ``--mb`` Mb at 30x, 150 bp
pairs, seed 1) under ``--work`` (default ``build/germline_ab``).  Each
distinct ROOT (a checkout of the repository, such as an unpacked ``git
archive`` of another commit) first runs ``germline`` once, untimed, on a
50 kb sample (seed 2), so that its kernels and host extension are built
and loaded before any timed run.  Then, in the order given, each ROOT runs
``germline --device cuda`` on the sample in a process of its own with
ROOT first on ``sys.path``, as the smoke's phase 4 calls it (``cli.main``
with ``-v -f``), and the wall of each stage is read from the timestamps
of its completion line in the log (align, markdup, bqsr, htc; each from
the previous line, the first from the call).  Prints one JSON line per
run (root, wall, stages, exit code) after one with the card's name and
power limit.  Give the roots as parent, change, change, parent.  Without
a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

STAGES = (("align", lambda m: m.startswith("align[") and "records" in m),
          ("markdup", lambda m: m.startswith("markdup")),
          ("bqsr", lambda m: m.startswith("printreads →")),
          ("htc", lambda m: m.startswith("htc →")))


class StageClock(logging.Handler):
    """Timestamps of the stage-completion log lines of ``germline``."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.t: dict[str, float] = {}

    def emit(self, record):
        msg = record.getMessage()
        for name, hit in STAGES:
            if name not in self.t and hit(msg):
                self.t[name] = record.created


def run_one(root: Path, ref: str, fastq1: str, fastq2: str, out: str
            ) -> dict:
    """``germline`` of ``root``'s CLI on a sample (this process imports
    only ``root``'s package)."""
    sys.path.insert(0, str(root))
    from falcon_genome_tpu_torch import cli
    if not Path(cli.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cli.__file__}, not {root}'s package")
    clock = StageClock()
    logger = logging.getLogger("falcon_genome_tpu")
    logger.addHandler(clock)
    t0 = time.time()
    rc = cli.main(["--device", "cuda", "germline", "-r", ref, "-1", fastq1,
                   "-2", fastq2, "-o", out, "-v", "-f"])
    wall = time.time() - t0
    logger.removeHandler(clock)
    stages, prev = {}, t0
    for name, _ in STAGES:
        if name in clock.t:
            stages[name] = clock.t[name] - prev
            prev = clock.t[name]
    return {"root": str(root), "rc": rc, "wall": wall, "stages": stages}


def main(argv: list[str]) -> int:
    import torch
    if len(argv) == 6 and argv[0] == "--one":
        if not torch.cuda.is_available():
            return 1
        res = run_one(Path(argv[1]).resolve(), *argv[2:])
        print(json.dumps(res), flush=True)
        return 0 if res["rc"] == 0 else 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--mb", type=float, default=1.0)
    ap.add_argument("--work", default="build/germline_ab")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("germline_ab: no CUDA device; it times the port on the card "
              "and has no CPU mode", file=sys.stderr)
        return 1
    from .. import validate
    work = Path(args.work).resolve()
    samples = {name: validate.simulate_sample(work / name, length, 30,
                                              seed=seed)
               for name, length, seed in (("sample", int(args.mb * 1e6), 1),
                                          ("warm", 50_000, 2))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"nvidia_smi": smi.stdout.strip().splitlines(),
                      "mb": args.mb}), flush=True)

    def child(root: str, name: str, out: Path) -> dict | None:
        s = samples[name]
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", root,
             s.ref, s.fastq1, s.fastq2, str(out)],
            capture_output=True, text=True, timeout=1800)
        if res.returncode != 0:
            print(res.stdout[-3000:] + res.stderr[-3000:], file=sys.stderr)
            return None
        return json.loads(res.stdout.strip().splitlines()[-1])

    rc = 0
    for i, root in enumerate(dict.fromkeys(args.roots)):
        if child(root, "warm", work / f"warm-{i}.vcf.gz") is None:
            print(json.dumps({"root": root, "error": "warm-up failed"}),
                  flush=True)
            rc = 1
    for i, root in enumerate(args.roots):
        res = child(root, "sample", work / f"run-{i}.vcf.gz")
        print(json.dumps(res or {"root": root, "error": "run failed"}),
              flush=True)
        rc |= res is None
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
