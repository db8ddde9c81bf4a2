"""Device time and the device's idle share per stage of ``germline`` on one
NVIDIA GPU.

    python -m falcon_genome_tpu_torch.benchmarks.idle_share [--mb 1]
        [--work DIR]

Simulates ``chip_smoke.py``'s phase-4 sample (``validate.simulate_sample``:
one contig of ``--mb`` Mb at 30x, seed 1) under ``--work`` (default
``build/idle_share``), runs ``germline --device cuda -O tpu.profile=true``
through the CLI, and reads the ``torch.profiler`` Chrome trace that the
pipeline runner writes for each stage (``<log_dir>/profile/*.json``).  A
stage's device time is the union of the intervals of its trace's device
events (kernels, copies, sets); its span runs from the trace's first
event to its last; the idle share is 1 - device time / span.  The
profiler's own cost lengthens the span, so the shares are upper bounds.
Prints one JSON line per stage, then one for the run (wall with the
profiler on, call accuracy); without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_times(path: Path) -> dict:
    """Span, device time and kernel count of one Chrome trace (ms)."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    if not timed:
        return dict(span_ms=0.0, device_ms=0.0, kernels=0)
    start = min(float(e["ts"]) for e in timed)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in timed if e.get("cat") in DEVICE_CATS)
    busy, cur = 0.0, None
    for a, b in dev:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    kernels = sum(1 for e in timed if e.get("cat") == "kernel")
    return dict(span_ms=(end - start) / 1e3, device_ms=busy / 1e3,
                kernels=kernels)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=1.0)
    ap.add_argument("--work", default=str(
        Path(__file__).resolve().parents[2] / "build" / "idle_share"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("idle_share: no CUDA device; it traces the card",
              file=sys.stderr)
        return 1
    from falcon_genome_tpu_torch import cli, validate
    work = Path(args.work)
    shutil.rmtree(work, ignore_errors=True)
    sample = validate.simulate_sample(work / "sample",
                                      int(args.mb * 1_000_000), 30, seed=1)
    log_dir = work / "log"
    vcf = work / "calls.vcf.gz"
    t0 = time.time()
    rc = cli.main(["--device", "cuda", "germline", "-r", sample.ref,
                   "-1", sample.fastq1, "-2", sample.fastq2, "-o", str(vcf),
                   "-v", "-f", "-O", "tpu.profile=true",
                   "-O", f"log_dir={log_dir}"])
    wall = time.time() - t0
    if rc != 0:
        print(f"idle_share: germline exited {rc}", file=sys.stderr)
        return 1
    traces = sorted((log_dir / "profile").glob("*.json"))
    if not traces:
        print("idle_share: the runner wrote no trace", file=sys.stderr)
        return 1
    for path in traces:
        t = trace_times(path)
        idle = 1.0 - t["device_ms"] / t["span_ms"] if t["span_ms"] else None
        print(json.dumps({"stage": path.stem.rsplit("-", 1)[0], **t,
                          "idle_share": idle}), flush=True)
    acc = validate.score_calls(str(vcf), sample)
    print(json.dumps({"wall_s": wall, "pairs": sample.n_pairs,
                      "device": torch.cuda.get_device_name(0),
                      "accuracy": acc}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
