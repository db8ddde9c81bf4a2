"""End-to-end ``germline`` walls of several checkouts of the port,
interleaved on one NVIDIA GPU.

    python -m falcon_genome_tpu_torch.benchmarks.germline_ab ROOT [ROOT ...]
        [--mb 1] [--work DIR] [--profile DIR]

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

With ``--profile DIR``, after the timed runs each distinct ROOT runs the
sample once more with the main thread under ``cProfile``, one profile a
stage (written to ``DIR/<i>-<stage>.pstats``; the stages run their host
work on the thread that logs their completion), and with the state of
the process at each stage's start: torch's intra-op and inter-op
threads, the CPUs it may run on, the Python threads alive, the OS
threads, the resident set, and the CUDA memory allocated and reserved
and the pinned host memory held by torch's caching allocators.  One JSON
line a root (``profile``, ``state``).
"""
from __future__ import annotations

import argparse
import cProfile
import json
import logging
import os
import subprocess
import sys
import threading
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


def process_state() -> dict:
    """What the process holds at one moment: threads, memory, pools."""
    import torch
    status = dict(line.split(":", 1) for line in
                  Path("/proc/self/status").read_text().splitlines()
                  if ":" in line)
    state = {"torch_threads": torch.get_num_threads(),
             "interop_threads": torch.get_num_interop_threads(),
             "cpus": len(os.sched_getaffinity(0)),
             "py_threads": sorted(t.name for t in threading.enumerate()),
             "os_threads": int(status["Threads"]),
             "rss_mb": int(status["VmRSS"].split()[0]) / 1024,
             "cuda_allocated_mb": torch.cuda.memory_allocated() / 2 ** 20,
             "cuda_reserved_mb": torch.cuda.memory_reserved() / 2 ** 20}
    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    if host_stats is not None:
        state["pinned_reserved_mb"] = host_stats().get(
            "reserved_bytes.current", 0) / 2 ** 20
    return state


class StageProfiler(StageClock):
    """:class:`StageClock` that also snapshots :func:`process_state` at
    each stage's start and profiles the main thread one stage at a time,
    writing each stage's profile to ``<prefix>-<stage>.pstats``."""

    def __init__(self, prefix: Path):
        super().__init__()
        self.prefix = prefix
        self.state = {STAGES[0][0]: process_state()}
        self.prof = cProfile.Profile()
        self.prof.enable()

    def emit(self, record):
        done = set(self.t)
        super().emit(record)
        for i, (name, _) in enumerate(STAGES):
            if name not in self.t or name in done:
                continue
            if threading.current_thread() is threading.main_thread():
                self.prof.disable()
                self.prof.dump_stats(f"{self.prefix}-{name}.pstats")
                self.prof = cProfile.Profile()
                self.prof.enable()
            if i + 1 < len(STAGES):
                self.state[STAGES[i + 1][0]] = process_state()

    def close(self):
        self.prof.disable()
        super().close()


def run_one(root: Path, ref: str, fastq1: str, fastq2: str, out: str,
            profile: Path | None = None) -> dict:
    """``germline`` of ``root``'s CLI on a sample (this process imports
    only ``root``'s package); with ``profile``, under
    :class:`StageProfiler` writing to that prefix."""
    sys.path.insert(0, str(root))
    from falcon_genome_tpu_torch import cli
    if not Path(cli.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cli.__file__}, not {root}'s package")
    logger = logging.getLogger("falcon_genome_tpu")
    t0 = time.time()
    clock = StageClock() if profile is None else StageProfiler(profile)
    logger.addHandler(clock)
    rc = cli.main(["--device", "cuda", "germline", "-r", ref, "-1", fastq1,
                   "-2", fastq2, "-o", out, "-v", "-f"])
    wall = time.time() - t0
    logger.removeHandler(clock)
    clock.close()
    stages, prev = {}, t0
    for name, _ in STAGES:
        if name in clock.t:
            stages[name] = clock.t[name] - prev
            prev = clock.t[name]
    res = {"root": str(root), "rc": rc, "wall": wall, "stages": stages}
    if profile is not None:
        res.update(profile=str(profile), state=clock.state)
    return res


def main(argv: list[str]) -> int:
    import torch
    if len(argv) in (6, 7) and argv[0] == "--one":
        if not torch.cuda.is_available():
            return 1
        res = run_one(Path(argv[1]).resolve(), *argv[2:6],
                      *(Path(p) for p in argv[6:]))
        print(json.dumps(res), flush=True)
        return 0 if res["rc"] == 0 else 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--mb", type=float, default=1.0)
    ap.add_argument("--work", default="build/germline_ab")
    ap.add_argument("--profile", default=None,
                    help="directory for one profiled run a root")
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

    def child(root: str, name: str, out: Path, *extra: str) -> dict | None:
        s = samples[name]
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", root,
             s.ref, s.fastq1, s.fastq2, str(out), *extra],
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
    if args.profile:
        prof = Path(args.profile).resolve()
        prof.mkdir(parents=True, exist_ok=True)
        for i, root in enumerate(dict.fromkeys(args.roots)):
            res = child(root, "sample", work / f"profile-{i}.vcf.gz",
                        str(prof / str(i)))
            print(json.dumps(res or {"root": root,
                                     "error": "profiled run failed"}),
                  flush=True)
            rc |= res is None
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
