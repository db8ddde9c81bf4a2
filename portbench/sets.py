"""Sets of runs of one cell, one process a run, and their spreads.

    python3 portbench/sets.py --workload <cell> --seeds 1,2,3
        [--seconds 10] [--trace 0|1] [--out FILE]

Runs ``run.py`` once a seed, in turn, and prints one JSON line a run (the
run's result line, its exit code and wall time, the last lines of its
standard error) and then, over the runs with a result, each metric's
median and its spread: the distance between the first and third
quartile (``statistics.quantiles(values, n=4)``) over the median.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return None
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="sets of runs of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="10")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(HERE / "run.py"), "--workload",
               args.workload, "--seed", seed, "--seconds", args.seconds,
               "--trace", args.trace]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True,
                           cwd=HERE.parent)
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"seed": int(seed), "rc": p.returncode,
               "wall_s": time.perf_counter() - t0, "result": result,
               "stderr": p.stderr[-1500:]}
        runs.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    names = sorted({k for r in runs if r["result"]
                    for k in r["result"]["metrics"]})
    summary = {"workload": args.workload, "trace": args.trace,
               "correct": [bool(r["result"] and r["result"]["correct"])
                           for r in runs]}
    for n in names:
        vals = [r["result"]["metrics"][n]["value"] for r in runs
                if r["result"] and n in r["result"]["metrics"]]
        summary[n] = {"median": statistics.median(vals),
                      "spread": spread(vals), "values": vals}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
