"""The readings that a cell's correctness limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--seconds 3] [--out FILE]

For each seed, in one process: the cell's traffic at its own size, a
window of ``--seconds`` at the cell's own load through the program, and
the check of its sampled outputs (the lower reading: what sound runs of
the program give).  For each control seed the same, and the reference in
the program's place one precision below the configuration's (bfloat16
for the PairHMM's float32): the upper reading.  One JSON line a seed; ``--out`` also appends
them to a file.  The benchmark's own runs never run the control.
"""
import time

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness                                              # noqa: E402


def readings(cell_name: str, seed: int, seconds: float, control: bool,
             devices=None, overrides=None) -> dict:
    import torch
    cell = harness.load_cell(cell_name, overrides)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    t0 = time.perf_counter()
    svc = harness.make_service(cell, seed, devices)
    threads = int(cell.traffic["caller_threads"])
    harness.warm(svc, threads, lambda: None)
    win = harness.run_window(svc, threads, seconds, seed,
                             int(cell.traffic["sample_calls_per_thread"]))
    svc.release()
    out = {"workload": cell_name, "seed": seed,
           "calls": len(win.done()), "sampled": len(win.samples),
           "errors": win.errors}
    for c in svc.compare(win.samples):
        out[c["name"]] = c["value"]
    if control:
        for c in svc.compare(win.samples, control=True):
            out[c["name"] + ".control"] = c["value"]
    out["seconds"] = time.perf_counter() - t0
    del svc
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="correctness readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(ctrl - set(seeds)):
        line = json.dumps(readings(args.workload, seed, args.seconds,
                                   seed in ctrl))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
