"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with as many NVIDIA cards as
the cell asks for.  The run makes its traffic from the seed, warms up
every call of it, then drives the program's entries from the cell's
caller threads for ``--seconds``.  With ``--trace 0`` the window runs
under ``torch.profiler`` recording the cards' operations alone, and the
run reports the cell's end-to-end metrics: the set-up time and the units
served over the cards' busy time.  With ``--trace 1`` the same window runs
without the profiler (the host's readings), then a window of the
traffic's ``trace_seconds`` under the profiler with the host's events
too, and the run reports the per-layer metrics.  After the window it checks a sample
of the outputs against the plain reference, prints each number compared
beside its limit on standard error, and prints one JSON line last on
standard output.  Without the cards, or with JAX loaded, it exits
non-zero and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse                                             # noqa: E402
import gc                                                   # noqa: E402
import json                                                 # noqa: E402
import os                                                   # noqa: E402
import sys                                                  # noqa: E402
from pathlib import Path                                    # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "portbench"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"

import harness                                              # noqa: E402


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None, devices=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    seed = args.seed % (1 << 63)
    cell = harness.load_cell(args.workload, overrides)
    import torch
    if devices is None:
        if not torch.cuda.is_available():
            return fail("no CUDA device; the benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            return fail(f"{cell.name} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} visible")
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    on_card = devices[0].type == "cuda"

    def sync():
        if on_card:
            for d in devices:
                torch.cuda.synchronize(d)

    t_torch = time.perf_counter()
    try:
        svc = harness.make_service(cell, seed, devices)
    except ImportError as e:
        return fail(f"the program is missing: {e}")
    t_pool = time.perf_counter()
    threads = int(cell.traffic["caller_threads"])
    harness.warm(svc, threads, sync)
    print(f"portbench: set-up: imports "
          f"{t_torch - T_PROCESS:.3f} s, context and traffic "
          f"{t_pool - t_torch:.3f} s, "
          f"warm-up {time.perf_counter() - t_pool:.3f} s", file=sys.stderr)
    if on_card:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - T_PROCESS
    sample = int(cell.traffic["sample_calls_per_thread"])
    if args.trace or not on_card:
        card_s = None
        win = harness.run_window(svc, threads, args.seconds, seed, sample)
    else:
        win, card_s = card_window(svc, threads, args.seconds, seed, sample,
                                  sync)
    traced = trace = None
    if args.trace:
        traced, trace = traced_window(svc, threads, cell, seed, sample,
                                      sync)
    sync()
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0) if on_card else 0

    # the check: the program's state freed, the reference in blocks
    samples = win.samples + (traced.samples if traced else [])
    svc.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = svc.compare(samples)
    errors = win.errors + (traced.errors if traced else [])
    correct = (not errors and bool(samples)
               and all(c["value"] <= c["limit"] for c in checks))

    done = win.done()
    n_done = len(done) + (len(traced.done()) if traced else 0)
    if args.trace:
        metrics = harness.per_layer(cell, harness.Context(
            cell, svc, win, traced, trace))
    else:
        metrics = harness.end_to_end(cell, win, setup_s, card_s,
                                     cell.traffic["throughput_metric"])
    device = {"platform": "gpu" if on_card else devices[0].type,
              "kind": torch.cuda.get_device_name(devices[0])
              if on_card else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n_done + len(errors),
              "failed": len(errors), "metrics": metrics,
              "device": device}
    if trace is not None:
        cards = trace.cards()
        device["busy_s"] = (sum(trace.busy_s(c) for c in cards)
                            / max(1, len(devices)))
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.top_gaps()}
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    for e in errors:
        print(f"portbench: call failed: {e}", file=sys.stderr)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        return fail("JAX or the JAX package is loaded: " + ", ".join(bad))
    per_s = [0] * max(1, int(args.seconds + 0.999))
    for r in done:
        per_s[min(len(per_s) - 1, int(r.t_done - win.t_start))] += r.units
    print(f"portbench: {svc.unit} a second: {per_s}", file=sys.stderr)
    print(f"portbench: host {svc.unit} a second "
          f"{sum(r.units for r in done) / win.seconds!r}, entry CPU ms a "
          f"call {sum(r.cpu_ns for r in done) / max(1, len(done)) / 1e6!r}"
          + (f", card busy {card_s!r} s" if card_s else ""),
          file=sys.stderr)
    print(f"portbench: {len(samples)} sampled calls checked, "
          f"{len(done)} calls in the window", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def card_window(svc, threads, seconds, seed, sample, sync):
    """The window under the profiler, recording the cards' operations
    alone (no host events): the profile runs from before the first call
    until every call has completed, so its device time is exactly the
    window's calls'.  Returns the window and the cards' busy seconds,
    summed."""
    from torch.profiler import ProfilerActivity, profile
    import devtrace
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        win = harness.run_window(svc, threads, seconds, seed, sample)
        sync()
    return win, sum(devtrace.card_busy_s(prof).values())


def traced_window(svc, threads, cell, seed, sample, sync):
    """A window of ``trace_seconds`` under the profiler.  The profiler
    starts before the first call and stops after the last has completed,
    so its kernels are exactly the window's calls'."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    import devtrace
    sync()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            win = harness.run_window(svc, threads,
                                     float(cell.traffic["trace_seconds"]),
                                     seed, sample, pass_no=1)
            sync()
    return win, devtrace.read(prof)


if __name__ == "__main__":
    sys.exit(main())
