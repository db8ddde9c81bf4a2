"""The parts of the port's batched Smith-Waterman path at long-read chunk
shapes, each timed alone.

Port of ``benchmarks/bench_sw_parts.py``: ``ops.smith_waterman.
sw_extend_batch`` broken into the parts it runs, as
``_sw_extend_dispatch_one`` runs them — host pack (the int8 and int32
host tensors ``device_reads`` and ``_lane_meta`` make), the host → card
copy, K2 (``sw_pointers``, the pointers left on the card), K3
(``sw_traceback``), the card → host copy of the packed ops, coordinates
and scores, and the host decode (``_results_from_packed``) — each timed
on ``--device`` (which replaces the JAX script's ``SWP_CPU``), best of
three after a warm call, every part waited for on the card
(:func:`sync`).  Inputs: ``B`` lanes (default 2240) of ~144 bp reads
against 256 bp windows at 5% divergence in the 160 x 256 bucket
(``default_rng(0)``).  The composed parts must give ``sw_extend_batch``'s
results bit for bit, else it exits 1.  Prints a line a part, then one
JSON line with the milliseconds of each, the run's peak device memory
and kernel launches, and the card.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.bench_sw_parts [LANES]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

B = 2240
R, W = 160, 256


def sync(device: torch.device, x=None):
    """Wait for the card's queued work (nothing to wait for on the CPU);
    returns ``x``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return x


def t(name: str, fn, n: int = 3) -> float:
    """Best of ``n`` timed calls of ``fn`` after one warm call; prints
    and returns it in seconds."""
    fn()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    print(f"{name:36s} {best * 1e3:9.3f} ms")
    return best


def lanes(n: int, rng) -> tuple:
    """Chunk-shaped inputs: ~144 bp reads against 256 bp windows at 5%
    divergence (reads padded with 4 to R)."""
    wins = rng.integers(0, 4, (n, W)).astype(np.uint8)
    reads = np.empty((n, R), np.uint8)
    for b in range(n):
        r = wins[b, 8:8 + 144].copy()
        err = rng.random(144) < 0.05
        r[err] = (r[err] + 1) % 4
        reads[b, :144] = r
        reads[b, 144:] = 4
    return reads, np.full(n, 144, np.int32), wins, np.full(n, W, np.int32)


def pack(reads, rl, wins, wl) -> tuple:
    """The host half of ``device_reads`` and ``_lane_meta``: contiguous
    int8 reads and windows, int32 lengths, as CPU tensors."""
    return (torch.from_numpy(np.ascontiguousarray(reads, np.int8)),
            torch.from_numpy(np.ascontiguousarray(rl, np.int32)),
            torch.from_numpy(np.ascontiguousarray(wins, np.int8)),
            torch.from_numpy(np.ascontiguousarray(wl, np.int32)))


def run_dp(device, inputs, params, state: dict) -> None:
    """K2 on the copied inputs; its pointers, best and positions stay on
    the card, in ``state``."""
    from ..ops import smith_waterman as sw
    state["dp"] = sw.sw_pointers(*inputs, params)
    sync(device)


def run_tb(device, max_steps: int, state: dict) -> None:
    """K3 over ``state``'s pointers; packed ops, coordinates and best in
    ``state``."""
    from ..ops import smith_waterman as sw
    state["tb"] = sw.sw_traceback(*state["dp"], max_steps)
    sync(device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lanes", nargs="?", type=int, default=B)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..ops import smith_waterman as sw
    from ..ops.sw_ref import SWParams
    from .wgs_rehearsal import Measured, card_label
    device = resolve_device(args.device)
    n = args.lanes
    reads, rl, wins, wl = lanes(n, np.random.default_rng(0))
    params = SWParams()
    bucket = sw.SWBucket(max_read_len=R, max_win_len=W, device=device)
    max_steps = R + W           # as _sw_extend_dispatch_one
    print(f"device={device} B={n} bucket={R}x{W}")

    ms = {}

    def timed(name, fn):
        ms[name] = round(t(name, fn) * 1e3, 3)

    want, got, state = [], [], {}
    with Measured(device) as measured:
        # ---- end to end ------------------------------------------------
        timed("sw_extend_batch e2e", lambda: want.__setitem__(
            slice(None), sw.sw_extend_batch(reads, rl, wins, wl, params,
                                            bucket)))
        # ---- parts -----------------------------------------------------
        host = pack(reads, rl, wins, wl)
        timed("host pack", lambda: pack(reads, rl, wins, wl))
        timed("host -> card copy",
              lambda: sync(device, [x.to(device) for x in host]))
        inputs = [x.to(device) for x in host]
        timed("K2 sw_pointers (ptrs on card)",
              lambda: run_dp(device, inputs, params, state))
        timed("K3 sw_traceback", lambda: run_tb(device, max_steps, state))
        timed("card -> host copy",
              lambda: [x.cpu().numpy() for x in state["tb"]])
        packed, coords, best = (x.cpu().numpy() for x in state["tb"])
        timed("host decode (_results_from_packed)", lambda: got.__setitem__(
            slice(None), sw._results_from_packed(packed, max_steps, coords,
                                                 best, rl)))
    equal = got == want
    print(json.dumps({"lanes": n, "bucket": [R, W], "ms": ms,
                      "parts_equal_sw_extend_batch": equal,
                      "peak_device_gb": measured.row(n)["peak_device_gb"],
                      "launches": measured.launches,
                      "card": card_label(device)}))
    if not equal:
        print("the composed parts differ from sw_extend_batch",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
