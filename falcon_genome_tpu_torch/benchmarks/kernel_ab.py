"""PairHMM kernel times of several checkouts of the port, interleaved on
one NVIDIA GPU.

    python -m falcon_genome_tpu_torch.benchmarks.kernel_ab ROOT [ROOT ...]

Each ROOT is a checkout of the repository (an unpacked ``git archive`` of
another commit, say).  In the order given, each runs in a process of its
own with ROOT first on ``sys.path``: it builds that checkout's kernels,
then times its PairHMM kernels K4 (``pairhmm_sc``, 45/45/10) and K5
(``pairhmm_pb``, per-base planes) at HaplotypeCaller's shape (R=160,
H=384, 8192 pairs, the inputs of ``chip_smoke.py``'s phase 3 without its
crafted pairs), each through its wrapper, three ways.  ``k4_ms`` and
``k5_ms``: CUDA events around each of 20 calls after a warm-up, each call
waited for, the median (what a caller that reads every result back sees,
the wrapper's host work included).  ``k4_queued_ms`` and ``k5_queued_ms``:
events around 20 calls queued back to back, per call, the median of 5
such runs (the device's time per call once the host runs ahead).
``k4_kernel_ms`` and ``k5_kernel_ms``: the PairHMM kernel's own device
time per launch from ``torch.profiler`` over 5 calls (null where the
profiler records no device time).  Give the roots as parent, change,
change, parent, so that drift of the card between runs shows.  Prints one
JSON line per run; without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

B, R, H = 8192, 160, 384
N_TIMED = 20


def inputs(rng):
    """Lane-major K5 arguments (read, q, ins, del, gcp, rlen, hap, hlen):
    reads cut from their haplotypes with 1% substitutions, an eighth of
    them unrelated, base qualities 10-40, indel phreds 25-45, gcp 10."""
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    hl = rng.integers(250, H + 1, B).astype(np.int32)
    rlen = rng.integers(100, 153, B).astype(np.int32)
    reads = np.full((B, R), 4, np.uint8)
    for b in range(B):
        s = int(rng.integers(0, hl[b] - rlen[b]))
        seg = haps[b, s:s + rlen[b]].copy()
        m = rng.random(rlen[b]) < 0.01
        seg[m] = (seg[m] + 1) % 4
        reads[b, :rlen[b]] = seg
    unrelated = rng.random(B) < 0.125
    reads[unrelated] = rng.integers(0, 4, (int(unrelated.sum()), R))
    rlen[unrelated] = 150
    quals = rng.integers(10, 41, (B, R)).astype(np.uint8)
    pad = np.arange(R)[None, :] >= rlen[:, None]
    ins = rng.integers(25, 46, (B, R)).astype(np.uint8)
    dele = rng.integers(25, 46, (B, R)).astype(np.uint8)
    gcp = np.full((B, R), 10, np.uint8)
    for x in (ins, dele, gcp):
        x[pad] = 0
    return reads, quals, ins, dele, gcp, rlen, haps, hl


def event_ms(fn, calls: int) -> float:
    """Milliseconds between CUDA events around ``calls`` calls of ``fn``
    queued back to back; the last one is waited for."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def median_ms(fn) -> float:
    """One call at a time, each waited for: the median of N_TIMED."""
    fn()
    return statistics.median(event_ms(fn, 1) for _ in range(N_TIMED))


def queued_ms(fn) -> float:
    """N_TIMED calls back to back, per call: the median of 5 such runs."""
    fn()
    return statistics.median(event_ms(fn, N_TIMED) / N_TIMED
                             for _ in range(5))


def kernel_ms(fn) -> float | None:
    """Device time per launch of the kernels named ``pairhmm_kernel``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "pairhmm_kernel" in e.key and e.count:
            us = getattr(e, "device_time_total", None) or \
                getattr(e, "cuda_time_total", 0)
            return us / e.count / 1e3 if us else None
    return None


def time_root(root: Path) -> dict:
    """Build ``root``'s kernels and time its K4 and K5 (this process
    imports only ``root``'s package)."""
    sys.path.insert(0, str(root))
    from falcon_genome_tpu_torch.ops import _build
    from falcon_genome_tpu_torch.ops import pairhmm as P
    if not Path(P.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {P.__file__}, not {root}'s package")
    _build.build()
    dev = torch.device("cuda", 0)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in inputs(np.random.default_rng(7))]
    read, q, ins, dele, gcp, rlen, hap, hlen = t

    def k4():
        return P.pairhmm_sc(read, q, rlen, hap, hlen, 45, 45, 10)

    def k5():
        return P.pairhmm_pb(read, q, ins, dele, gcp, rlen, hap, hlen)

    return {"root": str(root), "k4_ms": median_ms(k4),
            "k5_ms": median_ms(k5), "k4_queued_ms": queued_ms(k4),
            "k5_queued_ms": queued_ms(k5), "k4_kernel_ms": kernel_ms(k4),
            "k5_kernel_ms": kernel_ms(k5)}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; it times the card's kernels and "
              "has no CPU mode", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_root(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print("usage: kernel_ab ROOT [ROOT ...]", file=sys.stderr)
        return 2
    for root in argv:
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", root],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
