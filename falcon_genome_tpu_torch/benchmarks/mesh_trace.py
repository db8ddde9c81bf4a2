"""The mesh PairHMM dispatch traced and timed on NVIDIA GPUs, for several
checkouts of the port.

    python -m falcon_genome_tpu_torch.benchmarks.mesh_trace ROOT [ROOT ...]

Each ROOT is a checkout of the repository (an unpacked ``git archive`` of
another commit, say).  In the order given, each runs in a process of its
own with ROOT first on ``sys.path``, builds that checkout's kernels, and
runs six cases at HaplotypeCaller's bucket (R=160, H=384; reads cut from
their haplotypes with 4% substitutions, base qualities 10-40, BI/BD-like
insertion and deletion planes) on a mesh of 4 shards over the visible
cards (``cuda:(i % count)``, ``chip_smoke.py``'s phase 6a), at each size
of :data:`SIZES`: 8192 pairs, and the median pairs of a PairHMM call of
1 Mb ``mutect2`` and of 1 Mb ``germline`` (``benchmarks/call_sizes.py``):

* ``one_k5``: one K5 call (``pairhmm_pb``) on device tensors, no mesh;
* ``step``: ``sharded_pairhmm_step`` on the same tensors;
* ``logp_one`` / ``logp_mesh``: ``pairhmm_logp`` with planes from host
  arrays, without and under the mesh;
* ``pairs_one`` / ``pairs_mesh``: ``pairhmm_logp_pairs`` on a cross
  product of reads and haplotypes (128 x 64 at 8192 pairs), without and
  under the mesh.

Per case: ``ms``, the median of 50 calls after a warm-up, each timed with
CUDA events on ``cuda:0`` and waited for on every card; ``host_ms``, the
median host time until the call returns (what the host spends enqueueing
the step; the host-array cases read their results back, so theirs
include the wait); and, from ``torch.profiler`` over 3 calls, per card
the kernels, the copies by kind (host to device, device to host, device
to device) with their counts and device ms, the card's busy ms (the
union of its events), its idle share of the traced span and its longest
idle gap (``trace``; null where the profiler recorded no device event).
Every case is checked bit-equal to its no-mesh twin, and each size gets
the ratios of the mesh cases to their twins (``ratios``).  Each root also
times one K4 call on one card at 512, 1024, ..., 8192 pairs
(``one_k4_ms_by_pairs``): the steps of that curve are the kernel's waves,
and a split over cards pays only where a card's share of a call runs
longer than its dispatch (``parallel.mesh``).  Give the
roots as parent, change, change, parent.  Prints one JSON line per run,
with the number of visible cards, after one with the cards' names and
power limits; without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

R, H = 160, 384
# pairs of a call: haplotypes of its cross product.  7604 and 4656 are the
# median pairs of a PairHMM call of 1 Mb mutect2 (491 calls) and 1 Mb
# germline (32 calls) on an H100 (benchmarks/call_sizes.py); their
# chunks hold several regions of a few haplotypes each, so 4 a read here
SIZES = {8192: 64, 7604: 4, 4656: 4}
N_TIMED = 50
N_TRACED = 3
SHARDS = 4


def _intervals_ms(spans) -> tuple[float, float]:
    """(union length, longest gap) of (start, end) microsecond spans, in
    ms."""
    busy, gap, cur = 0.0, 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gap = max(gap, a - cur[1])
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e3, gap / 1e3


def _copy_kind(name: str) -> str:
    for kind in ("HtoD", "DtoH", "DtoD", "PtoP"):
        if kind in name:
            return kind
    return "other"


def trace_summary(fn, calls: int = N_TRACED) -> dict | None:
    """``fn`` run ``calls`` times under ``torch.profiler``: per card
    (``args.device`` of the Chrome trace's device events) the kernels and
    copies with their device ms, the busy ms, the idle share of the span
    from the first traced event to the last and the longest idle gap;
    host ms per call.  None where no device event was recorded."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        host = (time.perf_counter() - t0) * 1e3 / calls
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    dev = [e for e in timed
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return None
    start = min(float(e["ts"]) for e in timed)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed)
    cards: dict[str, dict] = {}
    for e in dev:
        card = str(e.get("args", {}).get("device", e.get("pid")))
        c = cards.setdefault(card, {"kernels": 0, "kernel_ms": 0.0,
                                    "copies": {}, "spans": []})
        ms = float(e.get("dur", 0)) / 1e3
        c["spans"].append((float(e["ts"]),
                           float(e["ts"]) + float(e.get("dur", 0))))
        if e.get("cat") == "kernel":
            c["kernels"] += 1
            c["kernel_ms"] += ms
        else:
            kind = _copy_kind(e.get("name", ""))
            n, t = c["copies"].get(kind, (0, 0.0))
            c["copies"][kind] = (n + 1, t + ms)
    span = (end - start) / 1e3
    out = {"calls": calls, "host_ms_per_call": host, "span_ms": span,
           "cards": {}}
    for card, c in sorted(cards.items()):
        busy, gap = _intervals_ms(c.pop("spans"))
        out["cards"][card] = {
            "kernels_per_call": c["kernels"] / calls,
            "kernel_ms_per_call": c["kernel_ms"] / calls,
            "copies_per_call": {k: [n / calls, t / calls]
                                for k, (n, t) in sorted(c["copies"].items())},
            "busy_ms": busy, "idle_share": 1.0 - busy / span,
            "longest_gap_ms": gap}
    return out


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn) -> tuple[float, float]:
    """(median CUDA-event ms on cuda:0, median host ms to return) of
    ``fn`` over N_TIMED calls after a warm-up, each waited for."""
    fn()
    _sync_all()
    ms, host = [], []
    for _ in range(N_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(0):
            a.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            b.record()
        _sync_all()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms), statistics.median(host)


def inputs(rng, B: int):
    """Batch-major host arrays (reads, q, ins, del, gcp, rlen, haps, hlen)
    of B pairs at R x H."""
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    rl = rng.integers(R // 2, R + 1, B).astype(np.int32)
    hl = rng.integers(R, H + 1, B).astype(np.int32)
    for b in range(B):
        s = int(rng.integers(0, hl[b] - rl[b] + 1))
        seg = haps[b, s:s + rl[b]].copy()
        m = rng.random(rl[b]) < 0.04
        seg[m] = (seg[m] + 1) % 4
        reads[b, :rl[b]] = seg
    q = rng.integers(10, 41, (B, R)).astype(np.uint8)
    pad = np.arange(R)[None, :] >= rl[:, None]
    ins = rng.integers(25, 46, (B, R)).astype(np.uint8)
    dele = rng.integers(25, 46, (B, R)).astype(np.uint8)
    gcp = np.full((B, R), 10, np.uint8)
    for x in (ins, dele, gcp):
        x[pad] = 0
    return reads, q, ins, dele, gcp, rl, haps, hl


def cases(P, TP, mesh, dev, B: int, nh: int, rng):
    """The six cases at B pairs (a cross product of B // nh reads and nh
    haplotypes for the pairs), and each mesh case's no-mesh twin."""
    host = inputs(rng, B)
    reads, q, ins, dele, gcp, rl, haps, hl = host
    read_t, q_t, ins_t, del_t, gcp_t, rl_t, hap_t, hl_t = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in host)
    params = P.PairHMMParams(max_read_len=R, max_hap_len=H, device=dev)
    step = TP.sharded_pairhmm_step(mesh, R, H)
    nr = B // nh
    pr = np.repeat(np.arange(nr), nh)
    ph = np.tile(np.arange(nh), nr)

    def one_k5():
        return P.pairhmm_pb(read_t, q_t, ins_t, del_t, gcp_t, rl_t, hap_t,
                            hl_t)

    def sharded():
        return step(read_t, q_t, ins_t, del_t, gcp_t, rl_t, hl_t, hap_t)

    def logp():
        return P.pairhmm_logp(reads, q, ins, dele, gcp, rl, haps, hl,
                              params)

    def pairs():
        return P.pairhmm_logp_pairs(reads[:nr], q[:nr], rl[:nr], haps[:nh],
                                    hl[:nh], pr, ph, 45, 45, 10, params)

    def meshed(fn):
        def call():
            with TP.use_mesh(mesh):
                return fn()
        return call

    return ({"one_k5": one_k5, "step": sharded,
             "logp_one": logp, "logp_mesh": meshed(logp),
             "pairs_one": pairs, "pairs_mesh": meshed(pairs)},
            {"step": "one_k5", "logp_mesh": "logp_one",
             "pairs_mesh": "pairs_one"})


def measure(P, TP, mesh, dev, B: int, nh: int, trace: bool = True) -> dict:
    """Every case at B pairs timed (and traced where ``trace``), checked
    bit-equal to its twin, with the mesh cases' ratios to their twins."""
    run, twins = cases(P, TP, mesh, dev, B, nh, np.random.default_rng(11))
    res, outs = {"B": B, "haps": nh}, {}
    for name, fn in run.items():
        with TP.use_mesh(None):
            out = fn()
            _sync_all()
            outs[name] = (out.cpu().numpy() if isinstance(out, torch.Tensor)
                          else out)
            ms, host_ms = timed(fn)
            res[name] = {"ms": ms, "host_ms": host_ms,
                         "trace": trace_summary(fn) if trace else None}
    res["ratios"] = {}
    for name, twin in twins.items():
        res[name]["bit_equal"] = bool(np.array_equal(outs[name],
                                                     outs[twin]))
        res["ratios"][f"{name}/{twin}"] = res[name]["ms"] / res[twin]["ms"]
    return res


def k4_by_pairs(P, dev) -> dict[int, float]:
    """ms of one K4 call (``pairhmm_sc``, 45/45/10) on device tensors at
    512, 1024, ..., 8192 pairs."""
    host = inputs(np.random.default_rng(12), 8192)
    reads, q, rl, haps, hl = (torch.from_numpy(np.ascontiguousarray(x)).to(
        dev) for x in (host[0], host[1], host[5], host[6], host[7]))
    return {n: timed(lambda: P.pairhmm_sc(reads[:n], q[:n], rl[:n],
                                          haps[:n], hl[:n], 45, 45, 10))[0]
            for n in range(512, 8193, 512)}


def run_root(root: Path) -> dict:
    """Build ``root``'s kernels and run the six cases at every size of
    :data:`SIZES` (this process imports only ``root``'s package)."""
    sys.path.insert(0, str(root))
    from falcon_genome_tpu_torch import parallel as TP
    from falcon_genome_tpu_torch.ops import _build
    from falcon_genome_tpu_torch.ops import pairhmm as P
    if not Path(P.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {P.__file__}, not {root}'s package")
    _build.load()
    count = torch.cuda.device_count()
    devs = [torch.device("cuda", i % count) for i in range(SHARDS)]
    mesh = TP.make_mesh(TP.MeshSpec(data=SHARDS, region=1), devs)
    return {"root": str(root), "visible_cards": count,
            "devices": [str(d) for d in devs],
            "card": torch.cuda.get_device_name(0), "R": R, "H": H,
            "one_k4_ms_by_pairs": k4_by_pairs(P, devs[0]),
            "sizes": {str(B): measure(P, TP, mesh, devs[0], B, nh)
                      for B, nh in SIZES.items()}}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("mesh_trace: no CUDA device; it traces the card's dispatch "
              "and has no CPU mode", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_root(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print("usage: mesh_trace ROOT [ROOT ...]", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"nvidia_smi": smi.stdout.strip().splitlines()}),
          flush=True)
    rc = 0
    for root in argv:   # a root that fails is reported, the others still run
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", root],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            print(json.dumps({"root": root, "error": res.returncode}),
                  flush=True)
            rc = 1
            continue
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
