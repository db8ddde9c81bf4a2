"""The Python heap of one command, traced: which source lines hold memory
at its peak.

Runs a module as ``python -m MODULE ARGS...`` would, in this process,
with :mod:`tracemalloc` on.  tracemalloc sees Python's own allocations
and numpy's arrays; it does not see torch's tensors or an XLA runtime's
buffers.  A thread reads the traced total every :data:`PERIOD` seconds
and takes a snapshot whenever the total passes its high mark by 5%.  At
the end the probe reports the peak traced bytes, the bytes still traced,
the :data:`TOP` source lines that held most at the highest snapshot (paths
relative to the working directory or to ``site-packages``, so two
packages' lines compare), and ``RssAnon`` beside the traced bytes, so
that what tracemalloc cannot see shows as the difference: at that
snapshot, and at the read where the untraced part (``RssAnon`` over its
start, less the traced bytes) was largest.

Usage:
    python -m falcon_genome_tpu_torch.benchmarks.traced_run
        [--out PATH] -- MODULE ARGS...
"""
from __future__ import annotations

import argparse
import json
import runpy
import sys
import threading
import time
import tracemalloc
from pathlib import Path

from .rss_probe import gb_of_bytes, proc_status, smaps_parts

# seconds between reads of the traced total and of RssAnon
PERIOD = 0.5
# the snapshot is retaken when the traced total passes its mark by this
GROWTH = 1.05
# source lines reported at the highest snapshot
TOP = 15


def rss_anon_gb() -> float | None:
    """This process's ``RssAnon`` (GB), from ``smaps`` where the status
    lacks it."""
    st = proc_status()
    if "RssAnon" in st:
        return round(st["RssAnon"] / 1e6, 4)
    parts = smaps_parts()
    return None if parts is None else round(parts["anon"] / 1e6, 4)


def top_lines(snap: tracemalloc.Snapshot, n: int) -> list[dict]:
    """The ``n`` source lines holding most in ``snap``: the path from the
    package root (the first directory of a ``site-packages`` or of the
    working directory's tree), line, GB and blocks."""
    cwd = Path.cwd().resolve()
    out = []
    for stat in snap.statistics("lineno")[:n]:
        frame = stat.traceback[0]
        path = Path(frame.filename)
        try:
            rel = str(path.resolve().relative_to(cwd))
        except ValueError:
            parts = path.parts
            rel = ("/".join(parts[parts.index("site-packages") + 1:])
                   if "site-packages" in parts else str(path))
        out.append({"line": f"{rel}:{frame.lineno}",
                    "gb": gb_of_bytes(stat.size), "blocks": stat.count})
    return out


def traced(module: str, args: list[str]) -> dict:
    """Run ``module`` as ``__main__`` with ``args`` under tracemalloc (see
    the module's docstring)."""
    stop = threading.Event()
    best: dict = {"traced": 0}
    untraced: dict = {}

    def watch():
        while not stop.wait(PERIOD):
            cur = tracemalloc.get_traced_memory()[0]
            anon = rss_anon_gb()
            t_s = round(time.perf_counter() - t0, 2)
            if None not in (anon, anon0):
                extra = round(anon - anon0 - gb_of_bytes(cur), 4)
                if extra > untraced.get("untraced_anon_gb", -1e9):
                    untraced.update(t_s=t_s, anon_gb=anon,
                                    traced_gb=gb_of_bytes(cur),
                                    untraced_anon_gb=extra)
            if cur > best["traced"] * GROWTH:
                best.update(traced=cur, snap=tracemalloc.take_snapshot(),
                            anon_gb=rss_anon_gb(), t_s=t_s)

    argv = sys.argv
    sys.argv = [module, *args]
    anon0 = rss_anon_gb()
    tracemalloc.start()
    t0 = time.perf_counter()
    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    rc = 0
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                     else 1)
    finally:
        stop.set()
        thread.join()
        sys.argv = argv
    wall = time.perf_counter() - t0
    cur, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    snap = best.get("snap")
    return {"argv": [module, *args], "rc": rc, "wall_s": round(wall, 2),
            "anon_start_gb": anon0,
            "traced_peak_gb": gb_of_bytes(peak),
            "traced_end_gb": gb_of_bytes(cur),
            "untraced_peak": untraced or None,
            "at_snapshot": None if snap is None else {
                "t_s": best["t_s"], "traced_gb": gb_of_bytes(best["traced"]),
                "anon_gb": best["anon_gb"],
                "untraced_anon_gb": (None if best["anon_gb"] is None
                                     or anon0 is None else round(
                                         best["anon_gb"] - anon0
                                         - gb_of_bytes(best["traced"]), 4)),
                "top": top_lines(snap, TOP)}}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" not in argv:
        raise SystemExit("traced_run: the module follows --")
    i = argv.index("--")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="JSON of the result")
    args = ap.parse_args(argv[:i])
    rest = argv[i + 1:]
    if not rest:
        raise SystemExit("traced_run: no module after --")
    doc = traced(rest[0], rest[1:])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc), flush=True)
    return doc["rc"]


if __name__ == "__main__":
    sys.exit(main())
