"""Reading a ``torch.profiler`` trace of one window.

The profiler's Chrome trace is written to a temporary directory (under
``TMPDIR``), read back and deleted.  Device events are kernels, copies and
sets (``cat`` kernel, gpu_memcpy, gpu_memset); the window is the span of
the harness's own ``portbench.window`` annotation.  A card's busy time
is the union of its device events' intervals inside the window
(``benchmarks/idle_share.py``'s arithmetic, per card).  An idle gap is
named by the CUDA runtime call the host was in at its midpoint, or
"host" where it was in none.
"""
from __future__ import annotations

import heapq
import json
import re
import shutil
import tempfile
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


class Trace:
    """Device and host events of one traced window (seconds, on the
    trace's clock)."""

    def __init__(self, events: list[dict]):
        timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
        marks = [e for e in timed if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError("the trace holds no window annotation")
        m = marks[0]
        self.t0 = float(m["ts"]) * 1e-6
        self.t1 = self.t0 + float(m.get("dur", 0)) * 1e-6
        self.device: list[tuple[str, float, float, str, str]] = []
        self.runtime: list[tuple[float, float, str]] = []
        for e in timed:
            a = float(e["ts"]) * 1e-6
            b = a + float(e.get("dur", 0)) * 1e-6
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                card = str(e.get("args", {}).get("device", e.get("pid")))
                self.device.append((e.get("name", ""), a, b, card, cat))
            elif cat == "cuda_runtime" or cat == "cuda_driver":
                self.runtime.append((a, b, e.get("name", "")))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def cards(self) -> list[str]:
        return sorted({c for _, _, _, c, _ in self.device})

    def merged(self, card: str) -> list[list[float]]:
        spans = sorted((a, b) for _, a, b, c, _ in self.device if c == card)
        out: list[list[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self, card: str) -> float:
        return sum(b - a for a, b in self.merged(card))

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b, _, cat in self.device
                   if cat == "kernel" and rx.search(n))

    def top_ops(self, n: int = 10) -> list[list]:
        by = defaultdict(float)
        for name, a, b, _, _ in self.device:
            by[short_name(name)] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def top_gaps(self, n: int = 10) -> list[list]:
        """Idle time of every card, summed by what the host was doing at
        each gap's midpoint: the CUDA runtime call that began last among
        those in progress, or "host"."""
        gaps = []
        for card in self.cards():
            edges = [self.t0]
            for a, b in self.merged(card):
                edges += [a, b]
            edges.append(self.t1)
            gaps += [((a + b) / 2, b - a)
                     for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort()
        runtime = sorted(self.runtime)
        live: list[tuple[float, float, str]] = []     # (end, start, name)
        k = 0
        by = defaultdict(float)
        for mid, length in gaps:
            while k < len(runtime) and runtime[k][0] <= mid:
                a, b, name = runtime[k]
                heapq.heappush(live, (b, a, name))
                k += 1
            while live and live[0][0] < mid:
                heapq.heappop(live)
            label = max(live, key=lambda x: x[1])[2] if live else "host"
            by[label] += length
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


def card_busy_s(prof) -> dict[int, float]:
    """Each card's busy seconds over a whole stopped profile: the union
    of its kernels', copies' and sets' intervals, read from the
    profiler's events in memory (a profile of many seconds would make a
    Chrome trace of hundreds of megabytes)."""
    from torch.autograd import DeviceType
    spans = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            spans[e.device_index()].append((e.start_ns(),
                                            e.start_ns() + e.duration_ns()))
    busy = {}
    for card, iv in spans.items():
        iv.sort()
        total, end = 0, None
        for a, b in iv:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        busy[card] = total * 1e-9
    return busy


def read(prof) -> Trace:
    """The window's events from a stopped ``torch.profiler.profile``."""
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Trace(events)
