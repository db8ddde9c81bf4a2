"""The benchmark's moving parts: a cell's files, its service, the caller
threads and the window, the checks and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
``configs/<config>.json`` and ``traffic/<traffic>.json`` are read by
name; the traffic names its generator, ``gen/<generator>.py``, whose
``Service`` makes the pool of calls from the seed and calls the
program's entries.  A per-layer metric is ``metrics/<metric>.py``, whose
``read(ctx)`` returns a number or None.

A service has ``unit`` (what a call delivers), ``depth`` (calls a caller
keeps in flight), ``pool`` (the calls), ``units(i)``, ``submit(i)`` and
``complete(handle)`` (the program's entries and nothing else),
``release()`` (drops the program's state), ``kernel_work(i)`` (per
kernel, the operations and bytes of call i) and ``compare(samples,
control)`` (the checks, each a name, a value and its limit).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import random
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, overrides: dict | None = None,
              workload: dict | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its configuration and
    traffic (``overrides`` replaces keys of either; ``workload`` stands for
    an entry that BENCHMARK.json does not hold: tests only)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload is not None:
        cells[name] = workload
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = json.loads((HERE / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    for key, val in (overrides or {}).items():
        (config if key in config else traffic)[key] = val

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in spec["end_to_end"] if mine(m)],
                [m for m in spec["per_layer"] if mine(m)])


def make_service(cell: Cell, seed: int, devices):
    gen = importlib.import_module(f"gen.{cell.traffic['generator']}")
    return gen.Service(cell.config, cell.traffic, seed, devices)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Record:
    thread: int
    item: int
    t_submit: float
    t_done: float
    units: int
    cpu_ns: int         # the caller thread's CPU time inside the entries


@dataclasses.dataclass
class Window:
    t_start: float
    seconds: float
    records: list
    samples: list           # (item, output) drawn from the seed
    errors: list

    @property
    def t_end(self) -> float:
        return self.t_start + self.seconds

    def done(self) -> list:
        """Calls whose results reached their caller inside the window."""
        return [r for r in self.records if r.t_done <= self.t_end]


def call_order(n_items: int, seed: int, thread: int) -> list[int]:
    """Thread ``thread``'s order over the pool, from the seed."""
    return list(np.random.default_rng([seed, thread]).permutation(n_items))


def warm(svc, threads: int, sync) -> None:
    """Every call of the pool once, from all caller threads at once, so
    that every shape of the cell has been run and every cache filled
    before the window."""
    def work(t):
        for i in range(t, len(svc.pool), threads):
            svc.complete(svc.submit(i))

    ts = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    sync()


def run_window(svc, threads: int, seconds: float, seed: int,
               sample_per_thread: int, pass_no: int = 0) -> Window:
    """Caller threads in a closed loop over the pool for ``seconds``.

    Each keeps ``svc.depth`` calls in flight and submits no new one once
    the window has closed; the calls still in flight then complete.  A
    reservoir of each thread's calls that completed inside the window,
    drawn from the seed, keeps their outputs for the check."""
    go = threading.Event()
    win = Window(0.0, seconds, [], [], [])
    lock = threading.Lock()

    def work(t):
        order = call_order(len(svc.pool), seed + pass_no, t)
        pick = random.Random(f"{seed}/{pass_no}/{t}")
        kept: list = []
        seen = 0
        mine: list = []
        flight: deque = deque()
        n = 0
        go.wait()
        t_end = win.t_end
        try:
            while True:
                if time.perf_counter() < t_end:
                    i = int(order[n % len(order)])
                    n += 1
                    c0 = time.thread_time_ns()
                    t0 = time.perf_counter()
                    h = svc.submit(i)
                    flight.append((t0, i, h, time.thread_time_ns() - c0))
                    if len(flight) < svc.depth:
                        continue
                elif not flight:
                    break
                t0, i, h, cpu = flight.popleft()
                c0 = time.thread_time_ns()
                out = svc.complete(h)
                cpu += time.thread_time_ns() - c0
                t1 = time.perf_counter()
                mine.append(Record(t, i, t0, t1, svc.units(i), cpu))
                if t1 <= t_end:
                    seen += 1
                    if len(kept) < sample_per_thread:
                        kept.append((i, out))
                    else:
                        k = pick.randrange(seen)
                        if k < sample_per_thread:
                            kept[k] = (i, out)
        except Exception as e:          # a failed call fails the run
            with lock:
                win.errors.append(f"thread {t}: {type(e).__name__}: {e}")
        with lock:
            win.records.extend(mine)
            win.samples.extend(kept)

    ts = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    win.t_start = time.perf_counter()
    go.set()
    for t in ts:
        t.join()
    return win


def end_to_end(cell: Cell, win: Window, setup_s: float, card_s, unit_metric:
               str) -> dict:
    """The set-up time, and the units of every call of the window over
    the seconds in which the cards were busy with them (none without a
    profile of the cards)."""
    values = {"setup_s": setup_s}
    if card_s:
        values[unit_metric] = sum(r.units for r in win.records) / card_s
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""
    cell: Cell
    service: object
    window: Window          # the untraced window
    traced: Window          # the traced window (every call in it whole)
    trace: object           # devtrace.Trace of the traced window


def per_layer(cell: Cell, ctx: Context) -> dict:
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules(mods) -> list[str]:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name."""
    banned = {"jax", "jaxlib", "flax", "falcon_genome_tpu"}
    return sorted(m for m in mods if m.split(".")[0] in banned)

