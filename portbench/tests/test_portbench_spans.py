"""The readers of the entry's spans and of the kernel library's load, on
synthetic contexts: their figures, and None wherever they have nothing
to read."""
import sys
import types

import pytest

import harness
from falcon_genome_tpu_torch.ops import _build
from falcon_genome_tpu_torch.utils import spans

ENTRY = ("entry_tables_ms.likelihood", "entry_enqueue_ms.likelihood",
         "entry_wait_ms.likelihood", "entry_wait_cpu_ms.likelihood")
MS = 1_000_000
# per step: its wall ms a call, and its CPU ms (the program reads the
# CPU clock in the wait alone)
STEPS = {"pairhmm.tables": (2, 1), "pairhmm.copy_in": (1, 1),
         "pairhmm.gather": (0.5, 0.5), "pairhmm.launch": (0.25, 0.25),
         "pairhmm.wait": (8, 6), "pairhmm.free": (3, 1)}


def recorded(n_calls, extra=()):
    """``n_calls`` calls of the entry's spans, on two threads."""
    out = []
    ids = iter(range(1, 10_000))
    for c in range(1, n_calls + 1):
        t = 100 * MS * c
        top = next(ids)
        steps = []
        for name, (wall, cpu) in STEPS.items():
            timed = int(cpu * MS) if name == "pairhmm.wait" else None
            steps.append(spans.Span(name, t, t + int(wall * MS), timed,
                                    c % 2, c, next(ids), top, {}))
            t += int(wall * MS)
        out.append(spans.Span("pairhmm.call", 100 * MS * c, t, 0, c % 2, c,
                              top, None, {"pairs": 8}))
        out += steps
    return out + list(extra)


def context(n_records, unit="pairs"):
    traced = types.SimpleNamespace(records=[object()] * n_records)
    return types.SimpleNamespace(service=types.SimpleNamespace(unit=unit),
                                 traced=traced)


def forget(monkeypatch, package: str, module: str) -> None:
    """Make ``from package import module`` fail, as in a program that
    lacks the module."""
    monkeypatch.delattr(sys.modules[package], module)
    monkeypatch.setitem(sys.modules, f"{package}.{module}", None)


@pytest.fixture
def program(monkeypatch):
    held = []
    monkeypatch.setattr(spans, "spans", lambda: list(held))
    return held


def test_entry_readers(program):
    program += recorded(4)
    ctx = context(4)
    got = {m: harness.metric_reader(m)(ctx) for m in ENTRY}
    assert got == pytest.approx({
        "entry_tables_ms.likelihood": 2.0,
        "entry_enqueue_ms.likelihood": 1.75,
        "entry_wait_ms.likelihood": 8.0,
        "entry_wait_cpu_ms.likelihood": 6.0})


@pytest.mark.parametrize("case", ["unit", "fewer_spans", "more_spans",
                                  "no_calls", "no_spans", "no_program"])
def test_entry_readers_none(case, program, monkeypatch):
    """None in a cell that delivers no pairs, where the call spans are
    not the traced window's calls, and with a program that records no
    spans (its parent, say)."""
    program += recorded(0 if case == "no_spans" else 4)
    n, unit = 4, "pairs"
    if case == "unit":
        unit = "reads"
    elif case == "fewer_spans":
        n = 5
    elif case == "more_spans":
        n = 3
    elif case == "no_calls":
        n = 0
    elif case == "no_program":
        forget(monkeypatch, "falcon_genome_tpu_torch.utils", "spans")
    ctx = context(n, unit)
    for m in ENTRY:
        assert harness.metric_reader(m)(ctx) is None, m


def test_entry_readers_need_one_span_per_call(program):
    """A second ``pairhmm.call`` span in one call (a nested call) does
    not pass for the window's calls."""
    program += recorded(4)
    twin = next(s for s in program if s.name == "pairhmm.call")
    program.append(twin)
    assert harness.metric_reader("entry_wait_ms.likelihood")(
        context(4)) is None


def test_wait_cpu_reader_needs_the_cpu_clock(program):
    """The wait's CPU time is None where the program did not read the
    CPU clock in the wait; its wall time still reads."""
    program += [s if s.name != "pairhmm.wait" else
                spans.Span(s.name, s.start_ns, s.end_ns, None, s.thread,
                           s.call, s.id, s.parent, s.attrs)
                for s in recorded(4)]
    ctx = context(4)
    assert harness.metric_reader("entry_wait_cpu_ms.likelihood")(ctx) is None
    assert harness.metric_reader("entry_wait_ms.likelihood")(ctx) == \
        pytest.approx(8.0)


def test_setup_kernels_reader(monkeypatch):
    read = harness.metric_reader("setup_kernels_s")
    monkeypatch.setattr(_build, "LOAD", {"loads": 1, "seconds": 0.125,
                                         "builds": 0})
    assert read(context(4)) == 0.125
    monkeypatch.setattr(_build, "LOAD", {"loads": 0, "seconds": 0.0,
                                         "builds": 0})
    assert read(context(4)) is None
    monkeypatch.delattr(_build, "LOAD")
    assert read(context(4)) is None
    forget(monkeypatch, "falcon_genome_tpu_torch.ops", "_build")
    assert read(context(4)) is None
