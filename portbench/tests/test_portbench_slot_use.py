"""The reader of K4's slot use, on synthetic spans: its figure, and None
wherever it has nothing to read."""
import types

import pytest

import harness
from falcon_genome_tpu_torch.utils import spans

READ = harness.metric_reader("k4_slot_use.likelihood")
MS = 1_000_000


def recorded(counts, extra=()):
    """One call a (cells, slots) pair of ``counts`` (None: a launch span
    without them), each a ``pairhmm.call`` span and its launch."""
    out = []
    for c, work in enumerate(counts, start=1):
        t = 100 * MS * c
        attrs = {} if work is None else {"pairs": 8, "fitted": 8,
                                         "cells": work[0],
                                         "slots": work[1]}
        out += [spans.Span("pairhmm.call", t, t + 10 * MS, 0, c % 2, c,
                           2 * c, None, {"pairs": 8}),
                spans.Span("pairhmm.launch", t + MS, t + 2 * MS, None,
                           c % 2, c, 2 * c + 1, 2 * c, attrs)]
    return out + list(extra)


def context(n_records, unit="pairs"):
    traced = types.SimpleNamespace(records=[object()] * n_records)
    return types.SimpleNamespace(service=types.SimpleNamespace(unit=unit),
                                 traced=traced)


@pytest.fixture
def program(monkeypatch):
    held = []
    monkeypatch.setattr(spans, "spans", lambda: list(held))
    return held


def test_slot_use(program):
    """Cells over slots summed over the window's launches, not the mean
    of each launch's share."""
    program += recorded([(470, 1000), (600, 1000), (30, 200)])
    assert READ(context(3)) == pytest.approx(100 * 1100 / 2200)


def test_launch_of_another_call_is_not_read(program):
    """A launch span outside the window's calls (no ``pairhmm.call``
    span of its own) is left out."""
    stray = spans.Span("pairhmm.launch", 0, MS, None, 5, 99, 999, None,
                       {"cells": 1, "slots": 1000})
    program += recorded([(500, 1000)], extra=[stray])
    assert READ(context(1)) == pytest.approx(50.0)


@pytest.mark.parametrize("case", ["unit", "fewer_spans", "more_spans",
                                  "no_calls", "no_spans", "no_counts",
                                  "some_counts", "no_slots"])
def test_slot_use_none(case, program):
    """None in a cell that delivers no pairs, where the call spans are
    not the traced window's calls, and where the launches carry no counts
    (the parent's program) or sweep no slot."""
    counts = {"no_spans": [], "no_counts": [None] * 4,
              "some_counts": [(1, 2), None, (1, 2), (1, 2)],
              "no_slots": [(0, 0)] * 4}.get(case, [(470, 1000)] * 4)
    program += recorded(counts)
    n = {"fewer_spans": 5, "more_spans": 3, "no_calls": 0}.get(case, 4)
    assert READ(context(n, "reads" if case == "unit" else "pairs")) is None
