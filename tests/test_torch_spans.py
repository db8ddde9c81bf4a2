"""Spans inside the PairHMM entries (``utils/spans.py``) and the kernel
library's load counter (``ops/_build.py`` ``LOAD``).

On the CPU the entries run K4's plain version.  The spans are recorded
only under a ``torch.profiler`` session: one span a call and one a step,
each step inside the call, all with the call's id, and the same names in
the profiler's Chrome trace as ``user_annotation`` events.  The test
marked ``cuda`` holds a traced call on the card against the card's
events on the same timeline.  This file imports neither JAX nor the JAX
package, so it also runs on a card:

    python -m pytest --noconftest tests/test_torch_spans.py
"""
import json
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from falcon_genome_tpu_torch.ops import _build
from falcon_genome_tpu_torch.ops import pairhmm as P
from falcon_genome_tpu_torch.pipeline.runner import PipelineRunner, stage
from falcon_genome_tpu_torch.utils import spans

torch.set_num_threads(1)

CPU = torch.device("cpu")
PAIRS_STEPS = ["pairhmm.tables", "pairhmm.copy_in", "pairhmm.gather",
               "pairhmm.launch", "pairhmm.wait", "pairhmm.free"]
LOGP_STEPS = ["pairhmm.tables", "pairhmm.copy_in", "pairhmm.launch",
              "pairhmm.wait"]


def region(seed, NR=3, NH=2, R=16, H=32):
    """A region's cross product: NR reads drawn from NH haplotypes."""
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 4, (NH, H - 4)).astype(np.uint8)
    hl = np.full(NH, H - 4, np.int32)
    rl = rng.integers(R // 2, R - 3, NR).astype(np.int32)
    reads = np.full((NR, R - 2), 4, np.uint8)
    for i in range(NR):
        s = int(rng.integers(0, hl[i % NH] - rl[i]))
        reads[i, :rl[i]] = haps[i % NH, s:s + rl[i]]
    quals = rng.integers(10, 41, reads.shape).astype(np.uint8)
    pr = np.repeat(np.arange(NR), NH)
    ph = np.tile(np.arange(NH), NR)
    return reads, quals, rl, haps, hl, pr, ph


def call_pairs(seed, device=CPU, **sizes):
    reads, quals, rl, haps, hl, pr, ph = region(seed, **sizes)
    R, H = sizes.get("R", 16), sizes.get("H", 32)
    params = P.PairHMMParams(max_read_len=R, max_hap_len=H, device=device)
    return P.pairhmm_logp_pairs(reads, quals, rl, haps, hl, pr, ph, 45, 45,
                                10, params=params)


def call_logp(seed):
    reads, quals, rl, haps, hl, pr, ph = region(seed)
    params = P.PairHMMParams(max_read_len=16, max_hap_len=32, device=CPU)
    return P.pairhmm_logp(reads[pr], quals[pr], 45, 45, 10, rl[pr],
                          haps[ph], hl[ph], params=params)


ENTRIES = {"pairhmm_logp_pairs": (call_pairs, PAIRS_STEPS),
           "pairhmm_logp": (call_logp, LOGP_STEPS)}


@pytest.fixture(autouse=True)
def _no_spans():
    spans.reset()
    yield
    spans.reset()


def by_call(recorded):
    calls = {}
    for s in recorded:
        calls.setdefault(s.call, []).append(s)
    return calls


def check_call(group, steps):
    """One call's spans: ``pairhmm.call`` and its steps in order, on one
    thread, each inside the call."""
    group = sorted(group, key=lambda s: s.start_ns)
    assert [s.name for s in group] == ["pairhmm.call", *steps]
    top = group[0]
    assert top.parent is None
    assert len({s.thread for s in group}) == 1
    for prev, s in zip(group[1:], group[2:]):
        assert prev.end_ns <= s.start_ns
    for s in group[1:]:
        assert s.parent == top.id
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
    for s in group:     # the CPU clock is read for the call and the wait
        timed = s.name in ("pairhmm.call", "pairhmm.wait")
        assert (s.cpu_ns is not None) == timed
        assert not timed or 0 <= s.cpu_ns
    return top


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_profiler_records_nothing(entry, monkeypatch):
    """Without a profiler session a call records no span, makes no
    profiler annotation and leaves no K4 work to count."""
    def refuse(*args):
        raise AssertionError(f"{args!r} without a session")

    monkeypatch.setattr(spans, "_annotate", refuse)
    monkeypatch.setattr(P, "_k4_work", refuse)
    fn, _ = ENTRIES[entry]
    assert not spans.active()
    fn(1)
    assert spans.spans() == []


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_call_spans_nest_in_order(entry, tmp_path):
    """Under the profiler one call records ``pairhmm.call`` and its steps,
    in order, with one call id, each inside its parent; the exported trace
    holds the same names as ``user_annotation`` events, nested alike."""
    fn, steps = ENTRIES[entry]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.active()
        out = fn(2)
    assert not spans.active()
    recorded = spans.spans()
    assert len(by_call(recorded)) == 1
    top = check_call(recorded, steps)
    assert top.attrs["pairs"] == len(out) == 6 and top.attrs["card"] == "cpu"
    if entry == "pairhmm_logp_pairs":
        assert (top.attrs["reads"], top.attrs["haps"]) == (3, 2)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    marks = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("pairhmm.")),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in marks] == ["pairhmm.call", *steps]
    assert len({e["tid"] for e in marks}) == 1
    a, b = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    for e in marks[1:]:
        assert a <= e["ts"] and e["ts"] + e["dur"] <= b


def crafted_pairs(R=72, H=80):
    """Reads of 0, 1, 31, 32, 33, 40 and R bases, the second of each
    length with a quality-0 first base (its rescale can fire late), each
    against two haplotypes of 1 and H bases."""
    rng = np.random.default_rng(7)
    rl = np.repeat(np.array([0, 1, 31, 32, 33, 40, R], np.int32), 2)
    reads = rng.integers(0, 4, (len(rl), R)).astype(np.uint8)
    quals = rng.integers(10, 41, reads.shape).astype(np.uint8)
    quals[1::2, 0] = 0
    haps = rng.integers(0, 4, (2, H)).astype(np.uint8)
    hl = np.array([1, H], np.int32)
    pr = np.repeat(np.arange(len(rl)), 2)
    ph = np.tile(np.arange(2), len(rl))
    return reads, quals, rl, haps, hl, pr, ph


def k4_count(q0, rl, hl, gcp, R, H):
    """K4's work pair by pair, apart from ``_k4_work``: the plain
    version's ``_late_rescale`` on row 0's priors, then the rows a thread
    and diagonals the kernel's source gives a pair."""
    f32 = torch.float32
    a_im = 1.0 - P._phred_to_prob(gcp)
    work = {"pairs": len(rl), "fitted": 0, "cells": 0, "slots": 0}
    for q, r, h in zip(q0.tolist(), rl.tolist(), hl.tolist()):
        p_err = P._phred_to_prob(q)
        prior = torch.minimum(1.0 - p_err,
                              p_err * torch.tensor(1.0 / 3.0, dtype=f32))
        bound = torch.tensor(2.0 ** 120, dtype=f32) / max(float(h), 1.0)
        late = bool(P._late_rescale(prior, bound, a_im))
        has_row = 1 <= r <= R
        own = has_row and not late
        rows = -(-r // 32) if own else -(-R // 32)
        diags = R + H if has_row and late else min(r + h, R + H)
        work["fitted"] += own
        work["cells"] += r * h
        work["slots"] += 32 * rows * diags
    return work


@pytest.mark.parametrize("gcp", [10, 0])
def test_launch_counts_k4_work(gcp):
    """The ``pairhmm.launch`` span of ``pairhmm_logp_pairs`` carries K4's
    work (pairs, those over their own rows, matrix cells, cell slots
    swept), equal to a count pair by pair; at gap continuation phred 0
    every pair with a row is late."""
    reads, quals, rl, haps, hl, pr, ph = crafted_pairs()
    want = k4_count(quals[pr, 0], rl[pr], hl[ph], gcp, 72, 80)
    assert 0 < want["fitted"] < want["pairs"] - 2 if gcp else \
        want["fitted"] == 0
    params = P.PairHMMParams(max_read_len=72, max_hap_len=80, device=CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        P.pairhmm_logp_pairs(reads, quals, rl, haps, hl, pr, ph, 45, 45,
                             gcp, params=params)
    launch, = [s for s in spans.spans() if s.name == "pairhmm.launch"]
    assert launch.attrs == {"kernel": "K4", **want}


def test_k4_work_counted_when_read(monkeypatch):
    """A traced call leaves K4's work to the reading of its spans: the
    count runs once, in ``spans.spans()``, and not inside the call."""
    counted = []

    def count(*args):
        counted.append(args)
        return {"pairs": len(args[3])}

    monkeypatch.setattr(P, "_k4_work", count)
    reads, quals, rl, haps, hl, pr, ph = crafted_pairs()
    params = P.PairHMMParams(max_read_len=72, max_hap_len=80, device=CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        P.pairhmm_logp_pairs(reads, quals, rl, haps, hl, pr, ph, 45, 45,
                             10, params=params)
        assert counted == []
    for _ in range(2):
        launch, = [s for s in spans.spans() if s.name == "pairhmm.launch"]
        assert launch.attrs == {"kernel": "K4", "pairs": len(pr)} and \
            len(counted) == 1


def test_threads_keep_their_calls():
    """Eight threads calling at once: each call's spans share its id and
    its thread, and no span is lost."""
    threads, calls_each = 8, 3
    errors = []

    def work(t):
        try:
            for k in range(calls_each):
                call_pairs(100 * t + k)
        except Exception as e:          # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            ts = [threading.Thread(target=work, args=(t,))
                  for t in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and not errors
    recorded = spans.spans()
    calls = by_call(recorded)
    assert len(calls) == threads * calls_each
    assert len(recorded) == threads * calls_each * (1 + len(PAIRS_STEPS))
    for group in calls.values():
        check_call(group, PAIRS_STEPS)
    per_thread = {}
    for group in calls.values():
        per_thread.setdefault(group[0].thread, []).append(group)
    assert sorted(len(g) for g in per_thread.values()) == \
        [calls_each] * threads
    spans.reset()
    assert spans.spans() == []


@pytest.mark.parametrize("nprocs", [1, 2])
def test_stage_trace_holds_spans(nprocs, tmp_path):
    """A stage under ``tpu.profile`` that calls the entry writes a trace
    that holds each call's spans, on the thread that made the call (a
    pool's worker threads too)."""
    runner = PipelineRunner("T", profile_dir=str(tmp_path / "profile"))
    runner.run([stage("S", [lambda: call_pairs(3), lambda: call_pairs(4)],
                      nprocs=nprocs)])
    [path] = (tmp_path / "profile").glob("T-S-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("pairhmm.")]
    names = sorted(e["name"] for e in marks)
    assert names == sorted(["pairhmm.call", *PAIRS_STEPS] * 2)
    for top in (e for e in marks if e["name"] == "pairhmm.call"):
        inside = [e for e in marks if e["tid"] == top["tid"]
                  and top["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= top["ts"] + top["dur"]]
        assert sorted(e["name"] for e in inside) == \
            sorted(["pairhmm.call", *PAIRS_STEPS])
    assert len(by_call(spans.spans())) == 2


def test_library_load_counted_once(monkeypatch, tmp_path):
    """``_build.LOAD`` counts the process's one load of the kernel
    library, its seconds and the nvcc builds it ran: one build where the
    library of this digest is missing, none where it is there."""
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
        "done\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    opened = []

    def dlopen(path):
        opened.append(path)
        return types.SimpleNamespace()

    monkeypatch.setattr(_build.ctypes, "CDLL", dlopen)
    for builds in (1, 0):       # a fresh checkout, then the next process
        monkeypatch.setattr(_build, "_lib", None)
        monkeypatch.setattr(_build, "LOAD", {"loads": 0, "seconds": 0.0,
                                             "builds": 0})
        lib = _build.load()
        assert _build.load() is lib
        assert _build.LOAD["loads"] == 1
        assert _build.LOAD["builds"] == builds
        assert _build.LOAD["seconds"] > 0
    assert len(opened) == 2
    assert len(log.read_text().splitlines()) == len(_build.SOURCES) + 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_share_the_card_clock(cuda_device, tmp_path):
    """In one traced call on the card, ``pairhmm.launch`` holds K4's
    launch in the CUDA runtime, and K4's interval on the card ends before
    ``pairhmm.wait`` does."""
    sizes = dict(NR=96, NH=4, R=160, H=384)
    call_pairs(5, cuda_device, **sizes)        # builds and loads K4
    torch.cuda.synchronize()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call_pairs(6, cuda_device, **sizes)
        torch.cuda.synchronize()
    check_call(spans.spans(), PAIRS_STEPS)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]

    def mark(name):
        [e] = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == name]
        return e["ts"], e["ts"] + e["dur"]

    [k4] = [e for e in events if e.get("cat") == "kernel"
            and "pairhmm_kernel" in e.get("name", "")]
    corr = k4["args"]["correlation"]
    [rt] = [e for e in events if e.get("cat") == "cuda_runtime"
            and e.get("args", {}).get("correlation") == corr]
    assert rt["name"].startswith("cudaLaunchKernel")
    a, b = mark("pairhmm.launch")
    assert a <= rt["ts"] and rt["ts"] + rt["dur"] <= b
    _, wait_end = mark("pairhmm.wait")
    assert a <= k4["ts"] and k4["ts"] + k4["dur"] <= wait_end
