"""The per-base cell (``wgs30x-gatk3-bqsr.hc-pb-batched``): its
generator, its BI/BD model, K5's counts, the readers of K5, and whole
runs on the CPU at a small size, sound, with the reference in bfloat16
in the program's place, with a likelihood altered, and against a program
whose entry takes no gap-open tables."""
import hashlib
import json
import math
import types

import numpy as np
import pytest
import torch

import control
import harness
import roofline
import roofline_pb
import run
from falcon_genome_tpu_torch.utils import spans
from gen import likelihood_pb
from reference import pairhmm as ref_pairhmm

CELL = "wgs30x-gatk3-bqsr.hc-pb-batched"
HC = "wgs30x-pe150.hc-batched"
SMALL = dict(pool_regions=40)
TINY = dict(read_len=40, hap_len_min=50, hap_len_max=70, pool_regions=8,
            max_pairs_per_call=64, caller_threads=2,
            sample_calls_per_thread=2, trace_seconds=0.5,
            read_groups=[{"name": "sample", "depth": 3, "germline_af": 0.5,
                          "somatic_af": 0.0}])
CPU = [torch.device("cpu")]


def _service(cell, seed, overrides=SMALL):
    c = harness.load_cell(cell, overrides)
    return harness.make_service(c, seed, CPU)


def test_pairs_equal_hc_batched_and_tables_follow_the_seed():
    seed = 2 ** 31 + 7
    a, b = _service(CELL, seed), _service(CELL, seed)
    hc = _service(HC, seed)
    other = _service(CELL, 11)
    assert len(a.pool) == len(hc.pool)
    for x, y in zip(a.pool, hc.pool):
        for f in ("reads", "quals", "rlens", "haps", "hlens", "pair_read",
                  "pair_hap"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
    for (i1, d1), (i2, d2), c in zip(a.tables, b.tables, a.pool):
        assert np.array_equal(i1, i2) and np.array_equal(d1, d2)
        assert i1.shape == c.reads.shape == d1.shape
        assert i1.dtype == np.uint8
    assert not np.array_equal(a.tables[0][0], other.tables[0][0])
    # the calls cut from one group of regions share their reads' tables
    shared = [k for k in range(1, len(a.pool))
              if a.pool[k].reads is a.pool[k - 1].reads]
    for k in shared:
        assert a.tables[k][0] is a.tables[k - 1][0]


def test_indel_quals_model_keeps_to_its_range():
    c = harness.load_cell(CELL, SMALL)
    model = c.config["indel_quals"]
    svc = _service(CELL, 5)
    for call, (ins, dels) in zip(svc.pool, svc.tables):
        inside = np.arange(ins.shape[1])[None, :] < call.rlens[:, None]
        for t in (ins, dels):
            assert (t[~inside] == 0).all()
            assert t[inside].min() >= model["floor"]
            assert t[inside].max() <= model["base_max"]
        # a read's first two bases open no run past the free two: its base
        # value, in 40..46, drawn apart for BI and BD
        first = ins[:, 0][call.rlens >= 1]
        assert first.min() >= model["base_min"]
    ins = np.concatenate([t[0][:, 0] for t in svc.tables])
    dels = np.concatenate([t[1][:, 0] for t in svc.tables])
    assert set(np.unique(ins)) == set(range(40, 47))
    assert 0.1 < (ins == dels).mean() < 0.2         # 1/7 where apart


def tables_by_loop(pool, seed, model):
    """The BI/BD model read base by base, apart from the generator's
    array form: the same draws of the seed's stream (a base value a read,
    BI then BD, a unique read table at a time), then each base's run
    counted back by hand."""
    rng = np.random.default_rng([seed, likelihood_pb.STREAM])
    made, out = {}, []
    for c in pool:
        if id(c.reads) not in made:
            NR, R = c.reads.shape
            pair = []
            for _ in ("BI", "BD"):
                base = rng.integers(model["base_min"], model["base_max"] + 1,
                                    NR)
                q = np.zeros((NR, R), np.uint8)
                for r in range(NR):
                    for k in range(int(c.rlens[r])):
                        run = 1
                        while k - run >= 0 and \
                                c.reads[r, k - run] == c.reads[r, k]:
                            run += 1
                        cut = model["per_homopolymer_base"] * max(
                            run - model["homopolymer_free"], 0)
                        q[r, k] = max(int(base[r]) - cut, model["floor"])
                pair.append(q)
            made[id(c.reads)] = tuple(pair)
        out.append(made[id(c.reads)])
    return out


# sha256 of every call's BI then BD bytes at seed 2^31 + 11, 40 regions
TABLES_SHA256 = ("c9419413b6183a121035b5f64acb5c1ad3c5f47caa0b6cd99fd48392"
                 "a89b9a90")


def test_tables_pinned_at_one_seed():
    """The tables at one seed are the model's, base by base, and stay
    those bytes: a change to the generator that moves them shows here."""
    seed = 2 ** 31 + 11
    svc = _service(CELL, seed)
    model = harness.load_cell(CELL, SMALL).config["indel_quals"]
    want = tables_by_loop(svc.pool, seed, model)
    digest = hashlib.sha256()
    for (i1, d1), (i2, d2) in zip(svc.tables, want, strict=True):
        assert np.array_equal(i1, i2) and np.array_equal(d1, d2)
        digest.update(i1.tobytes())
        digest.update(d1.tobytes())
    assert digest.hexdigest() == TABLES_SHA256


def test_homopolymer_rule_by_hand():
    model = {"base_min": 44, "base_max": 44, "homopolymer_free": 2,
             "per_homopolymer_base": 2, "floor": 20}
    read = np.array([[0, 0, 0, 0, 1, 2, 2, 2, 3] + [3] * 14 + [4]],
                    np.uint8)
    ins, dels = likelihood_pb.indel_tables(read, np.array([23]),
                                           np.random.default_rng(1), model)
    want = [44, 44, 42, 40, 44, 44, 44, 42, 44, 44] + \
        [max(44 - 2 * k, 20) for k in range(1, 14)] + [0]
    assert ins[0].tolist() == want and dels[0].tolist() == want


def test_k5_counts_by_hand():
    # one pair of a 3-base read and a 4-base haplotype: 12 cells of 11
    # flops, 4 last-row cells of 2; bytes 4 x 3 + 4 + 12, and the table
    flops, nbytes = roofline_pb.pairhmm_pb_work([3], [4])
    assert flops == 12 * 11 + 4 * 2
    assert nbytes == 28 + 1024
    flops2, nbytes2 = roofline_pb.pairhmm_pb_work([3, 2], [4, 5])
    assert flops2 == flops + 10 * 11 + 5 * 2
    assert nbytes2 == nbytes + 8 + 5 + 12
    # the operations are K4's; the bytes add two phreds a read base
    assert flops2 == roofline.pairhmm_work([3, 2], [4, 5])[0]


def test_k5_kernel_name_is_the_per_base_instance():
    import re
    rx = re.compile(roofline_pb.K5_KERNEL)
    k4 = re.compile(roofline.K4_KERNEL)
    k5_name = ("void (anonymous namespace)::pairhmm_kernel<5, true, true>"
               "(unsigned char const*, unsigned char const*)")
    k4_name = "void (anonymous namespace)::pairhmm_kernel<5, false, true>"
    assert rx.search(k5_name) and not rx.search(k4_name)
    assert k4.search(k4_name) and not k4.search(k5_name)


def naive_per_row(read, qual, hap, ins_q, del_q, gcp) -> float:
    """One pair by the textbook cell-by-cell recurrence in float64, each
    read row i with its own transitions from ins_q[i - 1] and
    del_q[i - 1] (GATK 3's BI/BD), gcp one phred for every row."""
    R, H = len(read), len(hap)
    p_cont = 10.0 ** (-gcp / 10.0)
    a_im = 1.0 - p_cont
    M = [[0.0] * (H + 1) for _ in range(R + 1)]
    I = [[0.0] * (H + 1) for _ in range(R + 1)]
    D = [[0.0] * (H + 1) for _ in range(R + 1)]
    D[0] = [1.0 / H] * (H + 1)
    for i in range(1, R + 1):
        e = 10.0 ** (-int(qual[i - 1]) / 10.0)
        p_ins = 10.0 ** (-int(ins_q[i - 1]) / 10.0)
        p_del = 10.0 ** (-int(del_q[i - 1]) / 10.0)
        a_mm = 1.0 - min(1.0, p_ins + p_del)
        for j in range(1, H + 1):
            a, b = int(read[i - 1]), int(hap[j - 1])
            prior = 1.0 - e if (a == b or a >= 4 or b >= 4) else e / 3.0
            M[i][j] = prior * (M[i - 1][j - 1] * a_mm
                               + (I[i - 1][j - 1] + D[i - 1][j - 1]) * a_im)
            I[i][j] = M[i - 1][j] * p_ins + I[i - 1][j] * p_cont
            D[i][j] = M[i][j - 1] * p_del + D[i][j - 1] * p_cont
    total = sum(M[R][j] + I[R][j] for j in range(1, H + 1))
    return math.log10(total) if total > 0 else -math.inf


def test_reference_per_base_matches_its_naive_twin():
    """``reference/pairhmm.py`` given (B, R) BI/BD planes, as the per-base
    cell's check calls it, takes row i's transitions from column i - 1."""
    rng = np.random.default_rng(4)
    n, R, H = 10, 9, 13
    read = rng.integers(0, 4, (n, R))
    hap = rng.integers(0, 4, (n, H))
    qual = rng.integers(2, 42, (n, R))
    ins = rng.integers(20, 47, (n, R))
    dels = rng.integers(20, 47, (n, R))
    rlen = rng.integers(1, R + 1, n)
    hlen = rng.integers(1, H + 1, n)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = ref_pairhmm.log10_likelihood(t(read), t(qual), t(rlen), t(hap),
                                       t(hlen), t(ins), t(dels), 10).numpy()
    for b in range(n):
        r = rlen[b]
        want = naive_per_row(read[b, :r], qual[b, :r], hap[b, :hlen[b]],
                             ins[b, :r], dels[b, :r], 10)
        assert got[b] == pytest.approx(want, abs=1e-9)
    # the planes move the result: row-constant 45s give another one
    flat = ref_pairhmm.log10_likelihood(t(read), t(qual), t(rlen), t(hap),
                                        t(hlen), 45, 45, 10).numpy()
    assert not np.allclose(flat, got, rtol=0, atol=1e-3)


MS = 1_000_000


def recorded(attrs_list):
    out = []
    for c, attrs in enumerate(attrs_list, start=1):
        t = 100 * MS * c
        out += [spans.Span("pairhmm.call", t, t + 10 * MS, 0, c % 2, c,
                           2 * c, None, {"pairs": 8}),
                spans.Span("pairhmm.launch", t + MS, t + 2 * MS, None,
                           c % 2, c, 2 * c + 1, 2 * c, attrs)]
    return out


def context(n, unit="pairs"):
    return types.SimpleNamespace(
        service=types.SimpleNamespace(unit=unit),
        traced=types.SimpleNamespace(records=[object()] * n))


@pytest.fixture
def program(monkeypatch):
    held = []
    monkeypatch.setattr(spans, "spans", lambda: list(held))
    return held


def test_k5_slot_use(program):
    read = harness.metric_reader("k5_slot_use.likelihood")
    k5 = {"kernel": "K5", "pairs": 8}
    program += recorded([dict(k5, cells=470, slots=1000),
                         dict(k5, cells=30, slots=1000)])
    assert read(context(2)) == pytest.approx(25.0)


@pytest.mark.parametrize("case", ["k4_only", "no_kernel", "no_counts",
                                  "no_spans", "other_calls", "unit"])
def test_k5_slot_use_none(case, program):
    """None where no launch of the window's calls is K5's (K4's, or a
    program that names no kernel), where K5's launches carry no counts,
    with no spans, where the call spans are not the window's calls, and
    in a cell that delivers no pairs."""
    read = harness.metric_reader("k5_slot_use.likelihood")
    attrs = {"k4_only": {"kernel": "K4", "cells": 1, "slots": 2},
             "no_kernel": {"cells": 1, "slots": 2},
             "no_counts": {"kernel": "K5", "pairs": 8}}.get(
        case, {"kernel": "K5", "cells": 1, "slots": 2})
    program += recorded([] if case == "no_spans" else [attrs] * 3)
    n = 4 if case == "other_calls" else 3
    assert read(context(n, "reads" if case == "unit" else "pairs")) is None


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_s(self, pattern):
        import re
        rx = re.compile(pattern)
        return sum(s for n, s in self.kernels.items() if rx.search(n))


def test_k5_roofline_reader():
    read = harness.metric_reader("k5_roofline")
    work = roofline_pb.pairhmm_pb_work([100] * 8, [300] * 8)
    least = roofline.bound_s(*work, roofline.PEAK_F32_FLOPS)
    svc = types.SimpleNamespace(kernel_work=lambda i: {"k5": work})
    traced = types.SimpleNamespace(records=[types.SimpleNamespace(item=0)]
                                   * 3)
    k5 = "pairhmm_kernel<5, true, true>(unsigned char const*)"
    ctx = types.SimpleNamespace(service=svc, traced=traced,
                                trace=_Trace({k5: 30 * least}))
    assert read(ctx) == pytest.approx(10.0)
    # no K5 in the trace (a K4 launch only), no K5 work, no calls
    ctx.trace = _Trace({"pairhmm_kernel<5, false, true>": 1.0})
    assert read(ctx) is None
    ctx.trace = _Trace({k5: 1.0})
    ctx.service = types.SimpleNamespace(kernel_work=lambda i: {"k4": work})
    assert read(ctx) is None
    ctx.service, ctx.traced = svc, types.SimpleNamespace(records=[])
    assert read(ctx) is None


class _CardTrace(_Trace):
    def __init__(self, kernels, busy):
        super().__init__(kernels)
        self.busy = busy

    def cards(self):
        return list(self.busy)

    def busy_s(self, card):
        return self.busy[card]


def test_entry_card_ms_pb_reader():
    """The card's busy time less K5's over the window's calls; None with
    no K5 in the trace (K4's calls), no card, no calls or another unit."""
    read = harness.metric_reader("entry_card_ms_pb.likelihood")
    k5 = "pairhmm_kernel<8, true, true>(unsigned char const*)"
    k4 = "pairhmm_kernel<8, false, true>(unsigned char const*)"
    ctx = types.SimpleNamespace(
        service=types.SimpleNamespace(unit="pairs"),
        traced=types.SimpleNamespace(records=[object()] * 4),
        trace=_CardTrace({k5: 0.030, "gather": 0.004}, {0: 0.038}))
    assert read(ctx) == pytest.approx(1e3 * 0.008 / 4)
    ctx.trace = _CardTrace({k4: 0.030}, {0: 0.038})
    assert read(ctx) is None
    ctx.trace = _CardTrace({k5: 0.030}, {})
    assert read(ctx) is None
    ctx.trace = _CardTrace({k5: 0.030}, {0: 0.038})
    ctx.service.unit = "reads"
    assert read(ctx) is None
    ctx.service.unit = "pairs"
    ctx.traced.records = []
    assert read(ctx) is None


def _run(capsys, seconds, trace=0, seed=2 ** 31 + 3):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], devices=CPU,
                  overrides=TINY)
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 else None), cap.err


def test_cell_runs_sound_and_fails_when_altered(capsys, monkeypatch):
    rc, sound, _ = _run(capsys, 1.5)
    assert rc == 0 and sound["correct"] and sound["failed"] == 0
    assert sound["checks"]["logp_gap_max"]["value"] <= 1e-4
    from falcon_genome_tpu_torch.ops import pairhmm
    real = pairhmm.pairhmm_pb

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[len(out) // 2] += 0.01
        return out

    monkeypatch.setattr(pairhmm, "pairhmm_pb", altered)
    rc, spoiled, _ = _run(capsys, 1.5)
    assert rc == 0 and not spoiled["correct"]


def test_traced_run_reports_k5_slot_use(capsys):
    """Every launch of the traced window is K5's; on the CPU the trace
    holds no card, so the device readers give nothing."""
    spans.reset()
    rc, res, _ = _run(capsys, 0.5, trace=1)
    assert rc == 0 and res["correct"]
    use = res["metrics"]["k5_slot_use.likelihood"]["value"]
    assert 0 < use <= 100
    assert "k5_roofline" not in res["metrics"]
    assert "entry_card_ms_pb.likelihood" not in res["metrics"]
    launches = [s for s in spans.spans() if s.name == "pairhmm.launch"]
    assert launches and all(s.attrs["kernel"] == "K5" for s in launches)


def test_control_fails_on_cpu():
    r = control.readings(CELL, 2 ** 31 + 1, 1.5, True, devices=CPU,
                         overrides=TINY)
    limit = harness.load_cell(CELL).traffic["limit_logp_gap"]
    assert r["logp_gap_max"] <= limit < r["logp_gap_max.control"]


def test_program_without_tables_ends_without_a_result(capsys, monkeypatch):
    """An entry that takes scalar gap opens alone (an older program)
    ends the run at once, exit 2 and no result line."""
    from falcon_genome_tpu_torch.ops import pairhmm

    def scalars_only(*args, **kw):
        int(args[7])
        raise AssertionError("a table passed as a scalar")

    monkeypatch.setattr(pairhmm, "pairhmm_logp_pairs", scalars_only)
    rc, res, err = _run(capsys, 0.5)
    assert rc == 2 and res is None
    assert "no gap-open tables" in err


@pytest.mark.cuda
def test_control_fails_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    limit = harness.load_cell(CELL).traffic["limit_logp_gap"]
    for seed in (1, 2):
        r = control.readings(CELL, seed, 3.0, True)
        assert r["logp_gap_max"] <= limit < r["logp_gap_max.control"]
