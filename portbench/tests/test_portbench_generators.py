"""The traffic generators: the same calls from the same seed, and the
shapes the traffic files state."""
import numpy as np
import pytest

import harness
from gen import likelihood

LIKELIHOOD = ["wgs30x-pe150.hc-batched", "tn-wgs-t75n30.m2-batched"]
SMALL = dict(pool_regions=40)
# the median pairs a call of the port's 60 Mb htc and mutect2 runs
# (benchmarks/call_sizes.py, recorded in benchmarks/wgs_rehearsal.json)
RECORDED_MEDIAN = {"wgs30x-pe150.hc-batched": 8140,
                   "tn-wgs-t75n30.m2-batched": 7879}


def _calls(cell, seed):
    c = harness.load_cell(cell, SMALL)
    return c, likelihood.make_calls(c.config, c.traffic, seed)


@pytest.mark.parametrize("cell", LIKELIHOOD)
def test_likelihood_deterministic_per_seed(cell):
    _, a = _calls(cell, 2 ** 31 + 7)
    _, b = _calls(cell, 2 ** 31 + 7)
    _, c = _calls(cell, 11)
    for x, y in zip(a, b):
        for f in ("reads", "quals", "rlens", "haps", "hlens", "pair_read",
                  "pair_hap"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
    assert not np.array_equal(a[0].reads, c[0].reads)
    # every seed gets the same sizes, in another order
    assert sum(x.pairs for x in a) == sum(x.pairs for x in c)
    assert sorted(np.concatenate([x.hlens for x in a]).tolist()) == \
        sorted(np.concatenate([x.hlens for x in c]).tolist())


@pytest.mark.parametrize("cell", LIKELIHOOD)
def test_likelihood_shapes(cell):
    c, calls = _calls(cell, 5)
    t, cfg = c.traffic, c.config
    for x in calls:
        assert 0 < x.pairs <= t["max_pairs_per_call"]
        assert x.hlens.max() <= t["hap_len_max"]
        assert x.hlens.min() >= t["hap_len_min"] - t["indel_max"]
        assert 1 <= x.rlens.min() and x.rlens.max() <= cfg["read_len"]
        assert (x.reads[np.arange(x.reads.shape[1])[None, :]
                        >= x.rlens[:, None]] == 4).all()
        # the cross product of each region: every read against every hap
        assert x.pair_read.max() < len(x.rlens)
        assert x.pair_hap.max() < len(x.hlens)
    haps = [len(np.unique(x.pair_hap[x.pair_read == r]))
            for x in calls for r in np.unique(x.pair_read)[:5]]
    assert t["haps_min"] <= min(haps) and max(haps) <= t["haps_max"]
    # most reads are whole; the rest are clipped to their region
    rl = np.concatenate([x.rlens for x in calls])
    assert 0.3 < (rl == cfg["read_len"]).mean() < 0.9


def test_quality_profile_gives_the_error_rate():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 4, 2000).astype(np.uint8)
    cfg = {"read_len": 150, "error_rate": 0.005}
    start = rng.integers(0, 1850, 4000)
    codes, quals, lens = likelihood._reads(rng, src, start, cfg, 150)
    truth = src[start[:, None] + np.arange(150)[None, :]]
    assert (lens == 150).all()
    assert 0.004 < (codes != truth).mean() < 0.006
    assert quals.min() >= 2 and quals.max() <= 41


@pytest.mark.parametrize("cell", LIKELIHOOD)
def test_call_sizes_follow_the_record(cell):
    c = harness.load_cell(cell)
    pairs = [x.pairs for x in likelihood.make_calls(c.config, c.traffic, 9)]
    assert len(pairs) >= 40
    assert abs(np.median(pairs) / RECORDED_MEDIAN[cell] - 1) < 0.03


def test_variants_germline_and_somatic():
    """Most regions carry a germline het at 0.5 in tumour and normal; the
    somatic share follows the rates, and only the tumour carries it."""
    c = harness.load_cell("tn-wgs-t75n30.m2-batched")
    cfg, traffic = c.config, c.traffic
    assert 0.003 < likelihood.somatic_share(cfg) < 0.004   # 3.6/Mb, 1/kb
    rng = np.random.default_rng(traffic["shape_seed"])
    shapes = [likelihood._shape(rng, cfg, traffic) for _ in range(4000)]
    assert 0.001 < np.mean([s.somatic for s in shapes]) < 0.007
    germ = next(s for s in shapes if not s.somatic)
    som = likelihood.Shape(germ.span, germ.edits, germ.starts, True)
    rng = np.random.default_rng(1)
    tumour, normal = cfg["read_groups"]
    for shape, want in ((germ, (0.5, 0.5)), (som, (0.3, 0.0))):
        got = [likelihood.from_variant(rng, shape, g, 20000).mean()
               for g in (tumour, normal)]
        assert got == pytest.approx(want, abs=0.015)
    assert likelihood.somatic_share(
        harness.load_cell("wgs30x-pe150.hc-batched").config) == 0.0
