"""The plain reference agrees with the textbook recurrence at tiny
sizes, and the control is what it says."""
import numpy as np
import pytest
import torch

from reference import pairhmm


def _pairs(rng, n, R, H):
    read = rng.integers(0, 4, (n, R))
    hap = rng.integers(0, 4, (n, H))
    qual = rng.integers(2, 42, (n, R))
    rlen = rng.integers(1, R + 1, n)
    hlen = rng.integers(1, H + 1, n)
    # half the pairs related: the read copied from the haplotype
    for b in range(0, n, 2):
        k = min(rlen[b], hlen[b])
        read[b, :k] = hap[b, :k]
    return read, qual, rlen, hap, hlen


def test_pairhmm_matches_the_textbook_recurrence():
    rng = np.random.default_rng(1)
    read, qual, rlen, hap, hlen = _pairs(rng, 12, 9, 13)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = pairhmm.log10_likelihood(t(read), t(qual), t(rlen), t(hap),
                                   t(hlen), 45, 45, 10).numpy()
    for b in range(len(rlen)):
        want = pairhmm.log10_likelihood_naive(
            read[b, :rlen[b]], qual[b, :rlen[b]], hap[b, :hlen[b]], 45, 45,
            10)
        assert got[b] == pytest.approx(want, abs=1e-9)


def test_pairhmm_rescale_is_exact():
    # a pair long enough to be rescaled several times: the scaled sweep
    # in float64 gives the unscaled textbook value
    rng = np.random.default_rng(2)
    read = rng.integers(0, 4, (1, 150))
    hap = rng.integers(0, 4, (1, 300))
    qual = np.full((1, 150), 40)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = pairhmm.log10_likelihood(t(read), t(qual), t([150]), t(hap),
                                   t([300]), 45, 45, 10).numpy()[0]
    want = pairhmm.log10_likelihood_naive(read[0], qual[0], hap[0], 45, 45,
                                          10)
    assert np.isfinite(got) and got < -100
    assert got == pytest.approx(want, rel=1e-12)


def test_pairhmm_bfloat16_control_departs():
    rng = np.random.default_rng(3)
    read, qual, rlen, hap, hlen = _pairs(rng, 16, 40, 60)
    args = [torch.from_numpy(np.asarray(a)) for a in (read, qual, rlen, hap,
                                                      hlen)]
    f64 = pairhmm.log10_likelihood(*args, 45, 45, 10)
    f32 = pairhmm.log10_likelihood(*args, 45, 45, 10, dtype=torch.float32)
    bf16 = pairhmm.log10_likelihood(*args, 45, 45, 10, dtype=torch.bfloat16)
    ok = torch.isfinite(f64)
    assert (f32 - f64)[ok].abs().max() < 1e-4
    assert (bf16 - f64)[ok & torch.isfinite(bf16)].abs().max() > 1e-2
