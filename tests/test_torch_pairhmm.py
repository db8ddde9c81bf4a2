"""PairHMM port vs the JAX reference and the float64 golden model.

Tolerances: within 1e-4 log10 of the reference's portable wavefront
``_pairhmm_jax`` (the two sum the same float32 terms in the same order;
what differs is rounding in the phred conversion and fused multiply-adds),
within 2e-3 of the float64 model (the reference's own kernel tolerance,
tests/test_pairhmm.py), and the same -inf lanes.  The CUDA kernel is
held to the plain version in ``test_torch_kernels.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from falcon_genome_tpu.ops import pairhmm as J
from falcon_genome_tpu.ops.pairhmm_ref import pairhmm_logp_ref
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.ops import pairhmm as T

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_kernels import (  # noqa: E402
    DEL, GCP, INS, make_pairs, rescale_pairs)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _jax_logp(reads, q, rl, haps, hl, R, H):
    return np.asarray(J._pairhmm_jax(
        jnp.asarray(reads.T), jnp.asarray(q.T), jnp.uint8(INS),
        jnp.uint8(DEL), jnp.uint8(GCP), jnp.asarray(rl[None]),
        jnp.asarray(hl[None]), jnp.asarray(haps.T), R=R, H=H))


def _check(got, want_jax, want_f64, need_inf=False):
    fin = np.isfinite(want_jax)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() >= len(got) // 2
    if need_inf:
        assert (~fin).sum() >= 1
    np.testing.assert_allclose(got[fin], want_jax[fin], rtol=0, atol=1e-4)
    f = fin & np.isfinite(want_f64)
    np.testing.assert_allclose(got[f], want_f64[f], rtol=0, atol=2e-3)


def _f64(reads, q, rl, haps, hl):
    full = np.full_like(q, INS)
    return pairhmm_logp_ref(reads, q, full, full.copy(),
                            np.full_like(q, GCP), rl, haps, hl)


def test_plain_wavefront_matches_reference():
    # 150-base unrelated reads underflow float32 (-inf lanes)
    R, H = 152, 192
    reads, q, rl, haps, hl = make_pairs(0, 12, R, H)
    rl[:4] = R
    got = T._pairhmm_plain(
        torch.from_numpy(reads.T), torch.from_numpy(q.T), INS, DEL, GCP,
        torch.from_numpy(rl[None]), torch.from_numpy(hl[None]),
        torch.from_numpy(haps.T), R=R, H=H).numpy()
    _check(got, _jax_logp(reads, q, rl, haps, hl, R, H),
           _f64(reads, q, rl, haps, hl), need_inf=True)


def test_plain_wavefront_rescales_as_reference(monkeypatch):
    R, H = 160, 384
    reads, q, rl, haps, hl = rescale_pairs(3, 4, R, H)

    def plain():
        return T._pairhmm_plain(
            torch.from_numpy(reads.T), torch.from_numpy(q.T), INS, DEL, GCP,
            torch.from_numpy(rl[None]), torch.from_numpy(hl[None]),
            torch.from_numpy(haps.T), R=R, H=H).numpy()

    got = plain()
    want = _jax_logp(reads, q, rl, haps, hl, R, H)
    np.testing.assert_array_equal(np.isfinite(got), [True] * 3 + [False])
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-4)
    # without the rescale every pair floors to -inf
    monkeypatch.setattr(T, "RESCALE_THRESH", 0.0)
    assert not np.isfinite(plain()).any()


def test_pairhmm_logp_matches_reference():
    R, H = 32, 64
    reads, q, rl, haps, hl = make_pairs(1, 20, 30, 60)
    jparams = J.PairHMMParams(max_read_len=R, max_hap_len=H, backend="jax")
    want = np.asarray(J.pairhmm_logp(reads, q, INS, DEL, GCP, rl, haps, hl,
                                     params=jparams))
    got = T.pairhmm_logp(reads, q, INS, DEL, GCP, rl, haps, hl,
                         params=convert.pairhmm_params(jparams, CPU))
    _check(got, want, _f64(reads, q, rl, haps, hl))
    # per-base transition qualities belong to the unported general kernel
    with pytest.raises(ValueError, match="not ported"):
        T.pairhmm_logp(reads, q, q, DEL, GCP, rl, haps, hl,
                       params=convert.pairhmm_params(jparams, CPU))


def test_pairhmm_logp_pairs_matches_reference():
    rng = np.random.default_rng(2)
    R, H = 32, 128
    NR, NH = 9, 4
    haps = rng.integers(0, 4, (NH, 100)).astype(np.uint8)
    hl = rng.integers(70, 101, NH).astype(np.int32)
    reads = np.full((NR, 30), 4, np.uint8)
    rl = rng.integers(20, 31, NR).astype(np.int32)
    for i in range(NR):
        h = i % NH
        s = int(rng.integers(0, hl[h] - rl[i]))
        reads[i, :rl[i]] = haps[h, s:s + rl[i]]
    reads[0, :rl[0]] = rng.integers(0, 4, rl[0])      # unrelated read
    quals = rng.integers(10, 41, (NR, 30)).astype(np.uint8)
    pr = np.repeat(np.arange(NR), NH)
    ph = np.tile(np.arange(NH), NR)
    jparams = J.PairHMMParams(max_read_len=R, max_hap_len=H, backend="jax")
    want = np.asarray(J.pairhmm_logp_pairs(
        reads, quals, rl, haps, hl, pr, ph, INS, DEL, GCP, params=jparams))
    got = T.pairhmm_logp_pairs(
        reads, quals, rl, haps, hl, pr, ph, INS, DEL, GCP,
        params=convert.pairhmm_params(jparams, CPU))
    _check(got, want, _f64(reads[pr], quals[pr], rl[pr], haps[ph], hl[ph]))
