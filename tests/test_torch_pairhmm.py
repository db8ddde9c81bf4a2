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
    DEL, EARLY_DEL, EARLY_GCP, EARLY_INS, GCP, INS, early_rescale_pairs,
    indel_planes, make_pairs, pad_row_pairs, phred_planes, rescale_pairs)

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


@pytest.mark.parametrize("trans", ["45/45/10", "planes"])
def test_plain_flushes_every_operation_as_reference(trans):
    """The quality-0 rescue pairs carry mass through float32's subnormal
    range before the rescale.  The reference's CPU backend flushes every
    operation's result (and fuses multiply-adds); a port that flushed
    only each cell and the sum differed by up to 1e-3 log10 there with
    BI/BD-like planes.  Held to the reference's tolerance between its
    dispatch paths (tests/test_pairhmm.py), with the same -inf lanes."""
    R, H = 160, 384
    reads, q, rl, haps, hl = rescale_pairs(3, 16, R, H)
    tr = (INS, DEL, GCP) if trans == "45/45/10" else indel_planes(12, rl, R)

    def time_major(x):
        return x.T if np.ndim(x) else x

    got = T._pairhmm_plain(
        torch.from_numpy(reads.T), torch.from_numpy(q.T),
        *(torch.from_numpy(time_major(x)) if np.ndim(x) else x for x in tr),
        torch.from_numpy(rl[None]), torch.from_numpy(hl[None]),
        torch.from_numpy(haps.T), R=R, H=H).numpy()
    want = np.asarray(J._pairhmm_jax(
        jnp.asarray(reads.T), jnp.asarray(q.T),
        *(jnp.asarray(time_major(x)) if np.ndim(x) else jnp.uint8(x)
          for x in tr),
        jnp.asarray(rl[None]), jnp.asarray(hl[None]), jnp.asarray(haps.T),
        R=R, H=H))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() == len(want) - 1      # the last pair is subnormal
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)


def test_pairhmm_logp_matches_reference():
    R, H = 32, 64
    reads, q, rl, haps, hl = make_pairs(1, 20, 30, 60)
    jparams = J.PairHMMParams(max_read_len=R, max_hap_len=H, backend="jax")
    want = np.asarray(J.pairhmm_logp(reads, q, INS, DEL, GCP, rl, haps, hl,
                                     params=jparams))
    got = T.pairhmm_logp(reads, q, INS, DEL, GCP, rl, haps, hl,
                         params=convert.pairhmm_params(jparams, CPU))
    _check(got, want, _f64(reads, q, rl, haps, hl))
    # a per-base plane is taken too (kernel K5's path), as the reference
    # takes it
    want = np.asarray(J.pairhmm_logp(reads, q, q, DEL, GCP, rl, haps, hl,
                                     params=jparams))
    got = T.pairhmm_logp(reads, q, q, DEL, GCP, rl, haps, hl,
                         params=convert.pairhmm_params(jparams, CPU))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)


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


# ---- per-base transition planes: kernel K5's path -------------------------

def _check_planes(got, want):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend,B", [("jax", 20), ("interpret", 2)])
def test_pairhmm_logp_planes_match_reference(backend, B):
    """Variable lengths, pad rows (phred 0 past rlen) and BI/BD-like
    planes; ``interpret`` runs the reference's Pallas kernel K5 itself."""
    R, H = 32, 48
    reads, q, rl, haps, hl = (x[-B:] for x in make_pairs(11, 20, 30, 44))
    ins, dele, gcp = indel_planes(12, rl, 30)
    jparams = J.PairHMMParams(max_read_len=R, max_hap_len=H,
                              backend=backend)
    want = np.asarray(J.pairhmm_logp(reads, q, ins, dele, gcp, rl, haps, hl,
                                     params=jparams))
    got = T.pairhmm_logp(reads, q, ins, dele, gcp, rl, haps, hl,
                         params=convert.pairhmm_params(jparams, CPU))
    _check_planes(got, want)
    f = np.isfinite(want)
    gold = pairhmm_logp_ref(reads, q, ins, dele, gcp, rl, haps, hl)
    np.testing.assert_allclose(got[f], gold[f], rtol=0, atol=2e-3)


@pytest.mark.parametrize("planes", ["ins", "del", "gcp", "ins+gcp"])
def test_pairhmm_logp_mixed_transitions_route_to_k5(planes, monkeypatch):
    """Any plane → K5 with the scalars broadcast; all scalar → K4."""
    R, H = 40, 64
    reads, q, rl, haps, hl = make_pairs(13, 24, 36, 60)
    ins, dele, gcp = indel_planes(14, rl, 36)
    trans = [ins if "ins" in planes else INS,
             dele if "del" in planes else DEL,
             gcp if "gcp" in planes else GCP]
    calls = []
    for name in ("pairhmm_sc", "pairhmm_pb"):
        fn = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    jparams = J.PairHMMParams(max_read_len=R, max_hap_len=H, backend="jax")
    want = np.asarray(J.pairhmm_logp(reads, q, *trans, rl, haps, hl,
                                     params=jparams))
    got = T.pairhmm_logp(reads, q, *trans, rl, haps, hl,
                         params=convert.pairhmm_params(jparams, CPU))
    assert calls == ["pairhmm_pb"]
    _check_planes(got, want)
    calls.clear()
    T.pairhmm_logp(reads, q, INS, DEL, GCP, rl, haps, hl,
                   params=convert.pairhmm_params(jparams, CPU))
    assert calls == ["pairhmm_sc"]


def test_pairhmm_logp_planes_chunked():
    """Plane batches past 8192 pairs are cut into calls of 8192, the
    planes with them (the reference's ``cut``)."""
    R, H = 16, 24
    B = 8192 + 40
    rng = np.random.default_rng(15)
    haps = rng.integers(0, 4, (B, 20)).astype(np.uint8)
    reads = haps[:, 2:14].copy()
    q = rng.integers(20, 41, (B, 12)).astype(np.uint8)
    rl = rng.integers(6, 13, B).astype(np.int32)
    hl = np.full(B, 20, np.int32)
    ins, dele, gcp = indel_planes(16, rl, 12)
    jparams = J.PairHMMParams(max_read_len=R, max_hap_len=H, backend="jax")
    params = convert.pairhmm_params(jparams, CPU)
    got = T.pairhmm_logp(reads, q, ins, dele, gcp, rl, haps, hl,
                         params=params)
    tail = T.pairhmm_logp(reads[-40:], q[-40:], ins[-40:], dele[-40:],
                          gcp[-40:], rl[-40:], haps[-40:], hl[-40:],
                          params=params)
    np.testing.assert_array_equal(got[-40:], tail)
    want = np.asarray(J.pairhmm_logp(reads, q, ins, dele, gcp, rl, haps, hl,
                                     params=jparams))
    _check_planes(got, want)


def test_plain_pad_rows_rescale_as_reference(monkeypatch):
    """Crafted pairs: quality 0 on real rows, rlen < R, per-base planes
    with phred-0 pad rows, a rescale due.  The plain version (K5's twin)
    agrees with ``_pairhmm_jax`` on the same planes and with the float64
    model, and every pair is finite only through the rescale."""
    R, H = 160, 384
    reads, q, ins, dele, gcp, rl, haps, hl = pad_row_pairs(17, 16, R, H)

    def port():
        return T.pairhmm_pb(*(torch.from_numpy(x) for x in (
            reads, q, ins, dele, gcp, rl, haps, hl))).numpy()

    got = port()
    want = np.asarray(J._pairhmm_jax(
        *(jnp.asarray(x.T) for x in (reads, q, ins, dele, gcp)),
        jnp.asarray(rl[None]), jnp.asarray(hl[None]), jnp.asarray(haps.T),
        R=R, H=H))
    _check_planes(got, want)
    assert np.isfinite(got).all()
    gold = pairhmm_logp_ref(reads, q, ins, dele, gcp, rl, haps, hl)
    np.testing.assert_allclose(got, gold, rtol=0, atol=1e-4)
    # without the rescale every pair floors to -inf
    monkeypatch.setattr(T, "RESCALE_THRESH", 0.0)
    assert not np.isfinite(port()).any()


def test_early_rescale_pairs_need_the_rescale(monkeypatch):
    """The card tests' diagonal-64 pairs on the plain version: within
    1e-4 of ``_pairhmm_jax`` with 45/0/13 as scalars and as planes, all
    finite, and (but for the first, whose sweep ends at diagonal 64) -inf
    once the rescale is switched off."""
    R, H = 96, 128
    reads, q, rl, haps, hl = early_rescale_pairs(R, H)
    planes = phred_planes(rl, R, EARLY_INS, EARLY_DEL, EARLY_GCP)
    t = [torch.from_numpy(x) for x in (reads, q, rl, haps, hl)]

    def port():
        return (T.pairhmm_sc(*t, EARLY_INS, EARLY_DEL, EARLY_GCP).numpy(),
                T.pairhmm_pb(t[0], t[1], *(torch.from_numpy(x)
                                           for x in planes),
                             t[2], t[3], t[4]).numpy())

    got_sc, got_pb = port()
    for got, trans in ((got_sc, (EARLY_INS, EARLY_DEL, EARLY_GCP)),
                       (got_pb, planes)):
        tr = [jnp.asarray(x.T) if isinstance(x, np.ndarray) else x
              for x in trans]
        want = np.asarray(J._pairhmm_jax(
            jnp.asarray(reads.T), jnp.asarray(q.T), *tr,
            jnp.asarray(rl[None]), jnp.asarray(hl[None]),
            jnp.asarray(haps.T), R=R, H=H))
        assert np.isfinite(got).all()
        _check_planes(got, want)
    monkeypatch.setattr(T, "RESCALE_THRESH", 0.0)
    for got in port():
        assert np.isfinite(got[0]) and not np.isfinite(got[1:]).any()


def test_prob_table_equals_phred_to_prob():
    table = T._prob_table(CPU)
    assert table.dtype == torch.float32 and table.shape == (256,)
    assert torch.equal(table, T._phred_to_prob(
        torch.arange(256, dtype=torch.uint8)))
    assert T._prob_table(CPU) is table          # made once per device


@pytest.mark.parametrize("plane", ["base_q", "ins_q", "del_q", "gcp"])
def test_prob_table_reproduces_the_planes(plane):
    """Indexing the table gives, bit for bit, the float32 plane that
    ``_phred_to_prob`` computes from the uint8 phreds: what the kernels
    read is what the plain version computes."""
    reads, q, rl, haps, hl = make_pairs(21, 64, 160, 384)
    ins, dele, gcp = indel_planes(22, rl, 160)
    x = dict(base_q=q, ins_q=ins, del_q=dele, gcp=gcp)[plane].copy()
    x[0, :] = np.arange(160) + 96               # every phred up to 255
    x[1, :96] = np.arange(96)
    t = torch.from_numpy(x)
    assert torch.equal(T._prob_table(CPU)[t.long()], T._phred_to_prob(t))


def test_base_mask_reproduces_the_match_rule():
    """Masks share a bit exactly when the reference calls the bases a
    match: equal, or either one not A/C/G/T (all 256 x 256 byte pairs)."""
    mask = np.array([T._base_mask(c) for c in range(256)])
    assert mask.min() >= 1 and mask.max() <= 15  # four bits: eight per word
    rc, c = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    want = (rc == c) | (rc >= 4) | (c >= 4)
    assert np.array_equal((mask[rc] & mask[c]) != 0, want)


@pytest.mark.parametrize("wrapper", ["pairhmm_sc", "pairhmm_pb"])
@pytest.mark.parametrize("fault", ["dtype", "device", "rows"])
def test_kernel_input_checks_refuse(wrapper, fault):
    """What the wrappers refuse before a launch: a wrong dtype, tensors
    on two devices, a read bucket past 384 rows."""
    R = 392 if fault == "rows" else 16
    u8 = torch.zeros((4, R), dtype=torch.uint8)
    i32 = torch.zeros(4, dtype=torch.int32)
    typed = [(u8, torch.uint8), (u8, torch.uint8), (i32, torch.int32),
             (i32, torch.int32)]
    if wrapper == "pairhmm_pb":
        typed += [(u8, torch.uint8)] * 3
    T._check_kernel_inputs(wrapper, 16, [(torch.zeros((4, 16),
                                                      dtype=torch.uint8),
                                          torch.uint8)] + typed[2:4])
    if fault == "dtype":
        typed[1] = (u8.float(), torch.uint8)
    elif fault == "device":
        typed[2] = (i32.to("meta"), torch.int32)
    with pytest.raises(ValueError if fault == "rows" else TypeError,
                       match=wrapper):
        T._check_kernel_inputs(wrapper, R, typed)
