"""PairHMM port vs the JAX reference and the float64 golden model.

Tolerances: the same float32 bits as the reference's portable wavefront
``_pairhmm_jax`` on every finite lane and the same -inf lanes, as the
reference's entry points run it (lanes padded to a multiple of 128:
``torch_parity.jax_pairhmm``), and through those entry points
(``pairhmm_logp``, ``pairhmm_logp_pairs``).  The port gets there with the
reference's own phred table (XLA's powf of -q * 0.1f, 50 entries away
from powf(10, -q / 10)), the fused multiply-adds XLA's object code has
(each rounded once; the row sum fused past the prior from 33 read rows
on), and XLA's float32 log in the epilogue; within 2e-3 of the float64
model (the reference's own kernel tolerance, tests/test_pairhmm.py).
The CUDA kernels are held to the plain version in
``test_torch_kernels.py`` and ``test_torch_pairhmm_emulated.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from falcon_genome_tpu.ops import pairhmm as J
from falcon_genome_tpu.ops.pairhmm_ref import pairhmm_logp_ref
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.ops import pairhmm as T

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_kernels import (  # noqa: E402
    DEL, EARLY_DEL, EARLY_GCP, EARLY_INS, GCP, INS, early_rescale_pairs,
    indel_planes, make_pairs, pad_row_pairs, phred_planes, rescale_pairs)
from torch_parity import assert_logp_bits, jax_pairhmm  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _jax_logp(reads, q, rl, haps, hl, R, H):
    return jax_pairhmm(reads.T, q.T, INS, DEL, GCP, rl[None], hl[None],
                       haps.T, R=R, H=H)


def _time_major(x):
    return x.T if np.ndim(x) else x


def _plain(reads, q, trans, rl, haps, hl, R, H):
    """The plain version on lane-major host arrays; ``trans`` holds
    scalar phreds or (B, R) planes."""
    return T._pairhmm_plain(
        torch.from_numpy(reads.T), torch.from_numpy(q.T),
        *(torch.from_numpy(_time_major(x)) if np.ndim(x) else x
          for x in trans),
        torch.from_numpy(rl[None]), torch.from_numpy(hl[None]),
        torch.from_numpy(haps.T), R=R, H=H).numpy()


def _check(got, want_jax, want_f64, need_inf=False):
    fin = assert_logp_bits(got, want_jax, min_finite=len(got) // 2)
    if need_inf:
        assert (~fin).sum() >= 1
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


def test_pairhmm_1024_pairs_bit_equal_to_reference():
    """HaplotypeCaller's 160/384 bucket at 1024 pairs, 45/45/10: before
    the port took the reference's phred table, fused row sum and log,
    275 of the 1020 finite pairs differed from it in their bits."""
    R, H = 160, 384
    reads, q, rl, haps, hl = make_pairs(7, 1024, R, H)
    jparams = J.PairHMMParams(max_read_len=R, max_hap_len=H, backend="jax")
    got = T.pairhmm_logp(reads, q, INS, DEL, GCP, rl, haps, hl,
                         params=convert.pairhmm_params(jparams, CPU))
    fin = assert_logp_bits(got, _jax_logp(reads, q, rl, haps, hl, R, H),
                           min_finite=1020)
    assert (~fin).sum() == 4
    assert_logp_bits(got, np.asarray(J.pairhmm_logp(
        reads, q, INS, DEL, GCP, rl, haps, hl, params=jparams)),
        min_finite=1020)


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
    assert_logp_bits(got, want, min_finite=3)
    # without the rescale every pair floors to -inf
    monkeypatch.setattr(T, "RESCALE_THRESH", 0.0)
    assert not np.isfinite(plain()).any()


@pytest.mark.parametrize("trans", ["45/45/10", "planes"])
def test_plain_flushes_every_operation_as_reference(trans):
    """The quality-0 rescue pairs carry mass through float32's subnormal
    range before the rescale.  The reference's CPU backend flushes every
    operation's result (and fuses multiply-adds); a port that flushed
    only each cell and the sum differed by up to 1e-3 log10 there with
    BI/BD-like planes.  Bit-equal, with the same -inf lanes."""
    R, H = 160, 384
    reads, q, rl, haps, hl = rescale_pairs(3, 16, R, H)
    tr = (INS, DEL, GCP) if trans == "45/45/10" else indel_planes(12, rl, R)
    got = _plain(reads, q, tr, rl, haps, hl, R, H)
    want = jax_pairhmm(reads.T, q.T, *(_time_major(x) for x in tr),
                       rl[None], hl[None], haps.T, R=R, H=H)
    fin = assert_logp_bits(got, want)
    assert fin.sum() == len(want) - 1      # the last pair is subnormal


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
    assert_logp_bits(got, want)


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
    assert_logp_bits(got, want)


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
    want = jax_pairhmm(*(x.T for x in (reads, q, ins, dele, gcp)), rl[None],
                       hl[None], haps.T, R=R, H=H)
    _check_planes(got, want)
    assert np.isfinite(got).all()
    gold = pairhmm_logp_ref(reads, q, ins, dele, gcp, rl, haps, hl)
    np.testing.assert_allclose(got, gold, rtol=0, atol=1e-4)
    # without the rescale every pair floors to -inf
    monkeypatch.setattr(T, "RESCALE_THRESH", 0.0)
    assert not np.isfinite(port()).any()


@pytest.mark.parametrize("R,H", [(64, 128), (96, 128)])
def test_plain_rescales_past_the_pairs_end_as_reference(R, H):
    """Quality-0 reads end before the reference's sweep of R + H
    diagonals does, and their state is rescaled on a multiple of 64 past
    rlen + hlen: the reference scales their sum then too.  The plain
    version sweeps on for such pairs alone (a batch of nothing else),
    bit-equal to it, K5's pad-row pairs and K4's rescue pairs."""
    reads, q, ins, dele, gcp, rl, haps, hl = pad_row_pairs(9, 64, R, H)
    got = _plain(reads, q, (ins, dele, gcp), rl, haps, hl, R, H)
    want = jax_pairhmm(*(x.T for x in (reads, q, ins, dele, gcp)),
                       rl[None], hl[None], haps.T, R=R, H=H)
    assert_logp_bits(got, want, min_finite=64)
    assert (rl + hl).max() <= R + H - 64       # a multiple of 64 past all
    reads, q, rl, haps, hl = rescale_pairs(3, 16, R, H)
    got = _plain(reads, q, (INS, DEL, GCP), rl, haps, hl, R, H)
    assert_logp_bits(got, _jax_logp(reads, q, rl, haps, hl, R, H))
    p0 = T._phred_to_prob(torch.from_numpy(q[:, :1].T.copy()))
    prior = torch.minimum(1.0 - p0, p0 * torch.tensor(1.0 / 3.0))
    bound = 2.0 ** 120 / torch.from_numpy(hl[None].astype(np.float32))
    assert T._late_rescale(prior, bound, 1.0 - T._phred_to_prob(GCP)).all()


def test_early_rescale_pairs_need_the_rescale(monkeypatch):
    """The card tests' diagonal-64 pairs on the plain version: bit-equal
    to ``_pairhmm_jax`` with 45/0/13 as scalars and as planes, all
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
        want = jax_pairhmm(reads.T, q.T, *(_time_major(x) for x in trans),
                           rl[None], hl[None], haps.T, R=R, H=H)
        assert np.isfinite(got).all()
        _check_planes(got, want)
    monkeypatch.setattr(T, "RESCALE_THRESH", 0.0)
    for got in port():
        assert np.isfinite(got[0]) and not np.isfinite(got[1:]).any()


def test_prob_table_equals_reference():
    """All 256 entries bit for bit against the reference's
    ``_phred_to_prob`` as its compiled functions run it (XLA's powf of
    -q * 0.1f)."""
    q = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax.jit(J._phred_to_prob)(jnp.asarray(q)))
    got = T._prob_table(CPU).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _round_once(a, b, c):
    """float32(a * b + c) rounded once, from the exact rational value."""
    from fractions import Fraction
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    d = float(v)                                # the nearest double
    if Fraction(d) != v:                        # to odd, then to float32
        bits = np.array(d).view(np.int64)
        if bits % 2 == 0:
            up = (Fraction(d) < v) == (d > 0)
            d = float((bits + (1 if up else -1)).view(np.float64))
    return np.float32(d)


def test_fma_rounds_once():
    """``_fma`` is exactly rounded where a float64 sum rounded again to
    float32 is not: two sums whose float64 rounding lands on a float32
    tie (1 + 2^-24 + 2^-60 and 1 + 3 2^-24 - 6145 2^-71), and 10,000
    random ones."""
    f32 = np.float32
    a = f32([2.0 ** -24 * (1 + 2.0 ** -12),
             2.0 ** -24 * (1 + 2049 * 2.0 ** -23)])
    b = f32([1 - 4095 * 2.0 ** -24, 1 - 4097 * 2.0 ** -24])
    c = f32([1.0, 1 + 2.0 ** -23])
    got = T._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, f32([1 + 2.0 ** -23, 1 + 2.0 ** -23]))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != got).all()                 # a double rounding misses
    rng = np.random.default_rng(41)
    x = [(rng.standard_normal(10000) * 2.0 ** rng.integers(-30, 30, 10000)
          ).astype(np.float32) for _ in range(3)]
    got = T._fma(*(torch.from_numpy(v) for v in x)).numpy()
    want = np.array([_round_once(*t) for t in zip(*x)], np.float32)
    want[np.abs(want) < T.FLT_MIN] = 0.0
    np.testing.assert_array_equal(got, want)


def _finish_inputs():
    """262,144 (acc, shift) pairs: every power of two in the normal range,
    4,000 values around 1, 1,000 just above the smallest normal, the
    largest finite, 0, +inf and NaN, the rest uniform over the bits of
    positive normal float32; shifts 0 and multiples of 100 log10(2)."""
    rng = np.random.default_rng(31)
    n = 1 << 18
    acc = rng.integers(0x00800000, 0x7f800000, n,
                       dtype=np.uint32).view(np.float32)
    acc[:254] = np.ldexp(np.float32(1), np.arange(-126, 128))
    eps = np.finfo(np.float32).eps
    acc[256:4256] = np.float32(1) + np.arange(-2000, 2000) * (eps / 2)
    tiny = np.finfo(np.float32).tiny
    acc[4256:5256] = tiny * (1 + np.arange(1000) * eps)
    acc[5256:5261] = [0, np.finfo(np.float32).max, np.inf, np.nan, -1]
    sh = np.zeros(n, np.float32)
    k = rng.integers(1, 8, n // 2)
    sh[n // 2:] = (k * np.float32(T.RESCALE_SHIFT_LOG10)).astype(np.float32)
    return acc, sh


def test_finish_equals_reference_epilogue():
    """``_finish`` (XLA's float32 log, times float32(log10 e) less the
    shift in one FMA, less 120 log10(2)) against the reference's compiled
    epilogue, bit for bit on every value."""
    acc, sh = _finish_inputs()

    @jax.jit
    def epilogue(acc, sh):      # _pairhmm_jax's last lines
        return jnp.where(
            acc > 0.0,
            jnp.log10(jnp.maximum(acc, jnp.finfo(jnp.float32).tiny))
            - sh - J.LOG10_INITIAL, -jnp.inf)

    want = np.asarray(epilogue(jnp.asarray(acc), jnp.asarray(sh)))
    got = T._finish(torch.from_numpy(acc), torch.from_numpy(sh)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    bad = np.flatnonzero(got.view(np.uint32)[ok] != want.view(np.uint32)[ok])
    assert bad.size == 0, (acc[ok][bad[:4]], got[ok][bad[:4]],
                           want[ok][bad[:4]])
    assert np.isneginf(got[acc <= 0]).all() and np.isposinf(got[5258])


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
