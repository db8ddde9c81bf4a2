"""The port's golden models (``ops/sw_ref.py::sw_align_ref`` and
``ops/pairhmm_ref.py``) against the JAX package's, and the port's plain
versions of the kernels against them.

The golden models are the float64/int64 NumPy oracles: the port's copies
must give the reference's results (Smith-Waterman exactly, PairHMM to
1e-12).  The plain PyTorch versions (the CPU path, and what the CUDA
kernels are held bit-equal to) must score as the Smith-Waterman model does
and stay within 2e-3 log10 of the PairHMM model, the tolerance of
``tests/test_pairhmm.py:73``."""
import numpy as np
import pytest
import torch

from falcon_genome_tpu.ops import pairhmm_ref as JP
from falcon_genome_tpu.ops import sw_ref as JS
from falcon_genome_tpu_torch import ops as TOPS
from falcon_genome_tpu_torch.io.sam import cigar_query_len
from falcon_genome_tpu_torch.ops import pairhmm as TPH
from falcon_genome_tpu_torch.ops import pairhmm_ref as TP
from falcon_genome_tpu_torch.ops import smith_waterman as TSW
from falcon_genome_tpu_torch.ops import sw_ref as TS

torch.set_num_threads(1)

CPU = torch.device("cpu")
SW_PARAMS = [(1, 4, 6, 1), (2, 6, 12, 1)]     # bwa-mem; HaplotypeCaller


def sw_pairs(seed, n, read_len=30, win_len=56, mutate=0.05, indel=0.04):
    """Reads sampled from their windows with substitutions and indels,
    plus one unrelated read and one of N bases."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 4, (n, win_len)).astype(np.uint8)
    reads = np.zeros((n, read_len), np.uint8)
    for b in range(n):
        s = int(rng.integers(0, win_len - read_len - 4))
        out, i = [], s
        while len(out) < read_len:
            r = rng.random()
            if r < indel / 2:
                i += 1
            elif r < indel:
                out.append(int(rng.integers(0, 4)))
            else:
                base = int(wins[b, min(i, win_len - 1)])
                out.append((base + 1) % 4 if rng.random() < mutate else base)
                i += 1
        reads[b] = out
    reads[-2] = rng.integers(0, 4, read_len)
    reads[-1] = 4
    rl = rng.integers(read_len - 6, read_len + 1, n).astype(np.int32)
    wl = rng.integers(win_len - 8, win_len + 1, n).astype(np.int32)
    return reads, rl, wins, wl


def hmm_pairs(seed, n, read_len=20, hap_len=34):
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 5, (n, hap_len)).astype(np.uint8)
    reads = np.zeros((n, read_len), np.uint8)
    for b in range(n):
        s = int(rng.integers(0, hap_len - read_len + 1))
        reads[b] = haps[b, s:s + read_len]
        m = rng.random(read_len) < 0.08
        reads[b, m] = rng.integers(0, 5, int(m.sum()))
    q = [rng.integers(lo, 45, (n, read_len)).astype(np.uint8)
         for lo in (5, 20, 20)]
    gcp = np.full((n, read_len), 10, np.uint8)
    rl = rng.integers(read_len - 8, read_len + 1, n).astype(np.int32)
    hl = rng.integers(hap_len - 10, hap_len + 1, n).astype(np.int32)
    return reads, q[0], q[1], q[2], gcp, rl, haps, hl


@pytest.mark.parametrize("params", SW_PARAMS)
@pytest.mark.parametrize("seed", [0, 1])
def test_sw_align_ref_matches_reference(params, seed):
    """Score, spans and CIGAR of every pair equal the reference model's."""
    reads, rl, wins, wl = sw_pairs(seed, 12)
    tp, jp = TS.SWParams(*params), JS.SWParams(*params)
    for b in range(len(reads)):
        r, w = reads[b, :rl[b]], wins[b, :wl[b]]
        got, want = TS.sw_align_ref(r, w, tp), JS.sw_align_ref(r, w, jp)
        assert vars(got) == vars(want), b
        assert got.score == 0 or cigar_query_len(got.cigar) == rl[b]


@pytest.mark.parametrize("params", SW_PARAMS)
def test_plain_sw_scores_as_golden_model(params):
    """The plain version of K2/K3 (``sw_extend_batch`` on the CPU) gives
    ``sw_align_ref``'s score, and a CIGAR whose query length is the
    read's (``tests/test_smith_waterman.py:44-48``)."""
    reads, rl, wins, wl = sw_pairs(2, 16)
    p = TS.SWParams(*params)
    res = TSW.sw_extend_batch(reads, rl, wins, wl, p,
                              TSW.SWBucket(32, 64, CPU))
    for b, got in enumerate(res):
        want = TS.sw_align_ref(reads[b, :rl[b]], wins[b, :wl[b]], p)
        assert got.score == want.score, b
        if got.score:
            assert cigar_query_len(got.cigar) == rl[b], b


@pytest.mark.parametrize("seed", [0, 1])
def test_pairhmm_logp_ref_matches_reference(seed):
    """The batched model and the single-pair model equal the reference's
    to 1e-12, -inf where it is -inf."""
    args = hmm_pairs(seed, 10)
    got, want = TP.pairhmm_logp_ref(*args), JP.pairhmm_logp_ref(*args)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert TOPS.pairhmm_logp_ref is TP.pairhmm_logp_ref
    reads, bq, iq, dq, gcp, rl, haps, hl = args
    b = 3
    one = (reads[b, :rl[b]], bq[b, :rl[b]], iq[b, :rl[b]], dq[b, :rl[b]],
           gcp[b, :rl[b]], haps[b, :hl[b]])
    assert abs(TP.pairhmm_logp_single(*one)
               - JP.pairhmm_logp_single(*one)) <= 1e-12
    q = np.array([0, 10, 40], np.uint8)
    np.testing.assert_allclose(TP._phred_to_prob(q), JP._phred_to_prob(q),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("per_base", [False, True])
def test_plain_pairhmm_within_golden_tolerance(per_base):
    """The plain version of K4 (scalar transitions) and K5 (per-base
    planes), through ``pairhmm_logp`` on the CPU, within 2e-3 log10 of
    ``pairhmm_logp_ref``."""
    reads, bq, iq, dq, gcp, rl, haps, hl = hmm_pairs(3, 24)
    if not per_base:
        iq = np.full_like(iq, 45)
        dq = np.full_like(dq, 45)
    got = TPH.pairhmm_logp(
        reads, bq, iq if per_base else 45, dq if per_base else 45,
        gcp if per_base else 10, rl, haps, hl,
        TPH.PairHMMParams(32, 48, CPU))
    want = TP.pairhmm_logp_ref(reads, bq, iq, dq, gcp, rl, haps, hl)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_float32_floor_shared_with_reference():
    """Unrelated pairs (random reads against random haplotypes, log10
    near -94 in float64) fall below float32's range with the 2^100
    rescale: the plain version of K4 gives -inf exactly where the
    reference's float32 path (``backend="jax"``) does, while the golden
    model stays finite.  Pairs sampled from their haplotype stay finite
    and within 2e-3 in both.  The smoke's golden check on the card
    allows -inf only on such unrelated pairs."""
    from falcon_genome_tpu.ops.pairhmm import PairHMMParams as JParams
    from falcon_genome_tpu.ops.pairhmm import pairhmm_logp as jlogp
    rng = np.random.default_rng(0)
    B, R, H = 8, 96, 160
    reads = rng.integers(0, 4, (B, R)).astype(np.uint8)
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    related = np.arange(B) % 2 == 0
    for b in np.flatnonzero(related):
        reads[b] = haps[b, 20:20 + R]
    q = rng.integers(25, 41, (B, R)).astype(np.uint8)
    rl, hl = np.full(B, R, np.int32), np.full(B, H, np.int32)
    got = TPH.pairhmm_logp(reads, q, 45, 45, 10, rl, haps, hl,
                           TPH.PairHMMParams(R, H, CPU))
    ref = np.asarray(jlogp(reads, q, 45, 45, 10, rl, haps, hl,
                           JParams(R, H, backend="jax")))
    gold = TP.pairhmm_logp_ref(reads, q, *(np.full_like(q, v)
                                           for v in (45, 45, 10)),
                               rl, haps, hl)
    assert np.isfinite(gold).all() and (gold[~related] < -80).all()
    assert np.array_equal(np.isfinite(got), related)
    assert np.array_equal(np.isfinite(ref), related)
    np.testing.assert_allclose(got[related], gold[related], rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(ref[related], gold[related], rtol=0,
                               atol=2e-3)
