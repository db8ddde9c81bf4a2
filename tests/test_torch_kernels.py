"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only the port and its dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` skips the tests directory's conftest, which pins JAX to
the CPU).  Without a CUDA device every test skips.  The seeded input
generators here also feed the port-vs-reference tests of the
Smith-Waterman and PairHMM modules.
"""
import numpy as np
import pytest
import torch

from falcon_genome_tpu_torch.ops import bench_kernels as BK
from falcon_genome_tpu_torch.ops import pairhmm as P
from falcon_genome_tpu_torch.ops import smith_waterman as S

torch.set_num_threads(1)

SW_PARAM_SETS = {"bwa": (1, 4, 6, 1), "hap2ref": (2, 6, 12, 1)}
INS, DEL, GCP = 45, 45, 10


def sw_lanes(seed, R, W, B):
    """Time-major (R, B)/(W, B) lanes: random, embedded copies with
    substitutions and indels, tandem repeats (score ties), off-genome
    window codes, ragged lengths including empty lanes."""
    rng = np.random.default_rng(seed)
    read = rng.integers(0, 4, (R, B)).astype(np.int32)
    win = rng.integers(0, 4, (W, B)).astype(np.int32)
    for b in range(B // 4, B):
        s = int(rng.integers(0, W - R + 1))
        seg = read[:, b].copy()
        seg[rng.random(R) < 0.05] = 2
        if b % 5 == 0:                       # deletion in the read
            seg = np.concatenate([seg[:R // 2], seg[R // 2 + 3:],
                                  seg[:3]])
        win[s:s + R, b] = seg
    for b in range(0, B // 8):               # tandem repeats: ties
        unit = rng.integers(0, 4, 4)
        read[:, b] = np.resize(unit, R)
        win[:, b] = np.resize(unit, W)
    win[W - 7:, B // 3] = 5                  # window past the genome end
    rl = rng.integers(0, R + 1, (1, B)).astype(np.int32)
    wl = rng.integers(0, W + 1, (1, B)).astype(np.int32)
    rl[0, B // 8:B // 2] = R
    wl[0, B // 8:B // 2] = W
    rl[0, -1] = 0                            # empty lanes
    wl[0, -2] = 0
    return read, rl, win, wl


def make_pairs(seed, B, R, H):
    """Reads sampled from their haplotype with substitutions, an N base,
    varied base qualities, plus unrelated pairs that floor to -inf."""
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    rl = rng.integers(R // 2, R + 1, B).astype(np.int32)
    hl = rng.integers(R, H + 1, B).astype(np.int32)
    for b in range(B):
        s = int(rng.integers(0, hl[b] - rl[b] + 1))
        reads[b, :rl[b]] = haps[b, s:s + rl[b]]
        m = rng.random(rl[b]) < 0.04
        reads[b, :rl[b]][m] = (reads[b, :rl[b]][m] + 1) % 4
    reads[:4, :] = rng.integers(0, 4, (4, R))       # unrelated pairs
    reads[4, 2] = 4                                  # N base
    q = rng.integers(10, 41, (B, R)).astype(np.uint8)
    return reads, q, rl, haps, hl


def rescale_pairs(seed, n, R, H):
    """Pairs on the edge of float32.  Reads of quality 0 that mismatch
    every base of a haplotype a little longer than themselves: a cell
    past the haplotype's end (N, prior 1 - 1 = 0) carries nothing, so the
    top rows die and the whole live state falls below 2^-60 at diagonal
    320; only the 2^100 rescale there keeps the last row above the
    smallest normal float32.  The last pair has no such diagonal, and its
    likelihood lies in float32's subnormal range, which flushes to zero."""
    rng = np.random.default_rng(seed)
    reads = np.ones((n, R), np.uint8)
    q = np.zeros((n, R), np.uint8)
    rl = rng.integers(R - 4, R + 1, n).astype(np.int32)
    hl = rng.integers(170, 201, n).astype(np.int32)
    rl[-1], hl[-1] = 155, H
    haps = np.zeros((n, H), np.uint8)
    for b in range(n):
        haps[b, hl[b]:] = 4
    return reads, q, rl, haps, hl


def indel_planes(seed, rl, R):
    """Per-base transition phreds as BQSR's BI/BD tags give them:
    insertion and deletion phreds 25-45 varying along each read, gap
    continuation 10; rows past the read's length are phred 0 (the pad
    value of the reference's blob: p_ins = p_cont = 1, a_mm = a_im = 0)."""
    rng = np.random.default_rng(seed)
    B = len(rl)
    ins = rng.integers(25, 46, (B, R)).astype(np.uint8)
    dele = rng.integers(25, 46, (B, R)).astype(np.uint8)
    gcp = np.full((B, R), GCP, np.uint8)
    pad = np.arange(R)[None, :] >= rl[:, None]
    for x in (ins, dele, gcp):
        x[pad] = 0
    return ins, dele, gcp


def pad_row_pairs(seed, n, R, H):
    """Pairs that only the rescale keeps finite, with per-base transitions
    and pad rows.  Quality-0 reads of R-10 to R-1 bases (the rows past
    rlen are phred 0) against haplotypes of 12-20 bases: every path runs
    ~140 rows through the insertion state at gap continuation phred 5, so
    the state falls below 2^-60 and is rescaled.  The live band of a
    diagonal is one haplotype wide, so no cell that carries mass reaches
    the subnormal flush: float32 stays within ~1e-5 of float64.  Returns
    (reads, q, ins, del, gcp, rlen, haps, hlen)."""
    rng = np.random.default_rng(seed)
    reads = np.ones((n, R), np.uint8)
    q = np.zeros((n, R), np.uint8)
    rl = rng.integers(R - 10, R, n).astype(np.int32)
    hl = rng.integers(12, 21, n).astype(np.int32)
    haps = np.zeros((n, H), np.uint8)
    for b in range(n):
        haps[b, hl[b]:] = 4
    ins, dele, gcp = indel_planes(seed + 1, rl, R)
    gcp[gcp > 0] = 5
    return reads, q, ins, dele, gcp, rl, haps, hl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pset", sorted(SW_PARAM_SETS))
def test_sw_kernels_match_plain_on_card(cuda_device, pset):
    read, rl, win, wl = sw_lanes(4, 96, 200, 256)
    p = S.SWParams(*SW_PARAM_SETS[pset])
    lanes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.T.astype(np.int8), rl[0], win.T.astype(np.int8), wl[0])]
    want_s, want_p = S.sw_score(*lanes, p)
    want = S.sw_full(*lanes, p, 296)
    dev = [x.to(cuda_device) for x in lanes]
    got_s, got_p = S.sw_score(*dev, p)
    got = S.sw_full(*dev, p, 296)
    torch.cuda.synchronize()
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(got_p.cpu(), want_p)
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
def test_pairhmm_kernel_matches_plain_on_card(cuda_device):
    reads, q, rl, haps, hl = (np.concatenate(p) for p in zip(
        make_pairs(5, 512, 160, 384), rescale_pairs(6, 16, 160, 384)))
    args = [torch.from_numpy(x) for x in (reads, q, rl, haps, hl)]
    want = P.pairhmm_sc(*args, INS, DEL, GCP).numpy()
    got = P.pairhmm_sc(*[a.to(cuda_device) for a in args], INS, DEL,
                       GCP).cpu().numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)
    assert fin[512:-1].all() and not fin[-1]   # rescaled; subnormal


@pytest.mark.cuda
def test_pairhmm_pb_kernel_matches_plain_on_card(cuda_device):
    reads, q, rl, haps, hl = make_pairs(7, 512, 160, 384)
    planes = indel_planes(8, rl, 160)
    cr, cq, ci, cd, cg, crl, chp, chl = pad_row_pairs(9, 64, 160, 384)
    args = [torch.from_numpy(np.concatenate(x)) for x in (
        (reads, cr), (q, cq), (planes[0], ci), (planes[1], cd),
        (planes[2], cg), (rl, crl), (haps, chp), (hl, chl))]
    want = P.pairhmm_pb(*args).numpy()
    got = P.pairhmm_pb(*[a.to(cuda_device) for a in args]).cpu().numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)
    assert fin[512:].all()


@pytest.mark.cuda
def test_pairhmm_kernels_flush_as_plain_on_card(cuda_device):
    """The quality-0 rescue pairs, whose mass passes through float32's
    subnormal range, with 45/45/10 (K4) and BI/BD-like planes (K5)."""
    reads, q, rl, haps, hl = rescale_pairs(3, 64, 160, 384)
    args = [torch.from_numpy(x) for x in (reads, q, rl, haps, hl)]
    planes = [torch.from_numpy(x) for x in indel_planes(12, rl, 160)]
    for name, run in (
            ("K4", lambda a, p: P.pairhmm_sc(*a, INS, DEL, GCP)),
            ("K5", lambda a, p: P.pairhmm_pb(a[0], a[1], *p, a[2], a[3],
                                             a[4]))):
        want = run(args, planes).numpy()
        got = run([a.to(cuda_device) for a in args],
                  [p.to(cuda_device) for p in planes]).cpu().numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
        assert fin[:-1].any(), name
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.cuda
def test_fma_ceiling_kernel_matches_plain_on_card(cuda_device):
    """Bit-equal at the bench's shape (160, 2048, 272 trips): the plain
    version rounds each chain update once, as the kernel's FFMA."""
    x = torch.from_numpy(np.random.default_rng(10).uniform(
        0.5, 2.0, (160, 2048)).astype(np.float32)).to(cuda_device)
    want = BK._fma_ceiling_plain(x, 272)
    got = BK.fma_ceiling(x, 272)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["base", "no_best", "no_mask",
                                     "no_window"])
def test_sw_ablate_kernel_matches_plain_on_card(cuda_device, variant):
    read, rl, win, wl = sw_lanes(11, 160, 416, 256)
    lanes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.T.astype(np.int8), rl[0], win.T.astype(np.int8), wl[0])]
    kw = {} if variant == "base" else {variant: True}
    p = S.SWParams()
    want = BK.sw_score_ablate(*lanes, p, **kw)
    dev = [x.to(cuda_device) for x in lanes]
    got = BK.sw_score_ablate(*dev, p, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    if variant == "base":
        k1 = S.sw_score(*dev, p)
        assert torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])
