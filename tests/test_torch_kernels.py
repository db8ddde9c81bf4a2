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


def edge_pairs(seed, B, R, H):
    """``make_pairs`` with the edges of the sweep in its first 12 lanes:
    hlen = H, rlen = R, rlen = 1, rlen + hlen odd and even at the largest
    sum, N runs in the read and in the haplotype, codes above 4 in both,
    every code 0-15 at random, a one-base haplotype, a one-cell matrix."""
    rng = np.random.default_rng(seed + 100)
    reads, q, rl, haps, hl = make_pairs(seed, B, R, H)
    hl[0] = H
    rl[1] = R
    reads[1] = rng.integers(0, 4, R)
    rl[2] = 1
    rl[3], hl[3] = R, H
    rl[4], hl[4] = R - 1, H
    reads[5, ::3] = 4
    haps[6, ::5] = 4
    reads[7, 1], haps[7, 3] = 7, 9
    haps[8] = rng.integers(0, 16, H)
    reads[9] = rng.integers(0, 16, R)
    hl[10] = 1
    rl[11], hl[11] = 1, 1
    return reads, q, rl, haps, hl


# transition phreds of ``early_rescale_pairs``
EARLY_INS, EARLY_DEL, EARLY_GCP = 45, 0, 13


def early_rescale_pairs(R, H):
    """Pairs whose rescale fires at diagonal 64, the first test, with
    ins/del/gcp phreds 45/0/13 (needs R >= 70).  Quality-0 reads of 52,
    64, 65 and 70 bases that mismatch all 12 bases of their haplotype: a
    deletion probability of 1 leaves no match-to-match transition, so the
    mass leaves the 12 live columns within a few rows and what stays
    decays by the gap continuation per row, to about 2^-80 at diagonal 64.
    The first pair ends there (52 + 12), so its rescale touches only the
    sum and the shift; the others are finite only through the rescale."""
    rl = np.array([52, 64, 65, 70], np.int32)
    n = len(rl)
    reads = np.ones((n, R), np.uint8)
    for b in range(n):
        reads[b, rl[b]:] = 4
    q = np.zeros((n, R), np.uint8)
    hl = np.full(n, 12, np.int32)
    haps = np.zeros((n, H), np.uint8)
    haps[:, 12:] = 4
    return reads, q, rl, haps, hl


def phred_planes(rl, R, ins, dele, gcp):
    """Constant transition phreds along each read, phred 0 past rlen."""
    real = np.arange(R)[None, :] < np.asarray(rl)[:, None]
    return tuple(np.where(real, v, 0).astype(np.uint8)
                 for v in (ins, dele, gcp))


# read and haplotype buckets of the card tests: the main shape, then one
# bucket for each kind of instantiation (rows not a multiple of 32, one
# row per thread, eight rows per thread) with short and long haplotypes,
# and the 64-bit mask window of long reads clipped to active regions
# (10 rows a thread, ragged; 12, full)
PAIRHMM_SHAPES = [(160, 384), (8, 128), (96, 128), (256, 512), (150, 512),
                  (300, 384), (384, 512)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


# read and window buckets of the Smith-Waterman card tests: the aligner's
# 160 x 256, mate rescue's 160 x 1024, HaplotypeCaller's 384 x 384 (12
# rows per thread), reads that do not fill their threads' rows (100 rows
# at 4 a thread, 200 at 7) and 416 rows, more than one stripe of 384
SW_SHAPES = [(160, 256), (160, 1024), (384, 384), (100, 200), (200, 230),
             (416, 448)]


@pytest.mark.cuda
@pytest.mark.parametrize("pset", sorted(SW_PARAM_SETS))
@pytest.mark.parametrize("R,W", SW_SHAPES)
def test_sw_kernels_match_plain_on_card(cuda_device, R, W, pset):
    """K1, K2 and K3 bit-equal to the plain versions: scores, bestpos, op
    streams and coordinates, with empty lanes (rlen 0, wlen 0), ragged
    lengths and score ties (``sw_lanes``)."""
    read, rl, win, wl = sw_lanes(4 + R, R, W, 256)
    p = S.SWParams(*SW_PARAM_SETS[pset])
    lanes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.T.astype(np.int8), rl[0], win.T.astype(np.int8), wl[0])]
    want_s, want_p = S.sw_score(*lanes, p)
    want = S.sw_full(*lanes, p, R + W)
    dev = [x.to(cuda_device) for x in lanes]
    got_s, got_p = S.sw_score(*dev, p)
    got = S.sw_full(*dev, p, R + W)
    torch.cuda.synchronize()
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(got_p.cpu(), want_p)
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("R,H", PAIRHMM_SHAPES)
def test_pairhmm_kernel_matches_plain_on_card(cuda_device, R, H):
    """K4 on ordinary pairs and the sweep's edges; at the main shape also
    on the quality-0 rescue pairs (rescaled at the last multiple of 64
    their sweep reaches, 320; the last one subnormal)."""
    main = (R, H) == (160, 384)
    parts = [edge_pairs(5, 512 if main else 256, R, H)]
    if main:
        parts.append(rescale_pairs(6, 16, R, H))
    reads, q, rl, haps, hl = (np.concatenate(p) for p in zip(*parts))
    args = [torch.from_numpy(x) for x in (reads, q, rl, haps, hl)]
    want = P.pairhmm_sc(*args, INS, DEL, GCP).numpy()
    got = P.pairhmm_sc(*[a.to(cuda_device) for a in args], INS, DEL,
                       GCP).cpu().numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[fin], want[fin])
    if main:
        assert fin[512:-1].all() and not fin[-1]   # rescaled; subnormal


@pytest.mark.cuda
@pytest.mark.parametrize("R,H", PAIRHMM_SHAPES)
def test_pairhmm_pb_kernel_matches_plain_on_card(cuda_device, R, H):
    """K5 on ordinary pairs and the sweep's edges; from 96 rows on also
    on pad-row pairs, which only the rescale keeps finite (at 256 rows
    they underflow all the same: there the -inf lanes are the check)."""
    main = (R, H) == (160, 384)
    reads, q, rl, haps, hl = edge_pairs(7, 512 if main else 256, R, H)
    lanes = [reads, q, *indel_planes(8, rl, R), rl, haps, hl]
    n = len(rl)
    if R >= 96:
        lanes = [np.concatenate(x) for x in zip(
            lanes, pad_row_pairs(9, 64, R, H))]
    args = [torch.from_numpy(x) for x in lanes]
    want = P.pairhmm_pb(*args).numpy()
    got = P.pairhmm_pb(*[a.to(cuda_device) for a in args]).cpu().numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[fin], want[fin])
    assert fin[n:].all() or R > 160


@pytest.mark.cuda
def test_pairhmm_entry_points_under_a_mesh_of_cards(cuda_device):
    """``pairhmm_logp`` (scalars, planes), ``pairhmm_logp_pairs`` and the
    sharded step on the card bit-equal to the plain versions on the CPU
    with the same -inf lanes, and, under a mesh that repeats every
    visible card, bit-equal to no mesh at 1, 4656 and 8192 pairs, also
    from as many threads at once as there are cards (each thread's
    calls on its own card)."""
    import threading
    from falcon_genome_tpu_torch.parallel import mesh as TM
    from falcon_genome_tpu_torch.parallel import sharded as TS
    R, H = 160, 384
    reads, q, rl, haps, hl = make_pairs(23, 8192, R, H)
    ins, dele, gcp = indel_planes(24, rl, R)
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    mesh = TM.make_mesh(TM.MeshSpec(data=2 * len(cards), region=1),
                        cards * 2)
    one = P.PairHMMParams(max_read_len=R, max_hap_len=H,
                          device=cards[0])
    cpu = P.PairHMMParams(max_read_len=R, max_hap_len=H,
                          device=torch.device("cpu"))
    nh = 4

    def calls(n, params):
        nr = -(-n // nh)
        pr, ph = np.arange(n) // nh, np.arange(n) % nh
        lanes = [torch.from_numpy(np.ascontiguousarray(x[:n])).to(
            params.device) for x in (reads, q, ins, dele, gcp, rl, hl, haps)]
        return {
            "logp": P.pairhmm_logp(reads[:n], q[:n], INS, DEL, GCP, rl[:n],
                                   haps[:n], hl[:n], params),
            "planes": P.pairhmm_logp(reads[:n], q[:n], ins[:n], dele[:n],
                                     gcp[:n], rl[:n], haps[:n], hl[:n],
                                     params),
            "pairs": P.pairhmm_logp_pairs(reads[:nr], q[:nr], rl[:nr],
                                          haps[:nh], hl[:nh], pr, ph, INS,
                                          DEL, GCP, params),
            "step": TS.sharded_pairhmm_step(mesh, R, H)(*lanes).cpu(
                ).numpy()}
    with TM.use_mesh(None):
        got, want = calls(300, one), calls(300, cpu)
    for k in got:
        fin = np.isfinite(want[k])
        np.testing.assert_array_equal(np.isfinite(got[k]), fin, err_msg=k)
        np.testing.assert_array_equal(got[k][fin], want[k][fin],
                                      err_msg=k)
    wants = {}
    for n in (1, 4656, 8192):
        with TM.use_mesh(None):
            wants[n] = want = calls(n, one)
        with TM.use_mesh(mesh):
            got = calls(n, one)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(k, n))
    outs = [None] * len(cards)

    def worker(i):
        with TM.use_mesh(mesh):
            outs[i] = calls(4656, one)
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(cards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got in outs:
        for k in got:
            np.testing.assert_array_equal(got[k], wants[4656][k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("R,H", [(160, 384), (96, 128), (256, 512)])
def test_pairhmm_kernels_rescale_at_diagonal_64_on_card(cuda_device, R, H):
    """Pairs rescaled at the first test, one of them on its last
    diagonal, with 45/0/13 as scalars (K4) and as planes (K5)."""
    reads, q, rl, haps, hl = early_rescale_pairs(R, H)
    args = [torch.from_numpy(x) for x in (reads, q, rl, haps, hl)]
    planes = [torch.from_numpy(x) for x in phred_planes(
        rl, R, EARLY_INS, EARLY_DEL, EARLY_GCP)]
    for name, run in (
            ("K4", lambda a, p: P.pairhmm_sc(*a, EARLY_INS, EARLY_DEL,
                                             EARLY_GCP)),
            ("K5", lambda a, p: P.pairhmm_pb(a[0], a[1], *p, a[2], a[3],
                                             a[4]))):
        want = run(args, planes).numpy()
        got = run([a.to(cuda_device) for a in args],
                  [p.to(cuda_device) for p in planes]).cpu().numpy()
        assert np.isfinite(want).all(), name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.cuda
def test_prob_table_equals_pow_on_card(cuda_device):
    """The kernels' phred table on the card holds the bits of the
    reference's powf (the CPU table), and ``_phred_to_prob`` reads it for
    a plane on the card."""
    q = torch.arange(256, dtype=torch.uint8, device=cuda_device)
    table = P._prob_table(cuda_device)
    plane = q.repeat(160, 3)[:, :700].contiguous()
    assert torch.equal(table.cpu(), P._prob_table(torch.device("cpu")))
    assert torch.equal(table, P._phred_to_prob(q))
    assert torch.equal(table[plane.long()], P._phred_to_prob(plane))


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
        np.testing.assert_array_equal(got[fin], want[fin], err_msg=name)


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


@pytest.mark.cuda
@pytest.mark.parametrize("flags", range(8))
@pytest.mark.parametrize("R,W", [(27, 35), (160, 416), (384, 392),
                                 (416, 448)])
def test_sw_ablate_kernel_all_flags_on_card(cuda_device, R, W, flags):
    """K7 in all eight flag sets (1 no_best, 2 no_mask, 4 no_window) at
    1, 5 and 12 rows a thread and two stripes, bit-equal to the plain
    version; a quarter of the lanes with windows longer than W, whose
    last diagonal lies inside the mask."""
    read, rl, win, wl = sw_lanes(12 + R, R, W, 256)
    wl[0, ::4] = W + R
    lanes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.T.astype(np.int8), rl[0], win.T.astype(np.int8), wl[0])]
    kw = dict(no_best=bool(flags & 1), no_mask=bool(flags & 2),
              no_window=bool(flags & 4))
    p = S.SWParams()
    want = BK.sw_score_ablate(*lanes, p, **kw)
    got = BK.sw_score_ablate(*[x.to(cuda_device) for x in lanes], p, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def gathered_lanes(seed, G, B, R=160, W=256):
    """Long-read chunk lanes: a random genome of G bases and B reads of
    100-144 bases cut from it with 5% substitutions, their windows of 240
    bases starting 30 before them; the first lanes' windows start before
    the genome, the last ones run past its end (code 5 there)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    rl = rng.integers(100, 145, B).astype(np.int32)
    starts = rng.integers(-60, G - 120, B).astype(np.int32)
    starts[:8] = -np.arange(1, 9) * 20
    starts[-8:] = G - np.arange(2, 10) * 30
    for b in range(B):
        seg = genome[max(starts[b] + 30, 0):][:rl[b]]
        rl[b] = len(seg)
        reads[b, :len(seg)] = np.where(rng.random(len(seg)) < 0.05,
                                       (seg + 1) % 4, seg)
    return genome, reads, rl, starts, np.full(B, W - 16, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("max_lanes", [8192, 1024])
def test_sw_win_dispatch_matches_plain_on_card(cuda_device, max_lanes,
                                               monkeypatch):
    """K2 then K3 through ``sw_extend_win_dispatch`` at the long-read
    bucket 160 x 256, windows gathered on the card from the resident
    genome (past both of its ends too), against the plain versions on the
    CPU: ops, lengths, counts, coordinates and scores bit-equal; 3000
    lanes in one call and split at a smaller ``MAX_LANES_PER_CALL``."""
    monkeypatch.setattr(S, "MAX_LANES_PER_CALL", max_lanes)
    genome, reads, rl, starts, wl = gathered_lanes(max_lanes, 200_000, 3000)
    p = S.SWParams()
    want, got = (S.sw_extend_collect_arrays(S.sw_extend_win_dispatch(
        reads, rl, S.device_genome(genome, dev), starts, wl, p,
        S.SWBucket(160, 256, dev))) for dev in (torch.device("cpu"),
                                               cuda_device))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert (got[4] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("R,W", [(160, 384), (160, 256)])
def test_sw_kernels_stop_at_w_on_card(cuda_device, R, W):
    """Lanes whose wlen exceeds W (a quarter of them, by R): K1-K3 stop at
    column W as the plain versions do, bit for bit, at indel's 160 x 384
    and the long-read bucket."""
    read, rl, win, wl = sw_lanes(7 + R, R, W, 256)
    wl[0, ::4] = W + R
    p = S.SWParams()
    lanes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.T.astype(np.int8), rl[0], win.T.astype(np.int8), wl[0])]
    want_s, want_p = S.sw_score(*lanes, p)
    want = S.sw_full(*lanes, p, R + W)
    dev = [x.to(cuda_device) for x in lanes]
    got_s, got_p = S.sw_score(*dev, p)
    got = S.sw_full(*dev, p, R + W)
    torch.cuda.synchronize()
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(got_p.cpu(), want_p)
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
def test_long_read_aligner_on_card_equals_cpu(cuda_device):
    """``LongReadAligner.align_batch`` on the card and on the CPU: 24
    reads of 2-4 kb with 5% substitutions and deletions, both strands,
    give equal alignments."""
    from falcon_genome_tpu_torch.aligner import IndexParams, MinimizerIndex
    from falcon_genome_tpu_torch.io.dna import revcomp_codes
    from falcon_genome_tpu_torch.longread import LongReadAligner
    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, 300_000).astype(np.uint8)
    idx = MinimizerIndex([("chr1", genome)], IndexParams(19, 10, 256))
    reads = []
    for t in range(24):
        p = int(rng.integers(0, len(genome) - 5000))
        r = genome[p:p + int(rng.integers(2000, 4000))].copy()
        err = rng.random(len(r)) < 0.05
        sub = rng.random(len(r)) < 0.6
        r[err & sub] = (r[err & sub] + 1) % 4
        r = r[~(err & ~sub)]
        reads.append(revcomp_codes(r) if t % 2 else r)
    want, got = (LongReadAligner(idx, device=dev).align_batch(reads)
                 for dev in (torch.device("cpu"), cuda_device))
    assert [vars(a) for a in want] == [vars(a) for a in got]
    assert all(a.mapped for a in got)
