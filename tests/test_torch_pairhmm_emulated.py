"""The PairHMM CUDA source on the CPU: ``csrc/pairhmm.cu`` built with g++
against the stand-in ``csrc/emu/cuda_runtime.h`` (as
``test_torch_sw_emulated.py`` builds ``csrc/smith_waterman.cu``), with the
float32 arithmetic nvcc gives it: ``-DFGT_EMU_FTZ`` (flush-to-zero and
denormals-are-zero in MXCSR during each launch, for ``-ftz=true``),
``-ffp-contract=off`` (for ``--fmad=false``) and ``-mfma`` (the explicit
``__fmaf_rn`` rounded once).

K4 (``fgt_pairhmm``) and K5 (``fgt_pairhmm_pb``) from that library, called
through the port's launch helpers on CPU tensors, are held bit for bit to
the plain version (``_pairhmm_plain``): at read lengths that reach every
rows-per-thread instantiation (1 to 12 rows a thread, so the 64-bit read
mask window of 9-12 rows too), each against a haplotype bucket of R + 8
and of 384, with ragged lengths, an empty read, an empty haplotype, a
one-cell matrix, N and out-of-range codes and a lane that floors to -inf,
and (from 64 rows on) with the card tests' pairs that are finite only
through the 2^100 rescale at diagonal 64; and on the card tests' pairs
rescaled through pad rows and at diagonal 320, with one whose mass
passes through float32's subnormal range, and quality-0 pairs rescaled
on a multiple of 64 past their own last diagonal.  K4 and K5 sweep a pair
over its own ceil(rlen / 32) rows a thread where its rescale cannot fire,
and their warps take pairs from a queue: launches that mix such pairs of
every rows-a-thread step with pairs that need the bucket's rows
(quality-0 first bases; the pairs rescaled at diagonal 64; for K5 a gap
continuation phred of 0 on row 0), more pairs than the emulated grid has
warps, hold both to the plain version too, K4's and K5's launches in
turn on one queue.  Each case checks that its inputs do what it says.
Skips only where g++ is missing.
"""
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu_torch.ops import _build
from falcon_genome_tpu_torch.ops import pairhmm as P

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_kernels import (  # noqa: E402
    EARLY_DEL, EARLY_GCP, EARLY_INS, GCP, early_rescale_pairs,
    gcp0_row0_pairs, indel_planes, own_rows_pairs, pad_row_pairs,
    phred_planes, rescale_pairs, run_kernel, shuffled, with_planes)

torch.set_num_threads(1)

CSRC = Path(P.__file__).resolve().parent.parent / "csrc"
# one read bucket per rows-per-thread count NR = ceil(R / 32), 1 to 12:
# ragged (R < 32 NR) at odd NR, full at even NR and at HaplotypeCaller's
# 160; each against haplotypes of R + 8 and of 384
READ_BUCKETS = [27, 64, 91, 128, 160, 183, 224, 250, 283, 320, 347, 384]
SHAPES = [(R, H) for R in READ_BUCKETS for H in sorted({R + 8, 384})]
SCALARS = (45, 45, GCP)
B = 8
# without a rescale no finite log10 likelihood lies below this: the
# smallest normal float32 under the initial 2^120
FLOOR_WITHOUT_RESCALE = math.log10(2.0 ** -126) - P.LOG10_INITIAL


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source on the host")
    so = tmp_path_factory.mktemp("pairhmm_emu") / "libpairhmm_emu.so"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w", "-mfma",
         "-ffp-contract=off", "-DFGT_EMU_FTZ", "-I", str(CSRC / "emu"),
         "-x", "c++", str(CSRC / "pairhmm.cu"), "-o", str(so)],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return _build.bind(ctypes.CDLL(str(so)))


def bucket_lanes(R, H):
    """Lane-major (reads, q, rlen, haps, hlen) of 8 pairs for the bucket:
    0 fills it (rlen R, hlen H), 1 is one short of it on both sides, 2
    has N bases in the read and codes above 4 in the haplotype; 3 an
    empty read, 4 an empty haplotype, 6 a one-cell matrix (1-4 and 7
    ragged otherwise); 5 is an unrelated read of quality 60, which floors
    to -inf from 91 bases on.  Reads are copies of their haplotype with
    4% substitutions, base qualities 10-40."""
    rng = np.random.default_rng(R * 1000 + H)
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    q = rng.integers(10, 41, (B, R)).astype(np.uint8)
    rl = rng.integers(1, R + 1, B).astype(np.int32)
    hl = rng.integers(1, H + 1, B).astype(np.int32)
    rl[0], hl[0] = R, H
    rl[1], hl[1] = R - 1, H - 1
    rl[6], hl[6] = 1, 1
    for b in range(B):
        hl[b] = max(hl[b], rl[b])
        s = int(rng.integers(0, hl[b] - rl[b] + 1))
        seg = haps[b, s:s + rl[b]].copy()
        m = rng.random(rl[b]) < 0.04
        seg[m] = (seg[m] + 1) % 4
        reads[b, :rl[b]] = seg
    reads[2, ::7] = 4
    haps[2, 1::9] = 9
    rl[3] = 0
    hl[4] = 0
    rl[5], hl[5] = R, H
    reads[5] = rng.integers(0, 4, R)
    q[5] = 60
    return reads, q, rl, haps, hl


def early_rescale_lanes(R, H):
    """``early_rescale_pairs`` cut to the bucket: the pairs of at most R
    bases (all four from R = 70 on), whose state is rescaled at diagonal
    64 under 45/0/13 and is finite only through it."""
    reads, q, rl, haps, hl = early_rescale_pairs(max(R, 70), H)
    keep = rl <= R
    return (reads[keep, :R], q[keep, :R], rl[keep], haps[keep],
            hl[keep])


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _hold_k4(lib, lanes, scalars):
    """K4 from ``lib`` against the plain version, bit for bit; returns the
    plain log10."""
    read, q, rl, hap, hl = _tensors(*lanes)
    want = P.pairhmm_sc(read, q, rl, hap, hl, *scalars)
    got = P._pairhmm_sc_launch(lib, read, q, rl, hap, hl,
                               P._transitions(*scalars), None)
    assert torch.equal(got, want), (got, want)
    return want


def _hold_k5(lib, lanes, planes):
    """K5 from ``lib`` against the plain version, bit for bit; returns the
    plain log10."""
    read, q, rl, hap, hl = _tensors(*lanes)
    pl = _tensors(q, *planes)
    want = P.pairhmm_pb(read, *pl, rl, hap, hl)
    got = P._pairhmm_pb_launch(lib, read, pl, rl, hap, hl, None)
    assert torch.equal(got, want), (got, want)
    return want


def _check_lanes_do_what_they_say(R, want):
    want = want.numpy()
    assert np.isneginf(want[[3, 4]]).all()
    assert np.isfinite(want[[0, 1, 2, 6, 7]]).all()
    if R >= 91:
        assert np.isneginf(want[5])


def _check_rescaled(want, lanes):
    """Every pair finite, and below the floor of an unrescaled likelihood
    where it goes on past diagonal 64 (a pair that ends there has its sum
    rescaled, not its cells)."""
    assert torch.isfinite(want).all()
    longer = torch.from_numpy(lanes[2] + lanes[4] > 64)
    assert longer.any()
    assert (want[longer] < FLOOR_WITHOUT_RESCALE).all()


EARLY = (EARLY_INS, EARLY_DEL, EARLY_GCP)


@pytest.mark.parametrize("R,H", SHAPES)
def test_emulated_k4_matches_plain(emu_lib, R, H):
    lanes = bucket_lanes(R, H)
    _check_lanes_do_what_they_say(R, _hold_k4(emu_lib, lanes, SCALARS))
    if R >= 64:
        lanes = early_rescale_lanes(R, H)
        _check_rescaled(_hold_k4(emu_lib, lanes, EARLY), lanes)


@pytest.mark.parametrize("R,H", SHAPES)
def test_emulated_k5_matches_plain(emu_lib, R, H):
    lanes = bucket_lanes(R, H)
    planes = indel_planes(R + H, lanes[2], R)
    _check_lanes_do_what_they_say(R, _hold_k5(emu_lib, lanes, planes))
    if R >= 64:
        lanes = early_rescale_lanes(R, H)
        _check_rescaled(_hold_k5(emu_lib, lanes,
                                 phred_planes(lanes[2], R, *EARLY)), lanes)


def test_emulated_k5_rescales_through_pad_rows(emu_lib):
    """K5 on quality-0 reads of R-10 to R-1 bases (phred-0 pad rows below
    them) that only the rescale keeps finite."""
    reads, q, ins, dele, gcp, rl, haps, hl = pad_row_pairs(5, B, 160, 384)
    lanes = (reads, q, rl, haps, hl)
    _check_rescaled(_hold_k5(emu_lib, lanes, (ins, dele, gcp)), lanes)


@pytest.mark.parametrize("R,H", [(64, 128), (96, 128)])
def test_emulated_kernels_rescale_past_the_pairs_end(emu_lib, R, H):
    """Quality-0 pairs that end before R + H and are rescaled on a
    multiple of 64 past rlen + hlen, as the reference's full sweep does:
    K5 on pad-row pairs, K4 on the rescue pairs, each a batch of nothing
    else, bit-equal to the plain version."""
    reads, q, ins, dele, gcp, rl, haps, hl = pad_row_pairs(9, B, R, H)
    assert (rl + hl).max() <= R + H - 64
    want = _hold_k5(emu_lib, (reads, q, rl, haps, hl), (ins, dele, gcp))
    assert torch.isfinite(want).all()
    lanes = rescale_pairs(3, B, R, H)
    assert torch.isfinite(_hold_k4(emu_lib, lanes, SCALARS)[:-1]).any()


def test_emulated_kernels_flush_as_plain(emu_lib):
    """The quality-0 rescue pairs, whose mass passes through float32's
    subnormal range: the rescale keeps all but the last finite, and the
    last, which has no rescale diagonal, flushes to -inf as the plain
    version's does (a build without flush-to-zero keeps it finite)."""
    lanes = rescale_pairs(3, B, 160, 384)
    want4 = _hold_k4(emu_lib, lanes, SCALARS)
    want5 = _hold_k5(emu_lib, lanes, indel_planes(12, lanes[2], 160))
    for want in (want4, want5):
        assert torch.isfinite(want[:-1]).any()
        assert torch.isneginf(want[-1])


# the emulated card's warps: kEmuSMs blocks of 8 (csrc/emu/cuda_runtime.h)
EMU_WARPS = 16


def _late(lanes, a_im0):
    """Which pairs need the bucket's rows: the plain version's
    ``_late_rescale`` on row 0's priors and ``a_im0``, row 0's a_im."""
    _, q, _, _, hl = lanes[:5]
    p_err = P._phred_to_prob(torch.from_numpy(q[:, 0]))
    prior = torch.minimum(1.0 - p_err, p_err * torch.tensor(
        1.0 / 3.0, dtype=torch.float32))
    bound = torch.tensor(2.0 ** 120, dtype=torch.float32) / torch.clamp(
        torch.from_numpy(hl).float(), min=1.0)
    return P._late_rescale(prior, bound, a_im0).numpy()


def _in_bucket(lanes, R):
    """Lane-major pairs of a smaller read bucket in the bucket R: N bases
    and phred 0 past their reads."""
    reads, q, rl, haps, hl = lanes
    pad = ((0, 0), (0, R - reads.shape[1]))
    return (np.pad(reads, pad, constant_values=4), np.pad(q, pad), rl,
            haps, hl)


def _hold(kernel, lib, lanes, phreds):
    """K4 (``phreds`` as scalars) or K5 (the planes after the pairs) from
    ``lib`` against the plain version, bit for bit; returns the plain
    log10."""
    if kernel == "K4":
        return _hold_k4(lib, lanes, phreds)
    return _hold_k5(lib, lanes[:5], lanes[5:])


@pytest.mark.parametrize("kernel,R,H", [
    pytest.param("K4", 152, 384, id="152-384"),
    pytest.param("K4", 384, 384, id="384-384"),
    pytest.param("K5", 152, 384, id="K5-152-384"),
    pytest.param("K5", 384, 384, id="K5-384-384")])
def test_emulated_k4_own_rows_and_queue(emu_lib, kernel, R, H, monkeypatch):
    """K4 and K5 bit-equal to the plain version on launches that mix pairs
    over their own rows (every step of ceil(rlen / 32) up to the bucket's)
    with pairs that need the bucket's rows: the quality-0 rescue pairs of
    up to 160 bases at 45/45/10 (rescaled, all but the last, which has no
    rescale diagonal), the pairs rescaled at diagonal 64 at 45/0/13, and
    in the 384-row bucket quality-0 pairs of 380-384 bases, which no
    rescale keeps finite.  K5 takes those phreds as planes on every row,
    BI/BD-like planes on the own-rows pairs, and adds pairs late through a
    gap continuation phred of 0 on row 0 alone (-inf).  Each launch holds
    more pairs than the emulated grid has warps, a count that is not a
    multiple of 8, and leaves its queue at zero for the next.
    ``rescued``: how many of a case's late pairs, from its first, the
    rescale keeps finite."""
    cases = [(SCALARS, _in_bucket(rescale_pairs(3, 5, min(R, 160), H), R),
              4),
             (EARLY, early_rescale_lanes(R, H), len(
                 early_rescale_lanes(R, H)[2]))]
    if R > 160:
        cases.append((SCALARS, rescale_pairs(3, 5, R, H), 0))
    for i, (phreds, late_pairs, rescued) in enumerate(cases):
        own_pairs = own_rows_pairs(10 + i, R, H, 3)
        if kernel == "K5":
            own_pairs = (*own_pairs,
                         *indel_planes(40 + i, own_pairs[2], R))
            late_pairs = [np.concatenate(x) for x in zip(
                with_planes(late_pairs, phreds, R),
                (x[::2] for x in gcp0_row0_pairs(50 + i, R, H, 1)))]
        n_late = len(late_pairs[2])
        # each late pair tagged with its index, the others with -1
        *lanes, tag = shuffled(i, (*own_pairs, np.full(len(own_pairs[2]),
                                                      -1)),
                               (*late_pairs, np.arange(n_late)))
        lanes = tuple(lanes)
        B = len(lanes[2])
        assert B > EMU_WARPS and B % 8
        a_im0 = (1.0 - P._phred_to_prob(torch.from_numpy(lanes[7][:, 0]))
                 if kernel == "K5" else
                 torch.tensor(P._transitions(*phreds)[4]))
        late = _late(lanes, a_im0)
        assert late.sum() == n_late and (late == (tag >= 0)).all()
        if kernel == "K4":
            pairs = np.arange(B)
            assert P._k4_work(lanes[1], lanes[2], lanes[4], pairs, pairs,
                              phreds[2], R, H)["fitted"] == B - n_late
        want = _hold(kernel, emu_lib, lanes, phreds)
        assert torch.isfinite(want[torch.from_numpy(~late)]).any()
        queue = P._launch_queue(torch.device("cpu"), None)
        assert queue.tolist() == [0, 0]
        # the rescued pairs: finite, and each that goes on past diagonal 64
        # (one that ends there has its sum rescaled, not its cells) another
        # value in the plain version without the rescale; the rest -inf
        kept = (tag >= 0) & (tag < rescued)
        assert torch.isfinite(want[torch.from_numpy(kept)]).all()
        assert torch.isneginf(want[torch.from_numpy(tag >= rescued)]).all()
        kept &= lanes[2] + lanes[4] > 64
        assert kept.sum() >= min(rescued, 3)
        rescaled = want[torch.from_numpy(kept)]
        with monkeypatch.context() as m:
            m.setattr(P, "RESCALE_THRESH", 0.0)
            unscaled = run_kernel(kernel, _tensors(*(x[kept] for x in lanes)),
                                  phreds)
        assert (unscaled != rescaled).all(), (unscaled, rescaled)


def test_emulated_k4_queue_over_many_launches(emu_lib):
    """Launches of 1 to 37 pairs back to back on one queue, K4's and K5's
    in turn, each bit-equal to the plain version and each leaving the
    queue at zero: a launch that left it short of zero would skip pairs of
    the next, whichever kernel that is."""
    lanes = own_rows_pairs(5, 64, 72, 7)
    planes = indel_planes(6, lanes[2], 64)
    queue = P._launch_queue(torch.device("cpu"), None)
    for n in (37, 1, 9, 16, 17):
        _hold_k4(emu_lib, tuple(x[:n] for x in lanes), SCALARS)
        assert queue.tolist() == [0, 0]
        _hold_k5(emu_lib, tuple(x[:n] for x in lanes),
                 tuple(x[:n] for x in planes))
        assert queue.tolist() == [0, 0]
