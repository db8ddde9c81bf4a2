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
on a multiple of 64 past their own last diagonal.  Each case checks that its
inputs do what it says.  Skips only where g++ is missing.
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
    EARLY_DEL, EARLY_GCP, EARLY_INS, GCP, early_rescale_pairs, indel_planes,
    pad_row_pairs, phred_planes, rescale_pairs)

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
