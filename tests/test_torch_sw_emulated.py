"""The Smith-Waterman CUDA source on the CPU: ``csrc/smith_waterman.cu``
built with g++ against the stand-in ``csrc/emu/cuda_runtime.h``, which runs
each warp's 32 lanes as coroutines (shuffles and ballots as exchanges, the DPX
intrinsics as their plain definitions, the launches as a host loop over
the blocks).

K1, K2 and K3 from that library, called through the port's own launch
helpers on CPU tensors, are held bit for bit to the plain versions
(``_plain_scan``, ``_traceback_core``): scores, bestpos, op streams and
coordinates, at read lengths that reach every rows-per-thread
instantiation of the sweep (1 to 12 rows a thread) and the stripe loop of
longer reads, with empty lanes, ragged lengths and score ties, under both
parameter sets; K3 also on walks chosen for its runs (``WALKS``).  The
round trips behind K3's latency floor in ``chip_smoke.py`` are held to
K3's loop written out in Python.  What the stand-in cannot show (the
card's scheduling, its compiler) the ``cuda`` tests of
``test_torch_kernels.py`` hold on the card.  Skips only where g++ is
missing.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu_torch.ops import _build
from falcon_genome_tpu_torch.ops import smith_waterman as S

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_kernels import SW_PARAM_SETS, sw_lanes  # noqa: E402

torch.set_num_threads(1)

CSRC = Path(S.__file__).resolve().parent.parent / "csrc"
# (R, W): one read length per rows-per-thread count NR = ceil(R / 32),
# 1 to 12, most of them not a multiple of 32 NR, the aligner's 160 x 256,
# and 416 rows (two stripes of 384, the second one partial)
SHAPES = [(27, 35), (64, 72), (91, 99), (128, 136), (155, 163), (160, 256),
          (192, 200), (219, 227), (256, 264), (283, 291), (320, 328),
          (347, 355), (384, 392), (416, 424)]
B = 8


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source on the host")
    so = tmp_path_factory.mktemp("sw_emu") / "libsw_emu.so"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
         "-I", str(CSRC / "emu"), "-x", "c++", str(CSRC / "smith_waterman.cu"),
         "-o", str(so)], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return _build.bind(ctypes.CDLL(str(so)))


@pytest.mark.parametrize("pset", sorted(SW_PARAM_SETS))
@pytest.mark.parametrize("R,W", SHAPES)
def test_emulated_kernels_match_plain(emu_lib, R, W, pset):
    read, rl, win, wl = sw_lanes(R + W, R, W, B)
    lanes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.T.astype(np.int8), rl[0], win.T.astype(np.int8), wl[0])]
    p = S.SWParams(*SW_PARAM_SETS[pset])
    steps = R + W

    want_s, want_p = S.sw_score(*lanes, p)
    got_s, got_p = S._sw_score_launch(emu_lib, *lanes, p, None)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_p, want_p)

    ptr, best, pos = S._sw_full_launch(emu_lib, *lanes, p, None)
    assert torch.equal(best, want_s)
    assert torch.equal(pos, want_p)
    want = S.sw_full(*lanes, p, steps)
    got = S._sw_traceback_launch(emu_lib, ptr, best, pos, steps, None)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


# ---------------------------------------------------------------------------
# the walk (K3) on cases chosen for it
# ---------------------------------------------------------------------------

def _copies(rng, B, R, W, edit):
    """Lane-major lanes: window b is random, read b a copy of a stretch of
    it passed through ``edit(rng, b, seg)``."""
    read = np.full((B, R), 4, np.int8)
    win = rng.integers(0, 4, (B, W)).astype(np.int8)
    rl = np.zeros(B, np.int32)
    for b in range(B):
        seg = edit(rng, b, win[b].copy())[:R]
        read[b, :len(seg)] = seg
        rl[b] = len(seg)
    return read, rl, win, np.full(B, W, np.int32)


def _stripe_crossing(rng, b, w):
    # all 416 rows (stripes of 384), substitutions, and in odd lanes an
    # insertion of 6 bases across row 384 (an I run over the boundary)
    seg = w[8:8 + 416]
    seg[rng.random(len(seg)) < 0.02] ^= 1
    if b % 2:
        seg = np.concatenate([seg[:380], rng.integers(0, 4, 6), seg[380:]])
    return seg


def _long_gaps(rng, b, w):
    # 40 bases deleted from the read (a D run over 5 pointer words) or 40
    # random bases inserted into it (an I run over more than a batch of
    # 32 cells), between flanks of 90
    seg = w[10:10 + 220]
    if b % 2:
        return np.concatenate([seg[:90], seg[130:220]])
    return np.concatenate([seg[:90], rng.integers(0, 4, 40), seg[90:180]])


def _hap(rng, b, w):
    # HaplotypeCaller's haplotype against its region: a SNP and an indel
    ref = w[:360].copy()
    ref[int(rng.integers(20, 340))] ^= 1
    q, L = int(rng.integers(20, 340)), int(rng.integers(1, 8))
    if b % 2:
        return np.concatenate([ref[:q], ref[q + L:]])
    return np.concatenate([ref[:q], rng.integers(0, 4, L), ref[q:]])


def _unmapped(rng, B):
    """Half the lanes cannot score (A against C only, or an empty read or
    window): best 0; the rest are copies."""
    read, rl, win, wl = _copies(rng, B, 160, 256,
                                lambda rng, b, w: w[20:170])
    read[::2, :] = 0
    win[::2, :] = 1
    rl[1::8] = 0
    wl[3::8] = 0
    return read, rl, win, wl


# (case, R, W, B, SW parameters, max_steps or None for R + W, lanes)
WALKS = {
    "stripe_crossing": (416, 448, 8, (1, 4, 6, 1), None,
                        lambda rng: _copies(rng, 8, 416, 448,
                                            _stripe_crossing)),
    "unmapped": (160, 256, 16, (1, 4, 6, 1), None,
                 lambda rng: _unmapped(rng, 16)),
    "cut_at_max_steps": (160, 256, 8, (1, 4, 6, 1), 37,
                         lambda rng: _copies(rng, 8, 160, 256,
                                             lambda rng, b, w: w[9:159])),
    "long_gaps": (220, 256, 8, (1, 4, 6, 1), None,
                  lambda rng: _copies(rng, 8, 220, 256, _long_gaps)),
    "cut_in_gap_runs": (220, 256, 8, (1, 4, 6, 1), 101,
                        lambda rng: _copies(rng, 8, 220, 256, _long_gaps)),
    "ragged_batch": (160, 256, 13, (1, 4, 6, 1), None, None),
    "htc_penalties": (384, 384, 8, (2, 6, 12, 1), None,
                      lambda rng: _copies(rng, 8, 384, 384, _hap)),
}


def _runs(packed, max_steps, b, code):
    """Longest run of op ``code`` (SAM op + 1) in lane b's packed stream."""
    ops = np.stack([(packed[:, b] >> s) & 3 for s in (0, 2, 4, 6)],
                   1).reshape(-1)[:max_steps]
    best = run = 0
    for o in ops:
        run = run + 1 if o == code else 0
        best = max(best, run)
    return best


@pytest.mark.parametrize("case", list(WALKS))
def test_emulated_walk_matches_plain(emu_lib, case):
    """K3 from the host build against ``_traceback_core`` bit for bit, on
    walks that cross a stripe boundary, lanes that score 0, walks cut at
    ``max_steps`` (not a multiple of 4; also inside a D or I run), D and
    I runs longer than a trip's cells, a batch that does not fill its
    last block, and HaplotypeCaller's penalties; each case also checks
    that its inputs do what it says."""
    R, W, B, pset, steps, make = WALKS[case]
    rng = np.random.default_rng(sorted(WALKS).index(case) + 11)
    if make is None:
        read, rl, win, wl = sw_lanes(int(rng.integers(1 << 30)), R, W, B)
        read, win, rl, wl = read.T, win.T, rl[0], wl[0]
    else:
        read, rl, win, wl = make(rng)
    lanes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.astype(np.int8), rl.astype(np.int32), win.astype(np.int8),
        wl.astype(np.int32))]
    p = S.SWParams(*pset)
    steps = steps or R + W

    ptr, best, pos = S._sw_full_launch(emu_lib, *lanes, p, None)
    got = S._sw_traceback_launch(emu_lib, ptr, best, pos, steps, None)
    pptr, pbest, ppos = S._plain_scan(*lanes, p)
    assert torch.equal(best, pbest[0]) and torch.equal(pos, ppos[0])
    want = S._traceback_core(pptr, pbest[0], ppos[0], max_steps=steps)
    for g, x in zip(got, want):
        assert torch.equal(g, x)

    packed, coords = want[0].numpy(), want[1].numpy()
    mapped = want[2].numpy() > 0
    if case == "stripe_crossing":
        assert ((coords[0] < 384) & (coords[2] > 384) & mapped).all()
        assert max(_runs(packed, steps, b, 2) for b in range(1, B, 2)) >= 6
    elif case == "unmapped":
        assert (~mapped).sum() >= B // 2 and mapped.sum() >= 4
    elif case == "cut_at_max_steps":   # every walk takes step 36
        assert ((packed[-1] & 3) != 0).all()
    elif case == "long_gaps":
        assert max(_runs(packed, steps, b, 3) for b in range(1, B, 2)) >= 40
        assert max(_runs(packed, steps, b, 2) for b in range(0, B, 2)) >= 40
    elif case == "cut_in_gap_runs":   # step 100 lies in the gap run
        assert (((packed[25] >> 0) & 3) == np.where(np.arange(B) % 2, 3, 2)
                ).all()
    elif case == "ragged_batch":
        assert B % 8 and mapped.sum() >= B // 2
    elif case == "htc_penalties":
        assert mapped.all() and (coords[2] - coords[0] > 300).all()


# ---------------------------------------------------------------------------
# what chip_smoke.py reports of the walk
# ---------------------------------------------------------------------------

def _kernel_loop(ptrs, best, pos, max_steps, cells):
    """K3's loop (``sw_traceback_kernel``) written out per lane over the
    plain pointers: (round trips, ops) per lane; a trip tests up to
    ``cells`` cells in the phase's direction, the ones before the first
    failing cell take the phase's op, that cell one step of the walk."""
    P = ptrs.numpy().astype(np.int64)
    trips, streams = [], []
    for b in range(P.shape[2]):
        bi = int(pos[b]) % 4096 + 1
        i, j = bi, int(pos[b]) // 4096 - bi + 1
        phase, t, n_tr, ops = 0, 0, 0, []
        active = int(best[b]) > 0
        while active:
            n_tr += 1
            ai, aj = int(phase != 1), int(phase != 2)
            n, brk = cells, False
            for k in range(cells):
                ik, jk = i - ai * k, j - aj * k
                ok = ik > 0 and jk > 0 and t + k < max_steps
                byte = int(P[ik + jk - 1, ik - 1, b]) & 15 if ok else 0
                ok = ok and ((byte & 3) == 1 if phase == 0 else
                             (byte >> (1 + phase)) & 1 == 1)
                if not ok:
                    n, brk = k, True
                    break
            ops += [(1, 3, 2)[phase]] * n
            i, j, t, active = i - ai * n, j - aj * n, t + n, not brk
            if brk and i > 0 and j > 0 and t < max_steps:
                byte = int(P[i + j - 1, i - 1, b]) & 15
                hdir, is_h = byte & 3, phase == 0
                in_e = phase == 1 or (is_h and hdir == 2)
                in_f = not in_e and (phase == 2 or (is_h and hdir == 3))
                active = not (is_h and hdir == 0)
                if active:
                    ops.append(1 if is_h and hdir == 1 else 3 if in_e else 2)
                    t += 1
                    i -= int(in_f or (is_h and hdir == 1))
                    j -= int(in_e or (is_h and hdir == 1))
                phase = (1 if in_e and byte >> 2 & 1 else
                         2 if in_f and byte >> 3 & 1 else 0)
        trips.append(n_tr)
        streams.append(ops)
    return np.array(trips), streams


@pytest.mark.parametrize("cells,steps", [(32, None), (64, None), (96, None),
                                         (32, 37)])
def test_smoke_walk_trips_replay_the_kernels_loop(cells, steps):
    """``chip_smoke.walk_trips`` (the round trips behind K3's latency
    floor) equals K3's loop written out per lane, and that loop's ops
    equal ``_traceback_core``'s."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CSRC.parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    read, rl, win, wl = sw_lanes(5, 220, 256, 24)
    lanes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.T.astype(np.int8), rl[0], win.T.astype(np.int8), wl[0])]
    ptrs, best, pos = S._plain_scan(*lanes, S.SWParams())
    steps = steps or 220 + 256
    want_trips, streams = _kernel_loop(ptrs, best[0], pos[0], steps, cells)
    got = smoke.walk_trips(torch, ptrs, best[0], pos[0], steps, cells)
    assert np.array_equal(got.numpy(), want_trips)
    assert want_trips.max() > 2
    packed = S._traceback_core(ptrs, best[0], pos[0], max_steps=steps)[0]
    ops = np.stack([(packed.numpy() >> s) & 3 for s in (0, 2, 4, 6)],
                   1).reshape(-1, packed.shape[1])
    for b, stream in enumerate(streams):
        assert list(ops[:len(stream), b]) == stream
        assert not ops[len(stream):, b].any()


def test_sass_loop_size_counts_the_walk_loop(tmp_path):
    """``benchmarks/sass.sass_loop_size`` on a listing: the loop with the
    ballot, not the write-out loop behind it."""
    from falcon_genome_tpu_torch.benchmarks import sass
    so = tmp_path / "lib.so"
    lines = ["ISETP.GE.AND P0, PT, R2, R3, PT", "LDS R4, [R5]",
             "VOTE.ANY R6, PT, P1", "FLO.U32 R7, R6", "SHFL.IDX R8, R4, R7",
             "BRA 0x10", "STG.E.U8 [R10], R11", "BRA 0x70", "EXIT"]
    listing = "".join(f"        /*{16 * k:04x}*/                   {t} ;\n"
                      for k, t in enumerate(lines))
    sass._sass_text[so] = ("\n        Function : _Z19sw_traceback_kernel\n"
                           + listing)
    assert sass.sass_loop_size(so, "sw_traceback_kernel") == 5
