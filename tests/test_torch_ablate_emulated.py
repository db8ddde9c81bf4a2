"""The benchmark kernels' CUDA source on the CPU: ``csrc/bench_kernels.cu``
built with g++ against the stand-in ``csrc/emu/cuda_runtime.h`` (as
``test_torch_sw_emulated.py`` builds ``csrc/smith_waterman.cu``).

K7 (``fgt_sw_score_ablate``) from that library, called through the port's
launch helper on CPU tensors, is held bit for bit to its plain version
(``_sw_ablate_plain``) in all eight flag sets: at read lengths that reach
1, 2, 5 and 12 rows a thread and the stripe loop (416 rows), with ragged
lengths, empty lanes and score ties, under both parameter sets; its base
variant is held to K1 from the emulated ``smith_waterman.cu``.  Three
cases aim at what the kernel's full band makes hard: reads that begin
with A bases (code 0, which every column left of the window holds, so
cells before diagonal 1 must be held at the initial state), N bases
against N padding without the mask (the best cell lies outside the
matrix), and the last diagonal's maximum (``no_best``) with and without
the mask, with windows longer than W.  Each case checks that its inputs
do what it says.  K6 (``fgt_fma_ceiling``) from the same library is held
bit for bit to ``_fma_ceiling_plain`` at two small (R, B, trips).  Skips
only where g++ is missing.
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
from falcon_genome_tpu_torch.ops import bench_kernels as BK
from falcon_genome_tpu_torch.ops import smith_waterman as S

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_kernels import SW_PARAM_SETS, sw_lanes  # noqa: E402

torch.set_num_threads(1)

CSRC = Path(S.__file__).resolve().parent.parent / "csrc"
# (R, W): rows per thread NR = ceil(R / 32) of 1, 2, 5 and 12 (none a
# multiple of 32 NR but 384) and 416 rows, two stripes of 384
SHAPES = [(27, 35), (64, 72), (155, 163), (384, 392), (416, 424)]
FLAGS = range(8)   # 1 no_best, 2 no_mask, 4 no_window


def _build_emu(tmp_path_factory, source: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source on the host")
    so = tmp_path_factory.mktemp("emu") / f"lib{Path(source).stem}.so"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
         "-I", str(CSRC / "emu"), "-x", "c++", str(CSRC / source),
         "-o", str(so)], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return _build.bind(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return _build_emu(tmp_path_factory, "bench_kernels.cu")


@pytest.fixture(scope="module")
def emu_sw_lib(tmp_path_factory):
    return _build_emu(tmp_path_factory, "smith_waterman.cu")


def _kw(flags):
    return dict(no_best=bool(flags & 1), no_mask=bool(flags & 2),
                no_window=bool(flags & 4))


def _tensors(read, rl, win, wl):
    """Lane-major int8 / int32 CPU tensors."""
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        read.astype(np.int8), rl.astype(np.int32), win.astype(np.int8),
        wl.astype(np.int32))]


def _hold(lib, lanes, p, flags):
    """K7 from ``lib`` against the plain version; returns the plain
    (score, pos)."""
    want = BK.sw_score_ablate(*lanes, p, **_kw(flags))
    got = BK._sw_ablate_launch(lib, *lanes, p, flags, None)
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    return want


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("pset", sorted(SW_PARAM_SETS))
@pytest.mark.parametrize("R,W", SHAPES)
def test_emulated_ablation_matches_plain(emu_lib, R, W, pset, flags):
    read, rl, win, wl = sw_lanes(R + W, R, W, 8)
    lanes = _tensors(read.T, rl[0], win.T, wl[0])
    _hold(emu_lib, lanes, S.SWParams(*SW_PARAM_SETS[pset]), flags)


@pytest.mark.parametrize("pset", sorted(SW_PARAM_SETS))
@pytest.mark.parametrize("R,W", SHAPES)
def test_emulated_ablation_base_equals_k1(emu_lib, emu_sw_lib, R, W, pset):
    read, rl, win, wl = sw_lanes(R + W + 1, R, W, 8)
    lanes = _tensors(read.T, rl[0], win.T, wl[0])
    p = S.SWParams(*SW_PARAM_SETS[pset])
    got = BK._sw_ablate_launch(emu_lib, *lanes, p, 0, None)
    want = S._sw_score_launch(emu_sw_lib, *lanes, p, None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[0] > 0).sum() >= 4


def _a_start_lanes(rng, B, R, W):
    """Reads whose first 12 bases are A, copied into windows of random
    bases, and in every fourth lane reads of A alone against a window of
    C, G and T; A is code 0, the code of every column left of the
    window."""
    read = rng.integers(0, 4, (B, R)).astype(np.int8)
    win = rng.integers(0, 4, (B, W)).astype(np.int8)
    read[:, :12] = 0
    read[::4] = 0
    win[::4] = rng.integers(1, 4, win[::4].shape)
    for b in range(1, B):
        if b % 4 == 0:
            continue
        s = int(rng.integers(0, W - R // 2))
        n = min(R, W - s)
        win[b, s:s + n] = read[b, :n]
    rl = rng.integers(R // 2, R + 1, B)
    wl = rng.integers(W // 2, W + 1, B)
    return read, rl, win, wl


@pytest.mark.parametrize("flags", [2, 3, 6, 7])
@pytest.mark.parametrize("R,W", [(64, 40), (155, 90)])
def test_emulated_ablation_reads_beginning_with_a(emu_lib, R, W, flags):
    """Without the mask, A bases score against the code 0 left of column
    1: cells on diagonals 1 .. R hold positive H there, and cells before
    diagonal 1 (which the kernel's rows-per-thread layout passes through)
    must stay at the initial state."""
    rng = np.random.default_rng(R + flags)
    lanes = _tensors(*_a_start_lanes(rng, 13, R, W))
    p = S.SWParams()
    score, pos = _hold(emu_lib, lanes, p, flags)
    if not flags & 1:
        assert (score > 0).all()
    if flags == 2:
        # the A reads' best cells lie left of column 1: a run of A
        # matches from diagonal 1 down to column 0, R / 2 rows long
        d, r = pos // S.POS_STRIDE, pos % S.POS_STRIDE
        assert (d[::4] - r[::4] <= 0).all()
        assert (score[::4] >= R // 2).all()


def _n_padding_lanes(rng, B, R, W):
    """Short reads and windows padded with N (code 4) to R and W: without
    the mask the padding matches itself and the best cell lies there."""
    read = np.full((B, R), 4, np.int8)
    win = np.full((B, W), 4, np.int8)
    rl = rng.integers(10, 30, B)
    wl = rng.integers(20, 40, B)
    for b in range(B):
        read[b, :rl[b]] = rng.integers(0, 4, rl[b])
        win[b, :wl[b]] = rng.integers(0, 4, wl[b])
    return read, rl, win, wl


@pytest.mark.parametrize("flags", [2, 3, 6, 7])
def test_emulated_ablation_n_against_n_padding(emu_lib, flags):
    R, W = 160, 120
    rng = np.random.default_rng(flags)
    read, rl, win, wl = _n_padding_lanes(rng, 8, R, W)
    score, pos = _hold(emu_lib, _tensors(read, rl, win, wl), S.SWParams(),
                       flags)
    if flags == 2:   # the best cell lies in the padding, rows >= rlen
        assert (pos % S.POS_STRIDE >= torch.from_numpy(rl)).all()
        assert (score >= 80).all()


@pytest.mark.parametrize("flags", [1, 3, 5, 7])
@pytest.mark.parametrize("R,W", [(64, 72), (155, 163), (416, 424)])
def test_emulated_ablation_last_diagonal(emu_lib, R, W, flags):
    """``no_best``: the maximum over rows of H on diagonal R + W.  With
    the mask it is 0 on every lane whose window fits in W and is
    computed on lanes whose ``wlen`` exceeds W (the last column
    repeated); without it most lanes hold a score there."""
    read, rl, win, wl = sw_lanes(R + W + 2, R, W, 12)
    read, rl, win, wl = read.T, rl[0], win.T, wl[0].copy()
    win[4:, -1] = read[4:, 0]   # the repeated column matches the read
    wl[4:8] = W + R              # windows that run past W
    rl[4:8] = R
    score, pos = _hold(emu_lib, _tensors(read, rl, win, wl), S.SWParams(),
                       flags)
    assert not pos.any()
    if flags & 2:
        assert (score > 0).sum() > len(score) // 2
    else:
        assert not score[wl <= W].any() and (score[4:8] > 0).all()


@pytest.mark.parametrize("flags", [0, 2])
def test_emulated_ablation_widest_bucket(emu_lib, flags):
    """R + W at the kernel's limit (4084): a cell's key holds D - jj in
    its low 12 bits, and cells before diagonal 1 would carry more than
    that; they must not count (an empty lane scores 0 at pos 0)."""
    R, W = 64, 4020
    read, rl, win, wl = sw_lanes(5, R, W, 8)
    score, pos = _hold(emu_lib, _tensors(read.T, rl[0], win.T, wl[0]),
                       S.SWParams(), flags)
    if flags == 0:
        assert score[-1] == 0 and pos[-1] == 0 and (score[1:6] > 0).all()
    wider = np.zeros((8, W + 1), np.int8)   # one column past the limit
    with pytest.raises(ValueError):
        BK._sw_ablate_launch(emu_lib, *_tensors(read.T, rl[0], wider,
                                                wl[0]), S.SWParams(), flags,
                             None)


@pytest.mark.parametrize("R,B,trips", [(37, 5, 12), (160, 3, 16)])
def test_emulated_fma_ceiling_matches_plain(emu_lib, R, B, trips):
    """K6 (``fgt_fma_ceiling``) from the same library: bit-equal to its
    plain version, which rounds each chain update once (the kernel's
    FFMA) and sums the chains, then the block's rows, in order."""
    x = torch.from_numpy(np.random.default_rng(R).uniform(
        0.5, 2.0, (R, B)).astype(np.float32))
    got = BK._fma_ceiling_launch(emu_lib, x, trips, None)
    want = BK._fma_ceiling_plain(x, trips)
    assert torch.equal(got, want), (got, want)
    assert not torch.equal(want, BK._fma_ceiling_plain(x, trips - 4))


@pytest.mark.parametrize("R,W", [(160, 416), (27, 35), (416, 424),
                                 (384, 20)])
def test_ablation_sweep_steps_cover_the_stripe(R, W):
    """``ablate_sw.sweep_steps``: the kernel's loops split a stripe's
    R + W + 32 (NR - 1) steps, the unguarded loop in whole trips of 8
    from step 32 (NR - 1), which is below R, to at most R + W."""
    from falcon_genome_tpu_torch.benchmarks import ablate_sw
    n = ablate_sw.sweep_steps(R, W)
    lag = 32 * (min((R + 31) // 32, 12) - 1)
    assert sum(n.values()) == R + W + lag
    assert n["pre"] == lag < R
    assert n["clean"] % 8 == 0 and 0 <= R + W - lag - n["clean"] < 8


def test_sass_step_loops_reads_the_guarded_loops(tmp_path):
    """``benchmarks/sass.sass_step_loops`` on a listing: the unrolled
    loop of two steps first, then the single-step loops in address
    order; the stripe loop around them is no innermost loop."""
    from falcon_genome_tpu_torch.benchmarks import sass
    so = tmp_path / "lib.so"
    lines = ["MOV R0, RZ",                                        # 0x00
             "SHFL.UP R1, R2, 0x1, RZ", "SHFL.UP R3, R4, 0x1, RZ",
             "SEL R5, R1, RZ, P0", "BRA 0x10",                   # pre
             "SHFL.UP R1, R2, 0x1, RZ", "SHFL.UP R3, R4, 0x1, RZ",
             "IMAD R6, R1, 0x1000, R5", "SHFL.UP R1, R2, 0x1, RZ",
             "SHFL.UP R3, R4, 0x1, RZ", "IMAD R6, R1, 0x1000, R5",
             "BRA 0x50",                                          # clean
             "SHFL.UP R1, R2, 0x1, RZ", "SHFL.UP R3, R4, 0x1, RZ",
             "BRA 0xc0",                                          # post
             "BRA 0x10",                                          # stripe
             "EXIT"]
    listing = "".join(f"        /*{16 * k:04x}*/                   {t} ;\n"
                      for k, t in enumerate(lines))
    sass._sass_text[so] = ("\n        Function : _Z16sw_ablate_kernel\n"
                           + listing)
    loops = sass.sass_step_loops(so, "sw_ablate_kernel", count=sass.IMAD)
    assert loops == [(2, 3.5, 1.0), (1, 4.0, 0.0), (1, 3.0, 0.0)]
