"""The Smith-Waterman CUDA source on the CPU: ``csrc/smith_waterman.cu``
built with g++ against the stand-in ``csrc/emu/cuda_runtime.h``, which runs
each warp's 32 lanes as coroutines (shuffles as exchanges, the DPX
intrinsics as their plain definitions, the launches as a host loop over
the blocks).

K1, K2 and K3 from that library, called through the port's own launch
helpers on CPU tensors, are held bit for bit to the plain versions
(``_plain_scan``, ``_traceback_core``): scores, bestpos, op streams and
coordinates, at read lengths that reach every rows-per-thread
instantiation of the sweep (1 to 12 rows a thread) and the stripe loop of
longer reads, with empty lanes, ragged lengths and score ties, under both
parameter sets.  What the stand-in cannot show (the card's scheduling,
its compiler) the ``cuda`` tests of ``test_torch_kernels.py`` hold on the
card.  Skips only where g++ is missing.
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
