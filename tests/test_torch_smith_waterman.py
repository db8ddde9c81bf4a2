"""Smith-Waterman port vs the JAX reference: bit-equal scores, bestpos,
pointers, op streams and coordinates.

The reference runs its portable ``backend="jax"`` path (the scan the
Pallas kernels are tested against); the port runs its plain PyTorch
versions, which are what its CPU path executes.  Inputs are made with
numpy from a seed and handed to both.  The CUDA kernels are held to the
plain versions in ``test_torch_kernels.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from falcon_genome_tpu.ops import smith_waterman as J
from falcon_genome_tpu.ops.sw_ref import SWParams as JSWParams
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.ops import smith_waterman as T

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_kernels import SW_PARAM_SETS, sw_lanes  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("pset", sorted(SW_PARAM_SETS))
def test_scan_core_and_traceback_bit_equal(pset):
    R, W, B = 32, 64, 48
    read, rl, win, wl = sw_lanes(1, R, W, B)
    jp = JSWParams(*SW_PARAM_SETS[pset])
    tp = convert.sw_params(jp)
    j_ptrs, j_best, j_pos = J._sw_scan_core(
        jnp.asarray(read), jnp.asarray(rl), jnp.asarray(win),
        jnp.asarray(wl), params=jp, R=R, W=W)
    t_ptrs, t_best, t_pos = T._sw_scan_core(
        torch.from_numpy(read), torch.from_numpy(rl), torch.from_numpy(win),
        torch.from_numpy(wl), params=tp, R=R, W=W)
    np.testing.assert_array_equal(np.asarray(j_ptrs), t_ptrs.numpy())
    np.testing.assert_array_equal(np.asarray(j_best), t_best.numpy())
    np.testing.assert_array_equal(np.asarray(j_pos), t_pos.numpy())
    assert (t_best.numpy() > 0).sum() > B // 2

    steps = R + W
    fused = np.asarray(J._traceback_core(j_ptrs, j_best[0], j_pos[0],
                                         max_steps=steps))
    j_packed, j_coords, j_sc = J._decode_traceback(fused, steps, B)
    t_packed, t_coords, t_sc = T._traceback_core(
        t_ptrs, t_best[0], t_pos[0], max_steps=steps)
    np.testing.assert_array_equal(j_packed, t_packed.numpy())
    np.testing.assert_array_equal(j_coords, t_coords.numpy())
    np.testing.assert_array_equal(j_sc, t_sc.numpy())


@pytest.mark.parametrize("pset", sorted(SW_PARAM_SETS))
def test_extend_batch_bit_equal(pset):
    read, rl, win, wl = sw_lanes(2, 40, 96, 40)
    jp = JSWParams(*SW_PARAM_SETS[pset])
    jb = J.SWBucket(max_read_len=48, max_win_len=128, backend="jax")
    reads = read.T.astype(np.uint8)
    wins = np.where(win.T == 5, 4, win.T).astype(np.uint8)
    want = J.sw_extend_batch(reads, rl[0], wins, wl[0], jp, jb)
    got = T.sw_extend_batch(reads, rl[0], wins, wl[0], convert.sw_params(jp),
                            convert.sw_bucket(jb, CPU))
    assert [vars(g) for g in got] == [vars(w) for w in want]


@pytest.fixture(scope="module")
def gather_world():
    """Genome with a repeated block (ties across candidates), reads from
    both strands, windows running past the genome end."""
    rng = np.random.default_rng(3)
    block = rng.integers(0, 4, 150).astype(np.uint8)
    genome = np.concatenate([rng.integers(0, 4, 200), block,
                             rng.integers(0, 4, 150), block,
                             rng.integers(0, 4, 100)]).astype(np.uint8)
    G = len(genome)
    NR, R = 24, 64
    reads = np.full((NR, R), 4, np.uint8)
    lens = rng.integers(40, R + 1, NR).astype(np.int32)
    starts = []
    for i in range(NR):
        s = int(rng.integers(0, G - lens[i]))
        if i % 6 == 0:
            s = 200 + int(rng.integers(0, 150 - lens[i]))   # in the repeat
        seg = genome[s:s + lens[i]].copy()
        seg[rng.random(lens[i]) < 0.03] = 1
        reads[i, :lens[i]] = (seg if i % 2 == 0
                              else (3 - seg[::-1]).astype(np.uint8))
        starts.append(s)
    # jobs: 2-3 candidate windows per read, last reads near the genome end
    j_read, j_rev, j_start, j_wlen = [], [], [], []
    for i in range(NR):
        for k in range(2 + i % 2):
            j_read.append(i)
            j_rev.append(bool(i % 2) if k == 0 else bool(k % 2))
            st = max(0, starts[i] - 16 + 37 * k)
            if i >= NR - 3:
                st = G - 40 - 9 * k                  # runs past the end
            j_start.append(st)
            j_wlen.append(lens[i] + 32)
    j_read = np.asarray(j_read, np.int32)
    return dict(
        genome=genome, reads=reads, lens=lens, j_read=j_read,
        j_rev=np.asarray(j_rev), j_rlen=lens[j_read].astype(np.int32),
        j_start=np.asarray(j_start, np.int32),
        j_wlen=np.asarray(j_wlen, np.int32))


@pytest.mark.parametrize("pset", sorted(SW_PARAM_SETS))
def test_score_and_extend_gather_bit_equal(gather_world, pset):
    w = gather_world
    jp = JSWParams(*SW_PARAM_SETS[pset])
    jb = J.SWBucket(max_read_len=64, max_win_len=128, backend="jax")
    tp, tb = convert.sw_params(jp), convert.sw_bucket(jb, CPU)
    jr, jg = J.device_reads(w["reads"]), J.device_genome(w["genome"])
    tr = convert.read_table(w["reads"], CPU)
    tg = convert.genome_tensor(w["genome"], CPU)
    args = (w["j_read"], w["j_rev"], w["j_rlen"])
    rest = (w["j_start"], w["j_wlen"])
    js, jpos = J.sw_score_gather(jr, *args, jg, *rest, jp, jb)
    ts, tpos = T.sw_score_gather(tr, *args, tg, *rest, tp, tb)
    np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(jpos, tpos)
    want = J.sw_extend_gather(jr, *args, jg, *rest, jp, jb)
    got = T.sw_extend_gather(tr, *args, tg, *rest, tp, tb)
    assert [vars(g) for g in got] == [vars(x) for x in want]


def test_pair_dispatch_collect_bit_equal(gather_world):
    w = gather_world
    jp = JSWParams()
    jb = J.SWBucket(max_read_len=64, max_win_len=128, backend="jax")
    pair = J.PairPolicy(max_insert=400)
    # mates: read i pairs with read i + 12
    slice_of = np.zeros(len(w["lens"]) + 1, np.int64)
    np.cumsum(np.bincount(w["j_read"], minlength=len(w["lens"])),
              out=slice_of[1:])
    args = (w["j_read"], w["j_rev"], w["j_rlen"])
    rest = (w["j_start"], w["j_wlen"], slice_of, w["lens"])
    want = J.sw_pair_collect(J.sw_pair_dispatch(
        J.device_reads(w["reads"]), *args, J.device_genome(w["genome"]),
        *rest, jp, jb, pair))
    got = T.sw_pair_collect(T.sw_pair_dispatch(
        convert.read_table(w["reads"], CPU), *args,
        convert.genome_tensor(w["genome"], CPU), *rest,
        convert.sw_params(jp), convert.sw_bucket(jb, CPU),
        convert.pair_policy(pair)))
    assert len(got) == len(want) == 8
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))
    assert (got[5] >= 0).sum() > len(w["lens"]) // 2
