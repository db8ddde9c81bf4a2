"""AlignerEngine port vs the JAX reference on the reference's aligner test
fixtures: identical SAM columns (alignments_to_columns) for paired and
single-end batches, including the proper-pair bonus on a repeat and mate
rescue of a seedless mate."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from falcon_genome_tpu import aligner as JA
from falcon_genome_tpu.io.dna import revcomp_codes
from falcon_genome_tpu.ops.smith_waterman import SWBucket as JSWBucket
from falcon_genome_tpu_torch import aligner as TA
from falcon_genome_tpu_torch import convert

torch.set_num_threads(1)

JBUCKET = JSWBucket(max_read_len=128, max_win_len=256, backend="jax")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(7)
    chr1 = rng.integers(0, 4, 5000).astype(np.uint8)
    chr2 = rng.integers(0, 4, 3000).astype(np.uint8)
    return [("chr1", chr1), ("chr2", chr2)]


def _engines(contigs):
    jp = JA.AlignerParams(index=JA.IndexParams(k=15, w=5))
    tp = convert.aligner_params(jp)
    j_eng = JA.AlignerEngine(JA.MinimizerIndex(contigs, jp.index), jp,
                             bucket=JBUCKET)
    t_eng = TA.AlignerEngine(TA.MinimizerIndex(contigs, tp.index), tp,
                             bucket=convert.sw_bucket(JBUCKET, CPU))
    return j_eng, t_eng


def _batch(codes, names):
    n, L = codes.shape
    return types.SimpleNamespace(
        codes=codes, lengths=np.full(n, L, np.int32), names=names,
        quals=np.full((n, L), 30, np.uint8))


def _assert_columns_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _pairs_vs_reference(contigs, r1, r2):
    j_eng, t_eng = _engines(contigs)
    names = [f"f{i}" for i in range(len(r1))]
    b1, b2 = _batch(r1, names), _batch(r2, names)
    lens = b1.lengths
    ja1, ja2 = j_eng.align_pair_collect(
        j_eng.align_pair_dispatch(r1, lens, r2, lens))
    ta1, ta2 = t_eng.align_pair_collect(
        t_eng.align_pair_dispatch(r1, lens, r2, lens))
    _assert_columns_equal(
        JA.alignments_to_columns(b1, ja1, b2, ja2, params=j_eng.params,
                                 read_group="rg0"),
        TA.alignments_to_columns(b1, ta1, b2, ta2, params=t_eng.params,
                                 read_group="rg0"))
    return ta1, ta2


def test_pair_batch_matches_reference(genome):
    rng = np.random.default_rng(3)
    n, rl = 24, 100
    r1 = np.zeros((n, rl), np.uint8)
    r2 = np.zeros((n, rl), np.uint8)
    for i in range(n):
        name, seq = genome[i % 2]
        pos = int(rng.integers(0, len(seq) - 400))
        a = seq[pos:pos + rl].copy()
        b = seq[pos + 300 - rl:pos + 300].copy()
        for s in (a, b):
            m = rng.random(rl) < 0.02
            s[m] = (s[m] + 1) % 4
        if i % 5 == 0:                               # deletion in mate 1
            a = np.concatenate([seq[pos:pos + 50], seq[pos + 54:pos + 104]])
        r1[i], r2[i] = (a, revcomp_codes(b)) if i % 3 else \
            (revcomp_codes(b), a)
    r2[n - 1] = rng.integers(0, 4, rl)               # garbage mate
    ta1, ta2 = _pairs_vs_reference(genome, r1, r2)
    assert ta1.mapped.sum() >= n - 1


def test_pair_bonus_on_repeat_matches_reference():
    rng2 = np.random.default_rng(11)
    unit = rng2.integers(0, 4, 300).astype(np.uint8)
    spacer = rng2.integers(0, 4, 2000).astype(np.uint8)
    chrom = np.concatenate([unit, spacer, unit,
                            rng2.integers(0, 4, 1000).astype(np.uint8)])
    copy2 = 300 + 2000
    r1 = chrom[copy2:copy2 + 100][None, :]
    r2 = revcomp_codes(chrom[copy2 + 250:copy2 + 350].copy())[None, :]
    ta1, ta2 = _pairs_vs_reference([("c", chrom)], r1, r2)
    assert ta1.pos[0] == copy2 and ta2.pos[0] == copy2 + 250


def test_mate_rescue_matches_reference(genome):
    seq = genome[0][1]
    rl, frag, pos = 100, 350, 1200
    r1 = seq[pos:pos + rl].copy()
    mut = seq[pos + frag - rl:pos + frag].copy()
    rng3 = np.random.default_rng(5)
    for p in range(0, rl, 10):                      # no clean 15-mer seed
        mut[p] = (mut[p] + 1 + rng3.integers(0, 3)) % 4
    ta1, ta2 = _pairs_vs_reference(genome, r1[None, :],
                                   revcomp_codes(mut)[None, :])
    assert ta1.mapped[0] and ta2.mapped[0] and ta2.is_rev[0]


def test_single_end_batch_matches_reference(genome):
    rng = np.random.default_rng(9)
    n, rl = 16, 100
    codes = np.zeros((n, rl), np.uint8)
    for i in range(n):
        seq = genome[i % 2][1]
        p = int(rng.integers(0, len(seq) - rl))
        r = seq[p:p + rl].copy()
        codes[i] = revcomp_codes(r) if i % 2 else r
    j_eng, t_eng = _engines(genome)
    lens = np.full(n, rl, np.int32)
    want = j_eng.align_batch(codes, lens)
    got = t_eng.align_batch(codes, lens)
    assert [vars(g) for g in got] == [vars(w) for w in want]
    assert all(g.mapped for g in got)
