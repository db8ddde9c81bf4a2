"""The port's record-level API against the JAX package's: sort, merge and
duplicate marking on ``SamRecord`` lists (``bamops.py``), BQSR on records
(``bqsr.py``), and the aligner's record API (``find_candidates``,
``find_candidates_batch``, ``AlignerEngine.align_pair_batch`` with
``AlignmentBatch.to_alignments``, ``make_sam_records``).

Each case feeds both packages the same seeded inputs and holds the port
bit- or record-equal to the reference.  The reference's own cross-checks
of its columnar paths against the record paths
(``tests/test_columnar_ops.py``, ``tests/test_columns.py:157``) run here
entirely inside the port: its record markdup, BQSR and SAM emission
against its columnar ones."""
import copy
import types

import numpy as np
import pytest
import torch

from falcon_genome_tpu import aligner as JA
from falcon_genome_tpu import bamops as JB
from falcon_genome_tpu import bqsr as JQ
from falcon_genome_tpu.io.dna import decode_seq, revcomp_codes
from falcon_genome_tpu.io.sam import SamRecord as JRec
from falcon_genome_tpu.io.sam import cigar_from_str
from falcon_genome_tpu.ops.smith_waterman import SWBucket as JSWBucket
from falcon_genome_tpu_torch import aligner as TA
from falcon_genome_tpu_torch import bamops as TB
from falcon_genome_tpu_torch import bqsr as TQ
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.io.columns import RecordColumns
from falcon_genome_tpu_torch.io.fastq import FastqBatch
from falcon_genome_tpu_torch.io.sam import SamRecord as TRec

torch.set_num_threads(1)

CPU = torch.device("cpu")
JBUCKET = JSWBucket(max_read_len=128, max_win_len=256, backend="jax")
F_PAIR1, F_PAIR2, F_REV, F_UNMAPPED = 0x41, 0x81, 0x10, 0x4


def sim_records(seed, n=100, read_len=40, ref_len=700):
    """Reference records: clips, indels, both strands, 5% errors, random
    quals, two read groups, duplicates of the first reads at lower
    quality, pairs keyed by both ends, a secondary, and unmapped reads.
    Returns (ref codes, records)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    cigars = [f"{read_len}M", f"5S{read_len - 5}M",
              f"{read_len // 2}M3D{read_len - read_len // 2}M",
              f"{read_len // 2}M2I{read_len - read_len // 2 - 2}M",
              f"{read_len - 4}M4S", f"2H3S{read_len - 3}M"]
    recs = []
    for i in range(n):
        pos = int(rng.integers(0, ref_len - read_len - 10))
        seq = ref[pos:pos + read_len].copy()
        err = rng.random(read_len) < 0.05
        seq = np.where(err, (seq + 1) % 4, seq)
        if i % 17 == 0:
            seq[3] = 4                                   # an N base
        qual = (rng.integers(2, 45, read_len) + 33).astype(np.uint8)
        r = JRec(f"q{i:03d}", F_REV if rng.random() < 0.5 else 0, 0, pos,
                 60, cigar_from_str(cigars[i % len(cigars)]),
                 seq=decode_seq(seq), qual=qual.tobytes().decode("latin1"))
        r.set_tag("RG", "Z", f"rg{i % 2}")
        recs.append(r)
    for i in range(8):                                   # duplicates
        src = recs[i]
        d = JRec(f"dup{i}", src.flag, 0, src.pos, 60, list(src.cigar),
                 seq=src.seq, qual=chr(20 + 33) * len(src.seq))
        d.set_tag("RG", "Z", "rg0")
        recs.append(d)
    for name, p1, p2, q in (("p1", 100, 300, "I"), ("p2", 100, 300, "5"),
                            ("p3", 100, 400, "I"), ("p4", 103, 300, "I")):
        cig = "3S7M" if name == "p4" else "10M"
        for flag, p in ((F_PAIR1, p1), (F_PAIR2 | F_REV, p2)):
            r = JRec(name, flag, 0, p, 60, cigar_from_str(cig),
                     seq=decode_seq(ref[p:p + 10]), qual=q * 10)
            r.set_tag("RG", "Z", "rg1")
            recs.append(r)
    sec = JRec("q005", 0x100, 0, 250, 60, cigar_from_str("10M"),
               seq="A" * 10, qual="#" * 10)
    recs.append(sec)
    recs += [JRec(f"u{i}", F_UNMAPPED, seq="ACGT", qual="IIII")
             for i in range(3)]
    order = rng.permutation(len(recs))
    return ref, [recs[i] for i in order]


# ---------------------------------------------------------------------------
# bamops: sort, merge, duplicate marking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_sort_records_matches_reference(seed):
    _, recs = sim_records(seed)
    trecs = convert.sam_records(recs)
    want = JB.sort_key_arrays(recs)
    assert np.array_equal(TB.sort_key_arrays(trecs), want)
    assert TB.sort_records(trecs) == convert.sam_records(
        JB.sort_records(recs))
    assert TB.sort_records(trecs)[-1].is_unmapped


def test_merge_sorted_matches_reference():
    _, recs = sim_records(2)
    shards = [JB.sort_records(recs[i::3]) for i in range(3)]
    got = TB.merge_sorted([convert.sam_records(s) for s in shards])
    assert got == convert.sam_records(JB.merge_sorted(shards))


@pytest.mark.parametrize("cigar,flag", [
    ("10M", 0), ("5S5M", 0), ("2H3S5M", 0), ("3M2D4M3S", 0), ("10M", F_REV),
    ("5M5S", F_REV), ("4M2I2M1S3H", F_REV), ("3S4M3N3M", F_REV)])
def test_unclipped_start_matches_reference(cigar, flag):
    r = JRec("x", flag, 0, 100, 60, cigar_from_str(cigar))
    t, = convert.sam_records([r])
    assert TB.unclipped_start(t) == JB.unclipped_start(r)
    assert TB._qual_sum(t) == JB._qual_sum(r) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mark_duplicates_matches_reference(seed):
    """Flags and count equal the reference's; the port's columnar markdup
    marks the same records."""
    _, recs = sim_records(seed)
    trecs = convert.sam_records(recs)
    cols = RecordColumns.from_records(copy.deepcopy(trecs))
    want, nwant = JB.mark_duplicates(recs)
    got, ngot = TB.mark_duplicates(trecs)
    assert nwant > 0 and ngot == nwant
    assert got == convert.sam_records(want)
    _, ncol = TB.mark_duplicates_columns(cols)
    assert ncol == ngot
    assert [r.flag for r in cols.to_records()] == [r.flag for r in got]


# ---------------------------------------------------------------------------
# bqsr on records
# ---------------------------------------------------------------------------

def _bqsr_inputs(seed):
    ref, recs = sim_records(seed, n=150)
    rng = np.random.default_rng(seed + 10)
    known = {(0, int(p)) for p in rng.integers(0, len(ref), 30)}
    recs[7].flag |= 0x400
    return ref, recs, known, {"rg0": 0, "rg1": 1}


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_covariates_matches_reference(seed):
    """Equal covariate arrays; the port's columnar extraction equals its
    record extraction."""
    ref, recs, known, rgi = _bqsr_inputs(seed)
    trecs = convert.sam_records(recs)
    want = JQ.extract_covariates(recs, {0: ref}, known, rgi)
    got = TQ.extract_covariates(trecs, {0: ref}, known, rgi)
    cols = TQ.extract_covariates_columns(RecordColumns.from_records(trecs),
                                         {0: ref}, known, rgi)
    assert len(got["rg"]) > 1000
    for k in ("rg", "qual", "cycle", "context", "is_error"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(cols[k], got[k], err_msg=k)


@pytest.mark.parametrize("known", [False, True])
def test_baserecal_table_matches_reference(known, tmp_path):
    """The table's arrays are equal and its GATK report is the same text;
    the port's columnar table equals its record table."""
    ref, recs, sites, rgi = _bqsr_inputs(3)
    sites = sites if known else None
    rgs = ["rg0", "rg1"]
    trecs = convert.sam_records(recs)
    want = JQ.baserecal_table(recs, {0: ref}, rgs, sites)
    got = TQ.baserecal_table(trecs, {0: ref}, rgs, sites)
    cols = TQ.accumulate_table(TQ.extract_covariates_columns(
        RecordColumns.from_records(trecs), {0: ref}, sites, rgi), rgs)
    for f in ("qual_obs", "qual_err", "cycle_obs", "cycle_err", "ctx_obs",
              "ctx_err"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(cols, f), getattr(got, f))
    JQ.write_gatk_report(want, str(tmp_path / "ref.grp"))
    TQ.write_gatk_report(got, str(tmp_path / "port.grp"))
    assert (tmp_path / "port.grp").read_text() == \
        (tmp_path / "ref.grp").read_text()


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_bqsr_matches_reference(seed):
    """Recalibrated qualities equal the reference's, and the port's
    columnar ApplyBQSR writes the same qualities."""
    ref, recs, _, rgi = _bqsr_inputs(seed)
    rgs = ["rg0", "rg1"]
    trecs = convert.sam_records(recs)
    jmodel = JQ.RecalModel.fit(JQ.baserecal_table(recs, {0: ref}, rgs))
    tmodel = TQ.RecalModel.fit(TQ.baserecal_table(trecs, {0: ref}, rgs))
    cols = RecordColumns.from_records(copy.deepcopy(trecs))
    want = JQ.apply_bqsr(recs, jmodel, rgi)
    got = TQ.apply_bqsr(trecs, tmodel, rgi)
    assert [r.qual for r in got] == [r.qual for r in want]
    assert any(r.qual != o.qual for r, o in zip(got, sim_records(seed)[1]))
    TQ.apply_bqsr_columns(cols, tmodel, rgi)
    assert [r.qual for r in cols.to_records()] == [r.qual for r in got]


# ---------------------------------------------------------------------------
# aligner record API
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(7)
    return [("chr1", rng.integers(0, 4, 5000).astype(np.uint8)),
            ("chr2", rng.integers(0, 4, 3000).astype(np.uint8))]


@pytest.fixture(scope="module")
def engines(genome):
    jp = JA.AlignerParams(index=JA.IndexParams(k=15, w=5))
    jidx = JA.MinimizerIndex(genome, jp.index)
    tp = convert.aligner_params(jp)
    return (JA.AlignerEngine(jidx, jp, bucket=JBUCKET),
            TA.AlignerEngine(convert.minimizer_index(jidx), tp,
                             bucket=convert.sw_bucket(JBUCKET, CPU)))


def _reads(genome, seed, n, rl=100):
    """Reads of both contigs and strands with 2% errors, one with a 4 bp
    deletion, two chimeric, one of random bases and one of N; (codes,
    lengths)."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((n, rl), np.uint8)
    for i in range(n):
        seq = genome[i % 2][1]
        p = int(rng.integers(0, len(seq) - rl - 1000))
        r = seq[p:p + rl].copy()
        m = rng.random(rl) < 0.02
        r[m] = (r[m] + 1) % 4
        if i == 3:
            r = np.concatenate([seq[p:p + 50], seq[p + 54:p + 104]])
        if i in (5, 6):                       # chimeric: two placements
            r = np.concatenate([seq[p:p + 50], seq[p + 900:p + 950]])
        codes[i] = revcomp_codes(r) if i % 3 == 1 else r
    codes[n - 2] = rng.integers(0, 4, rl)
    codes[n - 1] = 4
    lens = rng.integers(rl - 20, rl + 1, n).astype(np.int32)
    for i in range(n):
        codes[i, lens[i]:] = 4
    return codes, lens


@pytest.mark.parametrize("min_seeds,max_candidates", [(1, 4), (3, 2)])
def test_find_candidates_matches_reference(engines, genome, min_seeds,
                                           max_candidates):
    """Per read and per batch, the candidates equal the reference's, and
    the port's batch form equals its per-read form."""
    j_eng, t_eng = engines
    codes, lens = _reads(genome, 1, 24)
    jp = JA.AlignerParams(index=JA.IndexParams(k=15, w=5),
                          min_seeds=min_seeds, max_candidates=max_candidates)
    tp = convert.aligner_params(jp)
    per_read = []
    for i in range(len(codes)):
        r = codes[i, :lens[i]]
        got = TA.find_candidates(r, t_eng.index, tp)
        assert [vars(c) for c in got] == [
            vars(c) for c in JA.find_candidates(r, j_eng.index, jp)], i
        per_read.append([vars(c) for c in got])
    assert sum(len(c) > 0 for c in per_read) >= len(codes) - 2
    assert max(map(len, per_read)) == 2
    batch = TA.find_candidates_batch(codes, lens, t_eng.index, tp)
    want = JA.find_candidates_batch(codes, lens, j_eng.index, jp)
    assert [[vars(c) for c in cs] for cs in batch] == [
        [vars(c) for c in cs] for cs in want]
    assert [[vars(c) for c in cs] for cs in batch] == per_read


def _pairs(genome, seed, n, rl=100, frag=300):
    """FR pairs on both contigs, both orders, a garbage mate, and a mate
    with no clean 15-mer seed (rescued from its anchor)."""
    rng = np.random.default_rng(seed)
    r1 = np.zeros((n, rl), np.uint8)
    r2 = np.zeros((n, rl), np.uint8)
    for i in range(n):
        seq = genome[i % 2][1]
        pos = int(rng.integers(0, len(seq) - frag - 10))
        a = seq[pos:pos + rl].copy()
        b = seq[pos + frag - rl:pos + frag].copy()
        for s in (a, b):
            m = rng.random(rl) < 0.02
            s[m] = (s[m] + 1) % 4
        r1[i], r2[i] = (a, revcomp_codes(b)) if i % 3 else \
            (revcomp_codes(b), a)
    r2[n - 1] = rng.integers(0, 4, rl)
    mut = r2[n - 2].copy()
    mut[::10] = (mut[::10] + 1) % 4
    r2[n - 2] = mut
    return r1, r2, np.full(n, rl, np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_align_pair_batch_matches_reference(engines, genome, seed):
    """``align_pair_batch`` on the CPU: every field of every Alignment
    equals the reference's on its ``backend="jax"`` path, and equals the
    port's own dispatch/collect halves through ``to_alignments``."""
    j_eng, t_eng = engines
    r1, r2, lens = _pairs(genome, seed, 18)
    ja1, ja2 = j_eng.align_pair_batch(r1, lens, r2, lens)
    ta1, ta2 = t_eng.align_pair_batch(r1, lens, r2, lens)
    assert [vars(a) for a in ta1] == [vars(a) for a in ja1]
    assert [vars(a) for a in ta2] == [vars(a) for a in ja2]
    assert sum(a.mapped for a in ta1 + ta2) >= 2 * len(lens) - 2
    ab1, ab2 = t_eng.align_pair_collect(
        t_eng.align_pair_dispatch(r1, lens, r2, lens))
    assert [vars(a) for a in ab1.to_alignments()] == [vars(a) for a in ta1]
    assert [vars(a) for a in ab2.to_alignments()] == [vars(a) for a in ta2]


def _batch(seed, B, L):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (B, L)).astype(np.uint8)
    quals = rng.integers(2, 41, (B, L)).astype(np.uint8)
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    for i in range(B):
        codes[i, lengths[i]:] = 4
        quals[i, lengths[i]:] = 0
    return FastqBatch([f"q{i:04d}" for i in range(B)], codes, quals, lengths)


def _alignment(L, rng):
    """Random alignment (``tests/test_columns.py::_mk_aln``): unmapped,
    clipped, with an insertion, or whole; both strands and contigs."""
    if rng.random() < 0.2:
        return TA.Alignment(mapped=False, read_len=L)
    sc = int(rng.integers(20, 150))
    roll = rng.random()
    if roll < 0.3:
        cig = [(4, 3), (0, L - 3)]
    elif roll < 0.5:
        cig = [(0, L // 2), (1, 2), (0, L - L // 2 - 2)]
    else:
        cig = [(0, L)]
    return TA.Alignment(mapped=True, tid=int(rng.integers(0, 2)),
                        pos=int(rng.integers(0, 1000)),
                        is_rev=bool(rng.random() < 0.5), score=sc,
                        sub_score=int(rng.integers(0, sc)),
                        mapq=int(rng.integers(0, 61)), cigar=cig,
                        nm=int(rng.integers(0, 10)), read_len=L)


def _mate(a, L, rng):
    """A mate of ``a``: in 3 of 4 cases on its contig, 0-600 bases right,
    on the other strand (proper pairs at ``max_insert=700`` and improper
    ones beyond it), else a random alignment."""
    m = _alignment(L, rng)
    if a.mapped and m.mapped and rng.random() < 0.75:
        m.tid, m.pos = a.tid, a.pos + int(rng.integers(0, 600))
        m.is_rev = not a.is_rev
    return m


@pytest.mark.parametrize("paired", [False, True])
def test_make_sam_records_matches_reference(paired):
    """Record for record equal to the reference's ``make_sam_records``
    (flags, proper-pair TLEN, mate fields, oriented SEQ/QUAL, tags), and
    to the port's columnar ``alignments_to_columns`` of the same batch."""
    B, L = 80, 60
    b1 = _batch(1, B, L)
    b2 = _batch(2, B, L) if paired else None
    rng = np.random.default_rng(31)
    t1 = [_alignment(int(n), rng) for n in b1.lengths]
    t2 = ([_mate(a, int(n), rng) for a, n in zip(t1, b2.lengths)]
          if paired else [None] * B)
    tp = TA.AlignerParams(max_insert=700)
    jp = JA.AlignerParams(max_insert=700)

    def seq_qual(b, i):
        if b is None:
            return None, None
        n = b.lengths[i]
        return (decode_seq(b.codes[i, :n]),
                (b.quals[i, :n] + 33).tobytes().decode())

    got, want = [], []
    for i in range(B):
        s1, q1 = seq_qual(b1, i)
        s2, q2 = seq_qual(b2, i)
        j1 = JA.Alignment(**vars(t1[i]))
        j2 = JA.Alignment(**vars(t2[i])) if paired else None
        got += TA.make_sam_records(b1.names[i], s1, q1, t1[i], s2, q2, t2[i],
                                   params=tp, read_group="rgX")
        want += JA.make_sam_records(b1.names[i], s1, q1, j1, s2, q2, j2,
                                    params=jp, read_group="rgX")
        if paired:
            assert TA._pair_flags(t1[i], t2[i], tp) == \
                JA._pair_flags(j1, j2, jp)
    assert all(isinstance(r, TRec) for r in got)
    assert got == convert.sam_records(want)
    if paired:
        proper = sum(r.flag & 0x2 != 0 for r in got)
        assert 0 < proper < len(got) // 2
    cols = TA.alignments_to_columns(b1, t1, b2, t2 if paired else None,
                                    params=tp, read_group="rgX")
    assert cols.to_records() == got


def test_align_pair_batch_records_equal_columns(engines, genome):
    """The port's record emission of ``align_pair_batch``'s alignments
    equals its columnar emission of the dispatch/collect batches."""
    _, t_eng = engines
    r1, r2, lens = _pairs(genome, 5, 12)
    a1, a2 = t_eng.align_pair_batch(r1, lens, r2, lens)
    names = [f"f{i}" for i in range(len(lens))]
    quals = np.full(r1.shape, 30, np.uint8)
    b1 = types.SimpleNamespace(codes=r1, lengths=lens, names=names,
                               quals=quals)
    b2 = types.SimpleNamespace(codes=r2, lengths=lens, names=names,
                               quals=quals)
    ab1, ab2 = t_eng.align_pair_collect(
        t_eng.align_pair_dispatch(r1, lens, r2, lens))
    recs = []
    for i in range(len(lens)):
        recs += TA.make_sam_records(
            names[i], decode_seq(r1[i]), "?" * 100, a1[i],
            decode_seq(r2[i]), "?" * 100, a2[i], params=t_eng.params,
            read_group="rg0")
    cols = TA.alignments_to_columns(b1, ab1, b2, ab2, params=t_eng.params,
                                    read_group="rg0")
    assert cols.to_records() == recs
    assert sum(r.flag & 0x2 != 0 for r in recs) >= len(recs) - 4
