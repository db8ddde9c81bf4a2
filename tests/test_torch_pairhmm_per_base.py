"""GATK 3's per-base gap opens (BQSR's BI/BD tags) on the port's
likelihood paths: the tags read off a record, clipped with its bases,
through htc's ``_likelihoods_multi`` and ``pairhmm_logp_pairs`` and
through ``mutect2``'s ``read_hap_likelihood_matrix`` and ``pairhmm_logp``,
to K5 (its plain version on the CPU, and the CUDA source built for the
host against ``csrc/emu``).

Held against: the reference's ``_pairhmm_jax`` with the same planes, bit
for bit (``torch_parity.jax_pairhmm``); the port's float64 golden model
``ops/pairhmm_ref.py`` (GATK's recurrence with a transition a read row),
within a tolerance; the scalar call, bit for bit, where every gap open
is 45; and K5's work counted by hand from the kernel's rule.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from falcon_genome_tpu_torch.io import bam as TB
from falcon_genome_tpu_torch.io import sam as TS
from falcon_genome_tpu_torch.models import haplotypecaller as TH
from falcon_genome_tpu_torch.ops import pairhmm as P
from falcon_genome_tpu_torch.ops import pairhmm_ref as REF
from falcon_genome_tpu_torch.utils import spans

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_pairhmm_emulated import emu_lib  # noqa: E402,F401
from test_torch_spans import k4_count  # noqa: E402
from torch_parity import jax_pairhmm  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
GCP = 10
# float32 against float64: each of a pair's rlen + hlen diagonals rounds
# its cells once or twice (relative 2^-24 each, ~6e-8), and the error
# grows with the path, at most a few hundred roundings at these sizes:
# ~2e-5 of relative error, under 1e-5 in log10.  1e-4 leaves ten times
# that; a transition taken from the wrong row moves a pair by more than
# 1e-3.
LOG10_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def region_tables(seed, NR=7, NH=3, R=40, H=96, quality0=False):
    """A region's unique reads (each cut from one of its haplotypes, 3%
    substitutions) with BI/BD tables of GATK 3's range (20-46, phred 0
    past each read), as ``pairhmm_logp_pairs`` takes them, and the cross
    product's pair indices; ``quality0``: every other read's first base
    at phred 0 (its rescale can fire past its end)."""
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 4, (NH, H)).astype(np.uint8)
    hl = rng.integers(H // 2, H + 1, NH).astype(np.int32)
    rl = rng.integers(1, R + 1, NR).astype(np.int32)
    rl[0] = R
    reads = np.full((NR, R), 4, np.uint8)
    for i in range(NR):
        h = i % NH
        rl[i] = min(rl[i], hl[h])
        s = int(rng.integers(0, hl[h] - rl[i] + 1))
        seg = haps[h, s:s + rl[i]].copy()
        err = rng.random(rl[i]) < 0.03
        seg[err] = (seg[err] + 1) % 4
        reads[i, :rl[i]] = seg
    inside = np.arange(R)[None, :] < rl[:, None]
    quals = np.where(inside, rng.integers(10, 41, (NR, R)), 0)
    if quality0:
        quals[::2, 0] = 0
    ins, dels = (np.where(inside, rng.integers(20, 47, (NR, R)), 0)
                 .astype(np.uint8) for _ in range(2))
    pr = np.repeat(np.arange(NR), NH)
    ph = np.tile(np.arange(NH), NR)
    return reads, quals.astype(np.uint8), rl, haps, hl, pr, ph, ins, dels


def _params(R, H):
    return P.PairHMMParams(max_read_len=R, max_hap_len=H, device=CPU)


def _pairs(case, ins=None, dels=None, gcp=GCP, R=40, H=96):
    reads, quals, rl, haps, hl, pr, ph, i0, d0 = case
    return P.pairhmm_logp_pairs(
        reads, quals, rl, haps, hl, pr, ph, i0 if ins is None else ins,
        d0 if dels is None else dels, gcp, params=_params(R, H))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def golden(reads, quals, rl, haps, hl, pr, ph, ins, dels, gcp=GCP):
    """``ops/pairhmm_ref.py``'s float64 likelihood of every pair, from
    the unique reads' tables (``gcp`` a phred or an (NR, R') table)."""
    gcp = np.broadcast_to(gcp, reads.shape)
    return REF.pairhmm_logp_ref(reads[pr], quals[pr], ins[pr], dels[pr],
                                gcp[pr], rl[pr], haps[ph], hl[ph])


@pytest.mark.parametrize("seed,R,H", [(1, 40, 96), (2, 72, 128),
                                      (3, 8, 24)])
def test_pairs_with_tables_match_float64_reference(seed, R, H):
    """Against the float64 golden model within ``LOG10_TOL``, and the
    reference's ``_pairhmm_jax`` with the same planes bit for bit."""
    case = region_tables(seed, R=R, H=H)
    reads, quals, rl, haps, hl, pr, ph, ins, dels = case
    got = _pairs(case, R=R, H=H)
    want = golden(*case)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOG10_TOL)
    jax = jax_pairhmm(reads[pr].T, quals[pr].T, ins[pr].T, dels[pr].T, GCP,
                      rl[pr][None], hl[ph][None], haps[ph].T, R=R, H=H)
    assert np.array_equal(_bits(got), _bits(jax))
    # the tables move the result: the scalar call is another one
    assert not np.allclose(_pairs(case, 45, 45, R=R, H=H), want,
                           rtol=0, atol=1e-3)


@pytest.mark.parametrize("quality0", [False, True])
def test_tables_of_45_equal_the_scalar_call(quality0):
    """Tables full of 45 over the bucket's columns give the scalar call's
    bits, quality-0 first bases (rescaled past their end) too."""
    case = region_tables(4, R=64, H=128, quality0=quality0)
    full = np.full(case[0].shape, 45, np.uint8)
    got = _pairs(case, full, full, R=64, H=128)
    want = _pairs(case, 45, 45, R=64, H=128)
    assert np.array_equal(_bits(got), _bits(want))


def test_pairs_entry_equals_logp_entry_with_planes():
    """``pairhmm_logp_pairs`` with tables and ``pairhmm_logp`` with the
    pairs' planes (gcp broadcast on the host) give the same bits."""
    case = region_tables(5, quality0=True)
    reads, quals, rl, haps, hl, pr, ph, ins, dels = case
    got = _pairs(case)
    want = P.pairhmm_logp(reads[pr], quals[pr], ins[pr], dels[pr], GCP,
                          rl[pr], haps[ph], hl[ph], params=_params(40, 96))
    assert np.array_equal(_bits(got), _bits(want))


def test_one_table_and_one_scalar():
    """A table for the insertions and a scalar for the deletions: the
    scalar's plane is made in the tiles' shape, as the pairs' planes."""
    case = region_tables(6)
    reads, quals, rl, haps, hl, pr, ph, ins, _ = case
    got = _pairs(case, ins, 45)
    dels = np.full((len(pr), 40), 45, np.uint8)
    want = P.pairhmm_logp(reads[pr], quals[pr], ins[pr], dels, GCP,
                          rl[pr], haps[ph],
                          hl[ph], params=_params(40, 96))
    assert np.array_equal(_bits(got), _bits(want))


def test_tables_of_the_wrong_shape_are_refused():
    case = region_tables(7)
    with pytest.raises(ValueError):
        _pairs(case, case[7][:-1])
    with pytest.raises(ValueError):
        _pairs(case, np.zeros((7, 48), np.uint8))
    # narrower than the reads: their last bases would open gaps at phred 0
    with pytest.raises(ValueError):
        _pairs(case, None, case[8][:, :-1])


def test_emulated_k5_through_the_entry(emu_lib, monkeypatch):
    """K5 built for the host, launched from ``pairhmm_logp_pairs``'
    per-base route (the tables gathered, the gcp plane made, the launch
    through ``pairhmm_pb``), equals the CPU twin bit for bit: reads of 1
    to 152 bases against 384-base haplotypes in htc's bucket, quality-0
    first bases among them."""
    case = region_tables(8, NR=24, NH=3, R=152, H=384, quality0=True)
    want = _pairs(case, R=152, H=384)
    launched = []

    def emulated(read, bq, ins, dels, gcp, rlen, hap, hlen):
        launched.append(read.shape)
        return P._pairhmm_pb_launch(emu_lib, read, [bq, ins, dels, gcp],
                                    rlen, hap, hlen, None)

    monkeypatch.setattr(P, "pairhmm_pb", emulated)
    got = _pairs(case, R=152, H=384)
    assert launched == [(72, 152)]
    # each read's own haplotype finite; unrelated long reads floor to -inf
    assert np.isfinite(want).sum() >= 24 and np.isneginf(want).any()
    assert np.array_equal(_bits(got), _bits(want))


# --- records with BI/BD, through htc and mutect2 -----------------------

def _qual_string(rng, n, lo, hi):
    return "".join(chr(33 + int(x)) for x in rng.integers(lo, hi + 1, n))


def tagged_records(seed, ref, n=60, read_len=80, untagged_every=3):
    """Reads of two haplotypes of ``ref`` (a het SNP at 300), some with a
    soft clip; every read but each ``untagged_every``-th carries BI and
    BD (20-46), and one of the tagged carries BI alone."""
    rng = np.random.default_rng(seed)
    alt = ref.copy()
    alt[300] = (alt[300] + 1) % 4
    recs = []
    for i in range(n):
        hap = ref if i % 2 == 0 else alt
        pos = int(rng.integers(150, 450 - read_len))
        seq = TH.decode_seq(hap[pos:pos + read_len])
        cigar = [(TS.CIGAR_S, 3), (TS.CIGAR_M, read_len - 3)] if i % 5 == 1 \
            else [(TS.CIGAR_M, read_len)]
        if i % 5 == 1:
            pos += 3
        rec = TS.SamRecord(f"r{i}", 0, 0, pos, 60, cigar, seq=seq,
                           qual=_qual_string(rng, read_len, 20, 35))
        if i % untagged_every:
            rec.set_tag("BI", "Z", _qual_string(rng, read_len, 20, 46))
            if i != 1:
                rec.set_tag("BD", "Z", _qual_string(rng, read_len, 20, 46))
        recs.append(rec)
    return recs


def _as_quals(rec, tag):
    """A copy of ``rec`` whose qualities are its tag ``tag`` (the tag
    clipped by the reference's own clip of the qualities)."""
    from falcon_genome_tpu.io.sam import SamRecord as JRec
    return JRec(rec.qname, rec.flag, rec.tid, rec.pos, rec.mapq,
                list(rec.cigar), seq=rec.seq, qual=rec.get_tag(tag))


def reference_matrix(reads, haps, rstart, rend, R, H):
    """The reference's log10 matrix for these reads and haplotypes: each
    read clipped by the reference's ``clip_read_to_region`` (its tags
    too), gap opens from BI/BD (45 over a read without the tag, phred 0
    past each read), through ``_pairhmm_jax`` in the bucket (R, H), then
    floored per read."""
    from falcon_genome_tpu.io.dna import encode_seq
    from falcon_genome_tpu.models import haplotypecaller as JH

    n_r, n_h = len(reads), len(haps)
    B = n_r * n_h
    planes = {k: np.zeros((R, B), np.uint8) for k in ("q", "BI", "BD")}
    codes = np.full((R, B), 4, np.uint8)
    rl = np.zeros((1, B), np.int32)
    hap_t = np.full((H, B), 4, np.uint8)
    hl = np.zeros((1, B), np.int32)
    for ri, rec in enumerate(reads):
        seq, qual = JH.clip_read_to_region(rec, rstart, rend)
        n = len(seq)
        cols = slice(ri * n_h, (ri + 1) * n_h)
        codes[:n, cols] = encode_seq(seq)[:, None]
        planes["q"][:n, cols] = (np.frombuffer(qual.encode(), np.uint8)
                                 - 33)[:, None]
        rl[0, cols] = max(n, 1)
        for tag in ("BI", "BD"):
            planes[tag][:max(n, 1), cols] = 45
            if rec.get_tag(tag) is not None:
                _, t = JH.clip_read_to_region(_as_quals(rec, tag), rstart,
                                              rend)
                planes[tag][:n, cols] = (np.frombuffer(t.encode(), np.uint8)
                                         - 33)[:, None]
        for hi, h in enumerate(haps):
            hap_t[:len(h), ri * n_h + hi] = h
            hl[0, ri * n_h + hi] = len(h)
    logp = jax_pairhmm(codes, planes["q"], planes["BI"], planes["BD"], GCP,
                       rl, hl, hap_t, R=R, H=H)
    return TH.normalize_read_likelihoods(logp.reshape(n_r, n_h))


def _count_kernels(monkeypatch):
    calls = {"K4": 0, "K5": 0}
    for name, k in (("pairhmm_sc", "K4"), ("pairhmm_pb", "K5")):
        real = getattr(P, name)

        def wrapped(*a, _real=real, _k=k, **kw):
            calls[_k] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(P, name, wrapped)
    return calls


def _htc(records, ref, monkeypatch):
    """htc's ``call_interval`` on the CPU, with each
    ``_likelihoods_multi`` call's regions and matrices kept."""
    from falcon_genome_tpu_torch.models.activeregion import (
        ActiveRegionParams)
    from falcon_genome_tpu_torch.models.assembly import AssemblyParams
    seen = []
    real = TH._likelihoods_multi

    def keep(staged, gcp, device):
        out = real(staged, gcp, device)
        seen.append((staged, out))
        return out

    monkeypatch.setattr(TH, "_likelihoods_multi", keep)
    params = TH.HTCParams(assembly=AssemblyParams(kmer_sizes=(15, 21)),
                          active=ActiveRegionParams(threshold=0.02),
                          device=CPU)
    vcf = TH.HaplotypeCaller(params).call_interval(records, ref, "chr1", 0,
                                                   600)
    return vcf, seen


def test_htc_region_with_tags_equals_reference_matrix(monkeypatch):
    ref = np.random.default_rng(11).integers(0, 4, 600).astype(np.uint8)
    recs = tagged_records(12, ref)
    calls = _count_kernels(monkeypatch)
    vcf, seen = _htc(recs, ref, monkeypatch)
    [(staged, mats)] = seen
    assert staged and calls["K5"] >= 1 and calls["K4"] == 0
    maxrl = max(len(c) for s in staged for c, *_ in s["clipped"])
    maxhl = max(len(h) for s in staged for h in s["haps"])
    params = TH._default_pairhmm_params(maxrl, maxhl, CPU)
    tagged = 0
    for s, mat in zip(staged, mats):
        want = reference_matrix(s["reads"], s["haps"], s["rstart"],
                                s["rend"], params.max_read_len,
                                params.max_hap_len)
        assert np.array_equal(_bits(mat), _bits(want))
        tagged += sum(bi is not None for _, _, bi, _ in s["clipped"])
        assert any(bi is None for _, _, bi, _ in s["clipped"])
    assert tagged >= 10
    assert any(v.alts and not v.is_gvcf_block for v in vcf)


def test_mutect2_matrix_with_tags_equals_reference(monkeypatch):
    """``read_hap_likelihood_matrix`` (``mutect2``'s route) passes (B, R')
    BI/BD planes to ``pairhmm_logp``, which launches K5."""
    ref = np.random.default_rng(13).integers(0, 4, 600).astype(np.uint8)
    recs = tagged_records(14, ref, n=24)
    alt = ref[200:360].copy()
    alt[100] = (alt[100] + 1) % 4
    haps = [ref[200:360], alt, np.concatenate([ref[200:280], ref[284:360]])]
    calls = _count_kernels(monkeypatch)
    mat, _ = TH.read_hap_likelihood_matrix(recs, haps, 200, 360, GCP, CPU)
    assert calls == {"K4": 0, "K5": 1}
    maxrl = max(len(TH.clip_read(r, 200, 360)[0]) for r in recs)
    params = TH._default_pairhmm_params(maxrl, 160, CPU)
    want = reference_matrix(recs, haps, 200, 360, params.max_read_len,
                            params.max_hap_len)
    assert np.array_equal(_bits(mat), _bits(want))
    # without the tags the matrix is another one, from K4
    for r in recs:
        r.tags = {}
    plain, _ = TH.read_hap_likelihood_matrix(recs, haps, 200, 360, GCP, CPU)
    assert calls == {"K4": 1, "K5": 1}
    assert not np.array_equal(plain, mat)


def test_region_without_tags_launches_k4_unchanged(monkeypatch):
    """No read carries BI/BD: htc passes the scalars 45/45 (K4, no K5),
    and its matrices are the reference's with constant gap opens."""
    ref = np.random.default_rng(11).integers(0, 4, 600).astype(np.uint8)
    recs = tagged_records(12, ref)
    for r in recs:
        r.tags = {}
    calls = _count_kernels(monkeypatch)
    _, seen = _htc(recs, ref, monkeypatch)
    [(staged, mats)] = seen
    assert calls["K4"] >= 1 and calls["K5"] == 0
    maxrl = max(len(c) for s in staged for c, *_ in s["clipped"])
    maxhl = max(len(h) for s in staged for h in s["haps"])
    params = TH._default_pairhmm_params(maxrl, maxhl, CPU)
    for s, mat in zip(staged, mats):
        assert all(bi is None and bd is None
                   for _, _, bi, bd in s["clipped"])
        want = reference_matrix(s["reads"], s["haps"], s["rstart"],
                                s["rend"], params.max_read_len,
                                params.max_hap_len)
        assert np.array_equal(_bits(mat), _bits(want))


def test_untagged_region_in_a_tagged_chunk_is_unchanged(monkeypatch):
    """One chunk of two regions, only the first with tagged reads: the
    chunk goes to K5 with tables, and the second region's reads take 45
    on every row, so its matrix has the bits that a chunk without any
    tag gives it (K4, the same bucket)."""
    ref = np.random.default_rng(15).integers(0, 4, 600).astype(np.uint8)
    tagged = tagged_records(16, ref, n=12)
    plain = tagged_records(17, ref, n=12)
    for r in plain:
        r.tags = {}
    haps = [ref[200:360], np.concatenate([ref[200:280], ref[284:360]])]

    def region(recs):
        return {"reads": recs, "haps": haps,
                "clipped": [TH.clip_read(r, 200, 360) for r in recs]}

    calls = _count_kernels(monkeypatch)
    mixed = TH._likelihoods_multi([region(tagged), region(plain)], GCP, CPU)
    assert calls == {"K4": 0, "K5": 1}
    for r in tagged:
        r.tags = {}
    none = TH._likelihoods_multi([region(tagged), region(plain)], GCP, CPU)
    assert calls == {"K4": 1, "K5": 1}
    assert np.array_equal(_bits(mixed[1]), _bits(none[1]))
    assert not np.array_equal(mixed[0], none[0])


# --- the tags on records ------------------------------------------------

def test_indel_quals_read_from_records(tmp_path):
    """BI/BD as phred - 33 arrays, None where absent, the same from a SAM
    record and from a BAM read back (raw tags, decoded on demand or not
    at all)."""
    recs = tagged_records(3, np.zeros(600, np.uint8), n=6)
    recs[2].set_tag("NM", "i", 1)
    header = TS.SamHeader([("chr1", 600)])
    path = str(tmp_path / "t.bam")
    TB.write_bam(path, header, recs)
    _, back = TB.read_bam(path)
    for rec, raw in zip(recs, back):
        want = [None if rec.get_tag(t) is None else
                np.frombuffer(rec.get_tag(t).encode(), np.uint8) - 33
                for t in ("BI", "BD")]
        for got in (TS.indel_quals(rec), TS.indel_quals(raw)):
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                assert w is None or (g.dtype == np.uint8
                                     and np.array_equal(g, w))
    untagged = back[0]
    assert untagged.get_tag("BI") is None
    assert TS.indel_quals(untagged) == (None, None)


def test_indel_quals_refuse_a_tag_of_another_length():
    rec = TS.SamRecord("r", 0, 0, 0, 60, [(TS.CIGAR_M, 4)], seq="ACGT",
                       qual="IIII")
    rec.set_tag("BD", "Z", "III")
    with pytest.raises(Exception, match="3 qualities for 4 bases"):
        TS.indel_quals(rec)


def test_clip_read_clips_the_tags_with_the_bases():
    rec = TS.SamRecord("r", 0, 0, 100, 60,
                       [(TS.CIGAR_S, 2), (TS.CIGAR_M, 6), (TS.CIGAR_I, 1),
                        (TS.CIGAR_M, 3)], seq="AACCGGTTACG",
                       qual="ABCDEFGHIJK")
    rec.set_tag("BI", "Z", "abcdefghijk")
    codes, q, bi, bd = TH.clip_read(rec, 103, 108)
    seq, qual = TH.clip_read_to_region(rec, 103, 108)
    assert TH.decode_seq(codes) == seq and bd is None
    assert bytes(q + 33).decode() == qual
    assert bytes(bi + 33).decode() == qual.lower()
    assert TH.clip_read(rec, 0, 50)[2].tolist() == []


# --- the plain reference and the spans -----------------------------------

def test_gap_continuation_planes_match_float64_reference():
    """``pairhmm_logp`` with all three planes per row (gap continuation
    5-14 along each read) against the float64 golden model: the per-row
    transitions a_im and the continuation come from the right row."""
    case = region_tables(9, NR=6, NH=2, R=16, H=24)
    reads, quals, rl, haps, hl, pr, ph, ins, dels = case
    inside = np.arange(16)[None, :] < rl[:, None]
    gcp = np.where(inside, np.random.default_rng(9).integers(5, 15, (6, 16)),
                   0).astype(np.uint8)
    got = P.pairhmm_logp(reads[pr], quals[pr], ins[pr], dels[pr], gcp[pr],
                         rl[pr], haps[ph], hl[ph], params=_params(16, 24))
    want = golden(*case, gcp=gcp)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOG10_TOL)
    assert not np.allclose(golden(*case), want, rtol=0, atol=1e-3)


def test_spans_name_the_kernel_and_count_k5_work():
    """Under the profiler a call with tables records ``planes`` 2 on its
    tables step and ``kernel`` K5 on its launch with K5's work (equal to
    a hand count by K4's rule, which the gap opens do not enter: pairs
    over their own rows and, from quality-0 first bases, late pairs over
    the bucket's); a scalar call records 0 and K4; ``pairhmm_logp`` with
    planes names K5 too."""
    case = region_tables(10, R=72, H=80, quality0=True)
    reads, quals, rl, haps, hl, pr, ph, ins, dels = case
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _pairs(case, R=72, H=80)
            _pairs(case, 45, 45, R=72, H=80)
            P.pairhmm_logp(reads[pr], quals[pr], ins[pr], dels[pr], GCP,
                           rl[pr], haps[ph], hl[ph], params=_params(72, 80))
        rec = spans.spans()
    finally:
        spans.reset()
    tables = [s.attrs for s in rec if s.name == "pairhmm.tables"]
    launches = [s.attrs for s in rec if s.name == "pairhmm.launch"]
    assert tables[:2] == [{"planes": 2}, {"planes": 0}]
    want = k4_count(quals[pr, 0], rl[pr], hl[ph], GCP, 72, 80)
    assert 0 < want["fitted"] < want["pairs"] == len(pr)
    late = want["slots"] - k4_count(np.full(len(pr), 30), rl[pr], hl[ph],
                                    GCP, 72, 80)["slots"]
    assert late > 0                 # the quality-0 pairs sweep on
    assert launches[0] == {"kernel": "K5", **want}
    assert launches[1]["kernel"] == "K4" and "fitted" in launches[1]
    assert launches[2] == {"kernel": "K5"}


def test_k5_work_by_hand_at_gcp_0():
    """At gap continuation phred 0 row 0's a_im is 0: every pair with a
    row is late, over the bucket's rows to R + H."""
    case = region_tables(11, R=40, H=64)
    reads, quals, rl, haps, hl, pr, ph, *_ = case
    assert (rl >= 1).all()
    got = P._k5_work(quals, rl, hl, pr, ph, 0, 40, 64)
    rows = math.ceil(40 / 32)
    assert got == {"pairs": len(pr), "fitted": 0,
                   "cells": int(rl[pr] @ hl[ph]),
                   "slots": 32 * rows * (40 + 64) * len(pr)}


def test_k5_work_by_hand_late_and_fitted():
    """One call in the bucket 40 x 64 at gap continuation phred 10: a read
    of 20 bases sweeps its own row a thread over 20 + 64 diagonals
    (fitted); one of 33 with a quality-0 first base is late, over the
    bucket's 2 rows a thread to 40 + 64."""
    quals = np.full((2, 40), 30, np.uint8)
    quals[1, 0] = 0
    rl = np.array([20, 33], np.int32)
    hl = np.array([64], np.int32)
    got = P._k5_work(quals, rl, hl, np.array([0, 1]), np.array([0, 0]),
                     GCP, 40, 64)
    assert got == {"pairs": 2, "fitted": 1, "cells": (20 + 33) * 64,
                   "slots": 32 * (1 * (20 + 64) + 2 * (40 + 64))}


@pytest.mark.cuda
def test_pairs_with_tables_on_card_equal_cpu():
    """The per-base route on the card (K5) against the CPU twin, bit for
    bit, in htc's bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    case = region_tables(12, NR=90, NH=4, R=152, H=384, quality0=True)
    reads, quals, rl, haps, hl, pr, ph, ins, dels = case
    want = _pairs(case, R=152, H=384)
    before = P.LAUNCHES["fgt_pairhmm_pb"]
    got = P.pairhmm_logp_pairs(
        reads, quals, rl, haps, hl, pr, ph, ins, dels, GCP,
        params=P.PairHMMParams(152, 384, torch.device("cuda")))
    assert P.LAUNCHES["fgt_pairhmm_pb"] == before + 1
    assert np.array_equal(_bits(got), _bits(want))
