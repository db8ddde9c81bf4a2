"""The port's long-read path against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages: the reference with
its ``backend="jax"`` Smith-Waterman, the port with its plain versions on
``device=cpu``.  Held, all bit-equal or record-equal:

* ``chain_anchors`` (native and Python) on the cases of
  ``tests/test_longread.py`` and random anchor sets;
* ``MinimizerIndex.lookup``, and ``.mmi.npz`` files written by each
  package loaded by the other;
* ``sw_extend_win_dispatch``: ops, lengths, counts, coordinates and
  scores, with windows past both ends of the genome and a split at
  ``MAX_LANES_PER_CALL``;
* ``LongReadAligner.align_batch``: every ``Alignment`` field of 12 reads
  of 1-5 kb at 5% error on both strands plus an unmappable read;
* ``align --long-reads`` and ``germline --long-reads`` through both CLIs:
  BAMs record-equal (``compare_bam`` with tags), VCFs record-equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from falcon_genome_tpu import aligner as JA
from falcon_genome_tpu import cli as jcli
from falcon_genome_tpu import longread as JL
from falcon_genome_tpu.config import Config, Machine
from falcon_genome_tpu.io import native_ext as jnative
from falcon_genome_tpu.io.dna import decode_seq, revcomp_codes
from falcon_genome_tpu.io.fasta import write_fasta
from falcon_genome_tpu.io.fastq import write_fastq
from falcon_genome_tpu.io.vcf import read_vcf
from falcon_genome_tpu.ops import smith_waterman as JS
from falcon_genome_tpu.utils.compare import compare_bam, compare_vcf
from falcon_genome_tpu_torch import aligner as TA
from falcon_genome_tpu_torch import cli as tcli
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch import longread as TL
from falcon_genome_tpu_torch.io import native_ext as tnative
from falcon_genome_tpu_torch.ops import smith_waterman as TS

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _sim_long_read(rng, genome, pos, L, err=0.05):
    """ONT-ish error profile: ~err/3 each of ins/del/sub (the reference
    test's simulator)."""
    r = genome[pos:pos + L]
    out = []
    i = 0
    while i < len(r):
        u = rng.random()
        if u < err / 3:
            out.append(rng.integers(0, 4))
        elif u < 2 * err / 3:
            i += 1
        elif u < err:
            out.append((r[i] + 1 + rng.integers(0, 3)) % 4)
            i += 1
        else:
            out.append(r[i])
            i += 1
    return np.array(out, np.uint8)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 120_000).astype(np.uint8)
    jp = JL.LongReadParams()
    jidx = JA.MinimizerIndex([("chr1", genome)], jp.index)
    return {"genome": genome, "jp": jp, "jidx": jidx,
            "tp": convert.long_read_params(jp),
            "tidx": convert.minimizer_index(jidx)}


# ---------------------------------------------------------------------------
# chaining
# ---------------------------------------------------------------------------

def _anchor_cases():
    q = np.arange(0, 500, 25)
    yield "collinear", q, q + 10_000
    yield "outlier", np.array([0, 25, 50, 75, 100, 60]), \
        np.array([0, 25, 50, 75, 100, 90_000]) + 5000
    ladder = np.arange(0, 300, 25)
    yield "second_locus", np.tile(ladder, 2), np.concatenate(
        [ladder + 1000, ladder + 50_000])
    rng = np.random.default_rng(9)
    for t in range(3):
        n = int(rng.integers(5, 400))
        q = np.sort(rng.integers(0, 5000, n)).astype(np.int64)
        r = q + rng.integers(-20, 20, n) + 7777
        r[rng.random(n) < 0.2] = rng.integers(0, 100_000)
        yield f"random{t}", q, r


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", [c[0] for c in _anchor_cases()])
def test_chain_anchors_match_reference(case, native, monkeypatch):
    """The best chain, its score and the runner-up are the reference's,
    bit for bit, through the native DP and through the Python twin."""
    _, q, r = next(c for c in _anchor_cases() if c[0] == case)
    if native:
        if not tnative.available():
            pytest.skip("the fgio extension did not build")
    else:
        monkeypatch.setattr(jnative, "chain_anchors", lambda *a: None)
        monkeypatch.setattr(tnative, "chain_anchors", lambda *a: None)
    jc, js, jo = JL.chain_anchors(q, r, 19, JL.LongReadParams())
    tc, ts, to = TL.chain_anchors(q, r, 19, TL.LongReadParams())
    np.testing.assert_array_equal(tc, jc)
    assert (ts, to) == (js, jo)
    if case == "collinear":
        assert len(tc) == len(q) and to == 0.0
    elif case == "outlier":
        assert len(tc) == 5
    elif case == "second_locus":
        assert to > 0.5 * ts


def test_native_chain_dp_matches_python_twin():
    """``native_ext.chain_anchors`` against the port's Python DP: the same
    parents and end, scores within 1e-12 relative (the reference test's
    tolerance: the C++ DP sums in another order)."""
    if not tnative.available():
        pytest.skip("the fgio extension did not build")
    p = TL.LongReadParams()
    for _, q, r in _anchor_cases():
        order = np.lexsort((q, r))
        qs, rs = q[order].astype(np.int64), r[order].astype(np.int64)
        L = min(p.lookback, len(q))
        f, parent, end = tnative.chain_anchors(qs, rs, 19, L, p.max_gap)
        fg, pg, eg = TL._chain_dp(qs, rs, 19, L, p.max_gap)
        np.testing.assert_allclose(f, fg, rtol=1e-12)
        np.testing.assert_array_equal(parent, pg)
        assert end == eg


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------

def test_lookup_matches_reference(world):
    rng = np.random.default_rng(5)
    r = _sim_long_read(rng, world["genome"], 3000, 4000)
    k, w = world["jp"].index.k, world["jp"].index.w
    h = np.concatenate([JA._minimizers(r, k, w)[0],
                        rng.integers(0, 2 ** 63, 50).astype(np.uint64)])
    for a, b in zip(world["jidx"].lookup(h), world["tidx"].lookup(h)):
        np.testing.assert_array_equal(a, b)
    qidx = world["tidx"].lookup(h)[0]
    assert len(qidx) > 100 and qidx.max() < len(h) - 50


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mmi_files_load_in_the_other_package(world, tmp_path, writer):
    """The ``.mmi.npz`` format is the interface: a file either package
    writes loads in the other with equal parameters and arrays."""
    path = tmp_path / "ref.mmi.npz"
    src = world["jidx"] if writer == "reference" else world["tidx"]
    src.save(path)
    loaded = (TA.MinimizerIndex.load(path), JA.MinimizerIndex.load(path))
    for idx in loaded:
        assert dataclasses.asdict(idx.params) == dataclasses.asdict(
            world["jidx"].params)
        assert idx.contig_names == ["chr1"]
        assert idx.contig_lengths == [len(world["genome"])]
        for f in ("offsets", "genome", "hashes", "positions", "strands"):
            np.testing.assert_array_equal(getattr(idx, f),
                                          getattr(world["jidx"], f))
        np.testing.assert_array_equal(idx.contig_codes[0], world["genome"])


# ---------------------------------------------------------------------------
# window-gather extension
# ---------------------------------------------------------------------------

def _win_lanes(genome, B, seed):
    """Long-read chunk lanes at 160/256: reads of 100-144 bases cut from
    the genome with 5% substitutions, windows around them; the first and
    last lanes start past the genome's ends, one lane is empty."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    R, W = 160, 256
    reads = np.full((B, R), 4, np.uint8)
    rl = rng.integers(100, 145, B).astype(np.int32)
    starts = rng.integers(0, G - W, B).astype(np.int32)
    starts[0], starts[-1] = -40, G - 90
    wl = np.full(B, 240, np.int32)
    for b in range(B):
        seg = genome[max(starts[b], 0) + 30:][:rl[b]]
        rl[b] = len(seg)
        reads[b, :len(seg)] = np.where(rng.random(len(seg)) < 0.05,
                                       (seg + 1) % 4, seg)
    rl[1] = 0
    return reads, rl, starts, wl


@pytest.mark.parametrize("max_lanes", [8192, 16], ids=["one", "multi"])
def test_win_dispatch_matches_reference(world, monkeypatch, max_lanes):
    genome = world["genome"]
    reads, rl, starts, wl = _win_lanes(genome, 40, seed=3)
    monkeypatch.setattr(JS, "MAX_LANES_PER_CALL", max_lanes)
    monkeypatch.setattr(TS, "MAX_LANES_PER_CALL", max_lanes)
    p = JS.SWParams()
    jb = JS.SWBucket(max_read_len=160, max_win_len=256, backend="jax")
    jh = JS.sw_extend_win_dispatch(reads, rl, JS.device_genome(genome),
                                   starts, wl, p, jb)
    th = TS.sw_extend_win_dispatch(
        reads, rl, TS.device_genome(genome, CPU), starts, wl,
        convert.sw_params(p), convert.sw_bucket(jb, CPU))
    assert th[0] == ("multi" if max_lanes == 16 else "one")
    ja, ta = JS.sw_extend_collect_arrays(jh), TS.sw_extend_collect_arrays(th)
    for name, a, b in zip(("ops", "lens", "nc", "coords", "best"), ja, ta):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert ta[4][1] == 0 and (ta[4] > 0).sum() > 30
    jr, tr = JS.sw_extend_collect(jh), TS.sw_extend_collect(th)
    assert [dataclasses.astuple(x) for x in jr] == \
        [dataclasses.astuple(x) for x in tr]


def test_win_dispatch_refuses_mismatched_inputs(world):
    reads, rl, starts, wl = _win_lanes(world["genome"], 4, seed=4)
    bucket = TS.SWBucket(max_read_len=128, max_win_len=256, device=CPU)
    genome = TS.device_genome(world["genome"], CPU)
    with pytest.raises(ValueError, match="rows"):
        TS.sw_extend_win_dispatch(reads, rl, genome, starts, wl,
                                  TS.SWParams(), bucket)
    with pytest.raises(ValueError, match="genome is on"):
        TS.sw_extend_win_dispatch(reads, rl, genome, starts, wl,
                                  TS.SWParams(), TS.SWBucket(160, 256))


# ---------------------------------------------------------------------------
# the aligner
# ---------------------------------------------------------------------------

def _long_reads(genome, n, seed, lo=1000, hi=5000):
    rng = np.random.default_rng(seed)
    reads, truth = [], []
    for t in range(n):
        pos = int(rng.integers(0, len(genome) - hi - 1000))
        r = _sim_long_read(rng, genome, pos, int(rng.integers(lo, hi)))
        if t % 2:
            r = revcomp_codes(r)
        reads.append(r)
        truth.append((pos, t % 2 == 1))
    return reads, truth


def test_align_batch_matches_reference(world, monkeypatch):
    """12 reads of 1-5 kb (5% error, both strands) and a random 2 kb read,
    in sub-batches of 5 (the pipeline's overlap runs twice): every field
    of every ``Alignment`` is the reference's."""
    reads, truth = _long_reads(world["genome"], 12, seed=3)
    reads.append(np.random.default_rng(4).integers(0, 4, 2000)
                 .astype(np.uint8))
    monkeypatch.setattr(JL.LongReadAligner, "SUB_BATCH", 5)
    monkeypatch.setattr(TL.LongReadAligner, "SUB_BATCH", 5)
    jb = JS.SWBucket(max_read_len=160, max_win_len=256, backend="jax")
    ja = JL.LongReadAligner(world["jidx"], world["jp"], jb).align_batch(reads)
    eng = TL.LongReadAligner(world["tidx"], world["tp"], device=CPU)
    assert (eng.bucket.max_read_len, eng.bucket.max_win_len) == (160, 256)
    ta = eng.align_batch(reads)
    assert [dataclasses.asdict(a) for a in ja] == \
        [dataclasses.asdict(a) for a in ta]
    placed = sum(a.mapped and a.is_rev == rev and abs(a.pos - pos) < 100
                 for a, (pos, rev) in zip(ta, truth))
    assert placed == len(truth)
    assert not ta[-1].mapped or ta[-1].mapq <= 10


# ---------------------------------------------------------------------------
# through the CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def confs(monkeypatch):
    import falcon_genome_tpu.config as jconfig
    import falcon_genome_tpu_torch.config as tconfig
    c = Config(machine=Machine(8, 16), environ={}, load_files=False)
    c.set("gatk.ncontigs", 2)
    c.set("gatk.nprocs", 2)
    c.set("minimap.num_buckets", 4)
    monkeypatch.setattr(jconfig, "init", lambda: c)
    monkeypatch.setattr(tconfig, "init", lambda: convert.config(c))
    return c


def _write_reads(path, reads):
    write_fastq(path, [f"lr{i}" for i in range(len(reads))],
                [decode_seq(r) for r in reads],
                ["I" * len(r) for r in reads])


def test_cli_align_long_reads_matches_reference(world, tmp_path, confs):
    """``align --long-reads`` on the 120 kb contig, 8 reads of 1-3 kb
    through each CLI: the sorted BAMs are record-equal (tags too)."""
    ref = tmp_path / "ref.fa"
    write_fasta(ref, {"chr1": decode_seq(world["genome"])})
    reads, truth = _long_reads(world["genome"], 8, seed=7, hi=3000)
    _write_reads(tmp_path / "lr.fastq", reads)
    out = {}
    for name, main, pre in (("ref", jcli.main, []),
                            ("port", tcli.main, ["--device", "cpu"])):
        out[name] = str(tmp_path / f"{name}.bam")
        assert main([*pre, "align", "-r", str(ref), "-1",
                     str(tmp_path / "lr.fastq"), "-o", out[name],
                     "--long-reads", "-f"]) == 0
    d = compare_bam(out["ref"], out["port"], compare_tags=True)
    assert d.equivalent and d.matching == 8


def test_cli_germline_long_reads_matches_reference(tmp_path, confs):
    """``germline --long-reads`` on a 6 kb contig with 2 het SNVs, 48
    reads of 1.5 kb (12x, 3% error, both strands): the aligned bucket
    trees and the deduplicated BAM record-equal, the VCFs record-equal."""
    rng = np.random.default_rng(21)
    G = 6000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    write_fasta(tmp_path / "ref.fa", {"chr1": decode_seq(genome)})
    truth = np.sort(rng.choice(np.arange(1500, G - 1500), 2, replace=False))
    hap = genome.copy()
    hap[truth] = (hap[truth] + 1) % 4
    reads = []
    for i in range(48):
        r = _sim_long_read(rng, hap if i % 2 == 0 else genome,
                           int(rng.integers(0, G - 1600)), 1500, err=0.03)
        reads.append(revcomp_codes(r) if i % 4 == 1 else r)
    _write_reads(tmp_path / "g.fastq", reads)
    out = {}
    for name, main, pre in (("ref", jcli.main, []),
                            ("port", tcli.main, ["--device", "cpu"])):
        out[name] = tmp_path / f"{name}.vcf.gz"
        assert main([*pre, "germline", "-r", str(tmp_path / "ref.fa"),
                     "-1", str(tmp_path / "g.fastq"), "-o", str(out[name]),
                     "--long-reads", "-S", "lr", "--produce-vcf",
                     "-f"]) == 0
    work = {k: tmp_path / f"{k}.vcf.gz.work" for k in out}
    parts = sorted(p.name for p in (work["ref"] / "aligned").glob("*.bam"))
    assert parts == sorted(
        p.name for p in (work["port"] / "aligned").glob("*.bam"))
    # minimap.num_buckets (4), not bwa's: reads start in the first three
    assert parts == [f"part-{i:06d}.bam" for i in range(3)]
    for part in parts:
        assert compare_bam(str(work["ref"] / "aligned" / part),
                           str(work["port"] / "aligned" / part),
                           compare_tags=True).equivalent, part
    d = compare_bam(str(work["ref"] / "dedup.bam"),
                    str(work["port"] / "dedup.bam"), compare_tags=True)
    assert d.equivalent and d.matching == 48
    _, jrecs = read_vcf(str(out["ref"]))
    _, trecs = read_vcf(str(out["port"]))
    assert [vars(r) for r in jrecs] == [vars(r) for r in trecs]
    c = compare_vcf(str(out["ref"]), str(out["port"]))
    assert c.equivalent
    called = {r.pos - 1 for r in trecs
              if r.alts and r.alts[0] not in ("<NON_REF>", ".")}
    # the accuracy gate is the smoke's (30x); here one site is enough to
    # show that calls came through
    assert set(truth.tolist()) & called
