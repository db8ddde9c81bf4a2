"""The port's copies of the JAX package's remaining host helpers against
the reference's: ``io/`` (``bgzf_compress_file``, ``is_bgzf``,
``write_sam``/``read_sam``, ``merge_intervals``/``total_bp``,
``norm_vcf``, ``read_bam_coords``, ``ref_span_lengths``, ``comp_codes``),
``stages/common.py`` (``records_in_shard``), ``stages/bamstages.py``
(``load_bam_input``, ``BamInputSource.columns``/``.records``),
``utils/common.py`` (``get_files_by_ext``, ``iter_chunks``) and
``config.py`` (``set_config``).  Same seeded inputs through both; equal
bytes, records or values."""
import gzip

import numpy as np
import pytest
import torch

from falcon_genome_tpu import config as JC
from falcon_genome_tpu.io import bam as JBAM
from falcon_genome_tpu.io import bgzf as JBGZF
from falcon_genome_tpu.io import columns as JCOL
from falcon_genome_tpu.io import dna as JDNA
from falcon_genome_tpu.io import intervals as JIV
from falcon_genome_tpu.io import sam as JSAM
from falcon_genome_tpu.io import vcf as JVCF
from falcon_genome_tpu.stages import bamstages as JBS
from falcon_genome_tpu.stages import common as JSC
from falcon_genome_tpu.utils import common as JU
from falcon_genome_tpu_torch import config as TC
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.io import bam as TBAM
from falcon_genome_tpu_torch.io import bgzf as TBGZF
from falcon_genome_tpu_torch.io import columns as TCOL
from falcon_genome_tpu_torch.io import dna as TDNA
from falcon_genome_tpu_torch.io import intervals as TIV
from falcon_genome_tpu_torch.io import native_ext as TNE
from falcon_genome_tpu_torch.io import sam as TSAM
from falcon_genome_tpu_torch.io import vcf as TVCF
from falcon_genome_tpu_torch.stages import bamstages as TBS
from falcon_genome_tpu_torch.stages import common as TSC
from falcon_genome_tpu_torch.utils import common as TU

torch.set_num_threads(1)

CONTIGS = [("chr1", 6000), ("chr2", 4000)]


def records(seed=3, n=160):
    """Reference records on two contigs: clips, indels, N-skips, reverse
    strand, tags of several types, mates, and unmapped reads."""
    rng = np.random.default_rng(seed)
    cigars = ["50M", "5S45M", "20M3D30M", "20M2I28M", "10M100N40M",
              "45M5S", "3H47M"]
    out = []
    for i in range(n):
        tid = int(rng.integers(0, 2))
        cig = JSAM.cigar_from_str(cigars[i % len(cigars)])
        qlen = JSAM.cigar_query_len(cig)
        seq = JDNA.decode_seq(rng.integers(0, 5, qlen).astype(np.uint8))
        qual = (rng.integers(2, 42, qlen) + 33).astype(np.uint8)
        r = JSAM.SamRecord(
            f"r{i:04d}", 0x10 * (i % 2) | (0x41 if i % 3 else 0), tid,
            int(rng.integers(0, CONTIGS[tid][1] - 300)),
            int(rng.integers(0, 61)), cig, tid, int(rng.integers(0, 5000)),
            int(rng.integers(-400, 400)), seq,
            qual.tobytes().decode("latin1"))
        r.set_tag("NM", "i", int(rng.integers(0, 9)))
        r.set_tag("RG", "Z", f"rg{i % 2}")
        if i % 5 == 0:
            r.set_tag("XF", "f", 0.5)
        out.append(r)
    out += [JSAM.SamRecord(f"u{i}", 4, seq="ACGTN", qual="IIII#")
            for i in range(4)]
    return out


def header():
    return JSAM.SamHeader(contigs=list(CONTIGS), read_groups=[
        {"ID": "rg0", "SM": "s"}, {"ID": "rg1", "SM": "s"}])


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1000, 150_000])
def test_bgzf_compress_file_matches_reference(tmp_path, size):
    """Equal bytes (BGZF blocks, EOF marker), readable by ``gzip``,
    recognized by ``is_bgzf``; a plain gzip file is not BGZF."""
    rng = np.random.default_rng(size)
    payload = rng.integers(0, 4, size).astype(np.uint8).tobytes()
    src = tmp_path / "a.txt"
    src.write_bytes(payload)
    want = JBGZF.bgzf_compress_file(src, tmp_path / "ref.gz")
    got = TBGZF.bgzf_compress_file(src, tmp_path / "port.gz")
    assert got == str(tmp_path / "port.gz")
    assert (tmp_path / "port.gz").read_bytes() == \
        (tmp_path / "ref.gz").read_bytes()
    with gzip.open(got, "rb") as f:
        assert f.read() == payload
    assert TBGZF.is_bgzf(got) and JBGZF.is_bgzf(want)
    assert TBGZF.bgzf_compress_file(src) == str(src) + ".gz"
    plain = tmp_path / "plain.gz"
    with gzip.open(plain, "wb") as f:
        f.write(payload)
    assert not TBGZF.is_bgzf(plain) and not JBGZF.is_bgzf(plain)
    assert not TBGZF.is_bgzf(src)


def test_write_and_read_sam_match_reference(tmp_path):
    """The same SAM text, read back to the same header and records."""
    recs = records()
    JSAM.write_sam(str(tmp_path / "ref.sam"), header(), recs)
    th = TSAM.SamHeader.from_text(header().to_text())
    out = TSAM.write_sam(str(tmp_path / "port.sam"), th,
                         convert.sam_records(recs))
    assert out == str(tmp_path / "port.sam")
    assert (tmp_path / "port.sam").read_text() == \
        (tmp_path / "ref.sam").read_text()
    h, got = TSAM.read_sam(str(tmp_path / "ref.sam"))
    jh, want = JSAM.read_sam(str(tmp_path / "ref.sam"))
    assert h.to_text() == jh.to_text()
    assert got == convert.sam_records(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_intervals_and_total_bp_match_reference(seed):
    rng = np.random.default_rng(seed)
    ivs = []
    for _ in range(40):
        c = f"chr{int(rng.integers(1, 4))}"
        s = int(rng.integers(1, 500))
        ivs.append((c, s, s + int(rng.integers(0, 40))))
    got = TIV.merge_intervals([TIV.Interval(*t) for t in ivs])
    want = JIV.merge_intervals([JIV.Interval(*t) for t in ivs])
    assert [(i.contig, i.start, i.end) for i in got] == \
        [(i.contig, i.start, i.end) for i in want]
    assert len(got) < len(ivs)
    assert TIV.total_bp(got) == JIV.total_bp(want)
    assert TIV.merge_intervals([]) == [] and TIV.total_bp([]) == 0


def test_norm_vcf_matches_reference(tmp_path):
    """Records at one (contig, pos, ref) joined into one multiallelic
    record; the same BGZF bytes as the reference's."""
    jh = JVCF.VcfHeader(contigs=list(CONTIGS), samples=["s1"])
    recs = []
    for c, pos, ref, alt in (("chr1", 100, "A", "G"), ("chr1", 100, "A", "T"),
                             ("chr1", 100, "A", "G"), ("chr1", 100, "AT", "A"),
                             ("chr1", 250, "C", "G"), ("chr2", 5, "G", "A"),
                             ("chr2", 5, "G", "C")):
        recs.append(JVCF.VcfRecord(c, pos, ref, [alt], qual=30.0,
                                   filter="PASS", info={"DP": 20},
                                   fmt=["GT"], samples=[{"GT": "0/1"}]))
    src = JVCF.write_vcf(tmp_path / "in.vcf", jh, recs)
    want = JVCF.norm_vcf(src, tmp_path / "ref.vcf.gz")
    got = TVCF.norm_vcf(src, tmp_path / "port.vcf.gz")
    assert (tmp_path / "port.vcf.gz").read_bytes() == \
        (tmp_path / "ref.vcf.gz").read_bytes()
    _, out = TVCF.read_vcf(got)
    assert [(r.contig, r.pos, r.ref, r.alts) for r in out] == [
        ("chr1", 100, "A", ["G", "T"]), ("chr1", 100, "AT", ["A"]),
        ("chr1", 250, "C", ["G"]), ("chr2", 5, "G", ["A", "C"])]
    assert JVCF.read_vcf(want)[1][0].alts == ["G", "T"]


@pytest.mark.parametrize("native", [True, False])
def test_read_bam_coords_matches_reference(tmp_path, native, monkeypatch):
    """(tid, pos, flag) rows of every record, through the host extension
    and through the record reader."""
    recs = records()
    JBAM.write_bam(tmp_path / "in.bam", header(), recs)
    want = JBAM.read_bam_coords(tmp_path / "in.bam")
    if not native:
        monkeypatch.setattr(TNE, "available", lambda: False)
    elif not TNE.available():
        pytest.skip("the host C++ extension did not build")
    got = TBAM.read_bam_coords(tmp_path / "in.bam")
    assert got.dtype == np.int64 and got.shape == (len(recs), 3)
    np.testing.assert_array_equal(got, want)


def test_ref_span_lengths_and_comp_codes_match_reference():
    recs = records()
    got = TCOL.ref_span_lengths(TCOL.RecordColumns.from_records(
        convert.sam_records(recs)))
    want = JCOL.ref_span_lengths(JCOL.RecordColumns.from_records(recs))
    np.testing.assert_array_equal(got, want)
    assert got[4] == 150                              # 10M100N40M
    assert got[-1] == 0 and got.dtype == np.int64
    empty = TCOL.RecordColumns.from_records([])
    assert TCOL.ref_span_lengths(empty).shape == (0,)
    codes = np.arange(5, dtype=np.uint8).repeat(3)
    np.testing.assert_array_equal(TDNA.comp_codes(codes),
                                  JDNA.comp_codes(codes))
    assert TDNA.comp_codes(np.array([0, 1, 2, 3, 4], np.uint8)).tolist() == \
        [3, 2, 1, 0, 4]


# ---------------------------------------------------------------------------
# stages, utils, config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [
    [("chr1", 1, 6000)], [("chr1", 1000, 1500), ("chr2", 200, 900)],
    [("chr2", 3990, 4000)]])
def test_records_in_shard_matches_reference(shard):
    recs = records()
    trecs = convert.sam_records(recs)
    th = TSAM.SamHeader.from_text(header().to_text())
    got = TSC.records_in_shard(trecs, [TIV.Interval(*t) for t in shard], th)
    want = JSC.records_in_shard(recs, [JIV.Interval(*t) for t in shard],
                                header())
    assert got == convert.sam_records(want)
    assert all(not r.is_unmapped for r in got)
    # the cached columns of the same list serve a second shard
    again = TSC.records_in_shard(trecs, [TIV.Interval(*t) for t in shard],
                                 th)
    assert again == got
    assert TSC.records_in_shard([], [TIV.Interval("chr1", 1, 5)], th) == []


def test_load_bam_input_and_source_match_reference(tmp_path):
    """A file and a bucket folder of parts load to the reference's
    coordinate-sorted records; ``BamInputSource.columns``/``.records``
    are all records of the file."""
    recs = records()
    path = tmp_path / "in.bam"
    JBAM.write_bam(path, header(), recs)
    folder = tmp_path / "parts"
    folder.mkdir()
    for k in range(3):
        JBAM.write_bam(folder / f"part-{k:06d}.bam", header(), recs[k::3])
    for src in (path, folder):
        th, got = TBS.load_bam_input(str(src))
        jh, want = JBS.load_bam_input(str(src))
        assert th.to_text() == jh.to_text()
        assert got == convert.sam_records(want)
    source = TBS.BamInputSource(str(path))
    jsource = JBS.BamInputSource(str(path))
    assert source.records == convert.sam_records(jsource.records)
    assert len(source.columns) == len(recs)
    assert source.columns is source.columns


def test_get_files_by_ext_and_iter_chunks_match_reference(tmp_path):
    for name in ("b.bam", "a.bam", "c.bai", "d.bam.bai", "e.txt"):
        (tmp_path / name).write_text("x")
    (tmp_path / "sub.bam").mkdir()
    for ext in ("bam", ".bam", "bai", "vcf"):
        assert TU.get_files_by_ext(tmp_path, ext) == \
            JU.get_files_by_ext(tmp_path, ext)
    assert [p.rsplit("/", 1)[1] for p in TU.get_files_by_ext(
        tmp_path, "bam")] == ["a.bam", "b.bam"]
    for n, k in ((0, 3), (7, 3), (9, 3), (5, 10)):
        assert list(TU.iter_chunks(range(n), k)) == \
            list(JU.iter_chunks(range(n), k))
    assert list(TU.iter_chunks(iter("abcde"), 2)) == [["a", "b"], ["c", "d"],
                                                      ["e"]]


def test_set_config_matches_reference(monkeypatch):
    """``set_config`` writes the global configuration as the reference's
    does, typed values and keys outside the option table alike."""
    monkeypatch.setattr(TC, "_global_config", TC.Config(
        machine=TC.Machine(4, 8), environ={}, load_files=False))
    monkeypatch.setattr(JC, "_global_config", JC.Config(
        machine=JC.Machine(4, 8), environ={}, load_files=False))
    for key, value in (("gatk.nprocs", 3), ("tpu.bam.stream_mb", "64"),
                       ("log_dir", "/x/log"), ("no.such.key", 1)):
        TC.set_config(key, value)
        JC.set_config(key, value)
        assert TC.get_config(key) == JC.get_config(key), key
    assert TC.get_config("gatk.nprocs") == 3
    assert TC.get_config_obj()._explicit == JC.get_config_obj()._explicit
