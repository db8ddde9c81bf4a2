"""The port's somatic path against the JAX package's, on the CPU.

``Mutect2.call_interval`` (the batched path) and ``call_region`` on the
four simulations of ``tests/test_mutect2.py`` (a somatic SNV, a germline
het in both samples, tumor only, clean data); the host code of the
module (``filter_mutect_calls``, ``annotate_resources`` over plain and
tabix-indexed resource VCFs, ``read_contamination_table``) on the inputs
of ``tests/test_mutect2.py`` and ``tests/test_extraopts_resources.py``;
and ``run_mutect2`` through both packages' stages on a tumor/normal BAM
pair with a panel of normals and a germline resource.  Every comparison
is exact: the same VCF records, field by field.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu import stages as jstages
from falcon_genome_tpu.config import Config, Machine
from falcon_genome_tpu.io.bam import write_bam
from falcon_genome_tpu.io.dna import decode_seq
from falcon_genome_tpu.io.fasta import write_fasta
from falcon_genome_tpu.io.sam import SamHeader, SamRecord, cigar_from_str
from falcon_genome_tpu.io.vcf import VcfHeader, VcfRecord, read_vcf, \
    write_vcf
from falcon_genome_tpu.models import mutect2 as JM
from falcon_genome_tpu.utils.compare import compare_vcf
from falcon_genome_tpu_torch import convert, stages as tstages
from falcon_genome_tpu_torch.io import vcf as TV
from falcon_genome_tpu_torch.models import mutect2 as TM

sys.path.insert(0, str(Path(__file__).parent))
from test_haplotypecaller import simulate_reads  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _records(recs) -> list[dict]:
    return [vars(r) for r in recs]


def _sim(case: str):
    """The simulations of tests/test_mutect2.py, from the same seed and
    in the same draw order: (ref, tumor reads, normal reads or None)."""
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, 600).astype(np.uint8)
    somatic = ref.copy()
    somatic[300] = (somatic[300] + 1) % 4
    if case == "somatic_snv":
        return (ref, simulate_reads(somatic, ref, rng, n=80),
                simulate_reads(ref, ref, rng, n=200))
    if case == "germline_site":
        return (ref, simulate_reads(somatic, ref, rng, n=80),
                simulate_reads(somatic, ref, rng, n=60))
    if case == "tumor_only":
        return ref, simulate_reads(somatic, ref, rng, n=80), None
    return (ref, simulate_reads(ref, ref, rng, n=60),
            simulate_reads(ref, ref, rng, n=60))


CASES = ["somatic_snv", "germline_site", "tumor_only", "clean"]


def _port_m2(params=None):
    return TM.Mutect2(convert.mutect2_params(params or JM.Mutect2Params(),
                                             CPU))


@pytest.mark.parametrize("case", CASES)
def test_call_interval_matches_reference(case):
    ref, tumor, normal = _sim(case)
    want = JM.Mutect2().call_interval(tumor, normal, ref, "chr1", 0, 600)
    got = _port_m2().call_interval(
        convert.sam_records(tumor),
        convert.sam_records(normal) if normal else None,
        ref, "chr1", 0, 600)
    assert _records(got) == _records(want)
    # the verdicts of tests/test_mutect2.py hold on the port's calls
    hits = [v for v in got if v.pos == 301]
    if case == "somatic_snv":
        assert len(hits) == 1 and float(hits[0].info["NLOD"]) > 2.2
        assert "SB" in hits[0].samples[0] and "F1R2" in hits[0].info
    elif case == "tumor_only":
        assert len(hits) == 1 and "NLOD" not in hits[0].info
    elif case == "germline_site":
        assert not hits
    else:
        assert got == []


@pytest.mark.parametrize("case", ["somatic_snv", "tumor_only"])
def test_call_region_matches_reference(case):
    """The per-region path (one hap→ref batch, one PairHMM batch per
    sample) on the region around the planted site."""
    ref, tumor, normal = _sim(case)
    want = JM.Mutect2().call_region(tumor, normal, ref, "chr1", 200, 400)
    got = _port_m2().call_region(
        convert.sam_records(tumor),
        convert.sam_records(normal) if normal else None,
        ref, "chr1", 200, 400)
    assert _records(got) == _records(want)
    assert any(v.pos == 301 for v in got)


def test_mutect2_params_carried_across():
    jp = JM.Mutect2Params(tlod_threshold=4.0, min_mapq=20, gcp=12,
                          tumor_sample="T1")
    tp = convert.mutect2_params(jp, CPU)
    got = dataclasses.asdict(tp)
    assert got.pop("device") == CPU
    assert got == dataclasses.asdict(jp)
    assert tp.active.threshold == 0.01 and tp.assembly.min_edge_mult == 1


def _filter_inputs(mod):
    """The records of tests/test_mutect2.py's TestFilter and of
    tests/test_extraopts_resources.py's filter case, built with ``mod``'s
    ``VcfRecord``."""
    R = mod.VcfRecord
    return [
        R("chr1", 10, "A", ["G"], info={"TLOD": 20.0},
          fmt=["GT", "AD", "AF"],
          samples=[{"GT": "0/1", "AD": [10, 8], "AF": 0.4},
                   {"GT": "0/0", "AD": [20, 0], "AF": 0.0}]),
        R("chr1", 20, "C", ["T"], info={"TLOD": 3.0},
          fmt=["GT", "AD", "AF"],
          samples=[{"GT": "0/1", "AD": [10, 1], "AF": 0.09}]),
        R("chr1", 30, "G", ["A"], info={"TLOD": 30.0},
          fmt=["GT", "AD", "AF"],
          samples=[{"GT": "0/1", "AD": [5, 5], "AF": 0.5},
                   {"GT": "0/0", "AD": [10, 5], "AF": 0.33}]),
        R("chr1", 40, "A", ["C"], info={"TLOD": 25.0},
          fmt=["GT", "AD", "AF", "SB"],
          samples=[{"GT": "0/1", "AD": [30, 8], "AF": 0.2,
                    "SB": [15, 15, 8, 0]}]),
        R("chr1", 50, "A", ["C"], info={"TLOD": 25.0},
          fmt=["GT", "AD", "AF", "SB"],
          samples=[{"GT": "0/1", "AD": [30, 8], "AF": 0.2,
                    "SB": [15, 15, 4, 4]}]),
        R("chr1", 60, "C", ["A"], info={"TLOD": 25.0, "F1R2": 9, "F2R1": 0},
          fmt=["GT", "AD", "AF"],
          samples=[{"GT": "0/1", "AD": [30, 9], "AF": 0.23}]),
        R("chr1", 70, "C", ["A"], info={"TLOD": 25.0, "F1R2": 5, "F2R1": 4},
          fmt=["GT", "AD", "AF"],
          samples=[{"GT": "0/1", "AD": [30, 9], "AF": 0.23}]),
        R(contig="chr1", pos=1, ref="A", alts=["T"],
          info={"TLOD": 20.0, "PON": True},
          samples=[{"AD": [10, 8], "AF": 0.4}]),
        R(contig="chr1", pos=2, ref="A", alts=["T"],
          info={"TLOD": 20.0, "POPAF": 0.6},
          samples=[{"AD": [10, 8], "AF": 0.4}]),
        R(contig="chr1", pos=3, ref="A", alts=["T"], info={"TLOD": 20.0},
          samples=[{"AD": [50, 2], "AF": 0.02}]),
        R(contig="chr1", pos=4, ref="A", alts=["T"],
          info={"TLOD": 20.0, "POPAF": 6.0},
          samples=[{"AD": [10, 8], "AF": 0.4}]),
        R(contig="chr1", pos=5, ref="A", alts=["T"], info={"TLOD": 20.0},
          samples=[{"AD": [20, 8], "AF": 0.3},
                   {"AD": [20, 4], "AF": 0.17}]),
    ]


@pytest.mark.parametrize("contamination", [0.0, 0.05])
def test_filter_mutect_calls_matches_reference(contamination):
    from falcon_genome_tpu.io import vcf as JV
    want = JM.filter_mutect_calls(_filter_inputs(JV),
                                  contamination=contamination)
    got = TM.filter_mutect_calls(_filter_inputs(TV),
                                 contamination=contamination)
    assert _records(got) == _records(want)
    names = {f for r in got for f in r.filter.split(";")}
    assert names >= {"PASS", "weak_evidence", "strand_bias", "orientation",
                     "panel_of_normals", "germline", "normal_artifact"}
    assert TM._fisher_exact(15, 15, 8, 0) == JM._fisher_exact(15, 15, 8, 0)


def _resource(tmp_path, name, rows):
    header = VcfHeader(contigs=[("chr1", 100000)], samples=[])
    recs = [VcfRecord(contig=c, pos=p, ref=r, alts=[a], id=i,
                      info=info or {})
            for (c, p, r, a, i, info) in rows]
    path = str(tmp_path / name)
    write_vcf(path, header, recs)
    return path


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_annotate_resources_matches_reference(tmp_path, suffix):
    """PoN, germline AF, dbsnp and cosmic tables, read whole (plain VCF)
    or region by region through the tabix index (``.vcf.gz``)."""
    pon = _resource(tmp_path, "pon" + suffix,
                    [("chr1", 101, "A", "T", ".", None),
                     ("chr1", 401, "C", "G", ".", None)])
    germ = _resource(tmp_path, "germ" + suffix,
                     [("chr1", 201, "G", "C", "rs1", {"AF": 0.25}),
                      ("chr1", 501, "T", "A", "rs9", {"AF": 0.001})])
    db = _resource(tmp_path, "dbsnp" + suffix,
                   [("chr1", 55, "C", "G", "rs42", None),
                    ("chr1", 501, "T", "A", "rs9", None)])
    cos = _resource(tmp_path, "cosmic" + suffix,
                    [("chr1", 55, "C", "G", "COSM7", None)])
    if suffix == ".vcf.gz":
        for p in (pon, germ, db, cos):
            assert Path(p + ".tbi").exists()
    table = tmp_path / "cont.table"
    table.write_text("sample\tcontamination\terror\nS1\t0.037\t0.001\n"
                     "S2\t0.012\t0.002\n")

    def recs(mod):
        return [mod.VcfRecord(contig="chr1", pos=p, ref=r, alts=[a],
                              info={"TLOD": 20.0})
                for p, r, a in ((55, "C", "G"), (101, "A", "T"),
                                (201, "G", "C"), (301, "T", "A"),
                                (401, "C", "T"), (501, "T", "A"))]
    from falcon_genome_tpu.io import vcf as JV
    kw = dict(pon=pon, germline=germ, dbsnp=[db], cosmic=[cos],
              contamination_table=str(table))
    jres = JM.SomaticResources.load(**kw)
    tres = TM.SomaticResources.load(**kw)
    assert tres.contamination == jres.contamination == pytest.approx(0.037)
    assert tres.pon.indexed == jres.pon.indexed == (suffix == ".vcf.gz")
    want = JM.annotate_resources(recs(JV), "chr1", 0, 1000, jres)
    got = TM.annotate_resources(recs(TV), "chr1", 0, 1000, tres)
    assert _records(got) == _records(want)
    assert got[0].id == "rs42;COSM7" and got[1].info["PON"] is True
    assert got[4].info.get("PON") is True       # position-level match
    # a region query that holds no resource record
    assert _records(TM.annotate_resources(recs(TV), "chr1", 600, 700,
                                          tres)) == _records(
        JM.annotate_resources(recs(JV), "chr1", 600, 700, jres))
    assert _records(tres.pon.records("chr1", 100, 402)) == _records(
        jres.pon.records("chr1", 100, 402))


def test_read_contamination_table_matches_reference(tmp_path):
    t = tmp_path / "cont.table"
    t.write_text("sample\tcontamination\terror\nS1\t0.037\t0.001\n\n")
    assert TM.read_contamination_table(str(t)) == \
        JM.read_contamination_table(str(t)) == pytest.approx(0.037)
    bad = tmp_path / "bad.table"
    bad.write_text("sample\terror\nS1\t0.001\n")
    with pytest.raises(ValueError, match="no 'contamination' column"):
        TM.read_contamination_table(str(bad))


@pytest.fixture(scope="module")
def somatic_world(tmp_path_factory):
    """tests/test_extraopts_resources.py's e2e world: 3 kb, somatic SNVs
    at 1001 and 2001 in half of 600 tumor reads, a normal of 600 reference
    reads, a PoN at 1001 and a germline resource at 2001 and 1501."""
    tmp = tmp_path_factory.mktemp("torch_m2")
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, 3000).astype(np.uint8)
    write_fasta(tmp / "ref.fa", {"chr1": decode_seq(ref)})
    tum = ref.copy()
    tum[1000] = (tum[1000] + 1) % 4
    tum[2000] = (tum[2000] + 1) % 4

    def reads(hap, frac, name):
        out = []
        for i in range(600):
            pos = int(rng.integers(0, len(hap) - 100))
            src = hap if (i % 100) < frac * 100 else ref
            flag = (0x10 if i % 2 else 0) | (0x80 if i % 4 >= 2 else 0)
            out.append(SamRecord(
                f"{name}{i}", flag, 0, pos, 60, cigar_from_str("100M"),
                seq=decode_seq(src[pos:pos + 100]), qual="I" * 100))
        out.sort(key=lambda r: r.pos)
        return out
    header = SamHeader(contigs=[("chr1", 3000)])
    write_bam(tmp / "t.bam", header, reads(tum, 0.5, "t"))
    write_bam(tmp / "n.bam", header, reads(ref, 0.0, "n"))
    pon = _resource(tmp, "pon.vcf",
                    [("chr1", 1001, decode_seq(ref[1000:1001]),
                      decode_seq(tum[1000:1001]), ".", None)])
    germ = _resource(tmp, "germ.vcf.gz",
                     [("chr1", 1501, decode_seq(ref[1500:1501]),
                      decode_seq((ref[1500:1501] + 1) % 4), "rs5",
                      {"AF": 0.3}),
                      ("chr1", 2001, decode_seq(ref[2000:2001]),
                       decode_seq(tum[2000:2001]), "rs7", {"AF": 0.0001})])
    return dict(tmp=tmp, ref=str(tmp / "ref.fa"), tumor=str(tmp / "t.bam"),
                normal=str(tmp / "n.bam"), pon=pon, germline=germ)


@pytest.mark.parametrize("normal,run_filter", [(True, True), (True, False),
                                               (False, True)])
def test_run_mutect2_matches_reference(somatic_world, normal, run_filter):
    w = somatic_world
    conf = Config(machine=Machine(8, 16), environ={}, load_files=False)
    conf.set("gatk.ncontigs", 2)
    tag = f"{int(normal)}{int(run_filter)}"
    out = {}
    for name, run, c, extra in (
            ("ref", jstages.run_mutect2, conf, {}),
            ("port", tstages.run_mutect2, convert.config(conf),
             {"device": CPU})):
        out[name] = str(w["tmp"] / f"{name}{tag}.vcf")
        run(c, w["ref"], w["tumor"], out[name],
            normal_path=w["normal"] if normal else None,
            run_filter=run_filter, panels_of_normals=w["pon"],
            germline=w["germline"], force=True, **extra)
    jh, want = read_vcf(out["ref"])
    th, got = read_vcf(out["port"])
    assert vars(th) == vars(jh)
    assert _records(got) == _records(want)
    c = compare_vcf(out["ref"], out["port"])
    assert c.equivalent and c.concordant == len(want) >= 2
    by_pos = {r.pos: r for r in got}
    assert 1001 in by_pos and 2001 in by_pos
    if run_filter and normal:
        assert "panel_of_normals" in by_pos[1001].filter
        assert by_pos[2001].filter == "PASS"
