"""The port's host commands against the JAX package's, on the CPU.

On the reference's e2e world (two contigs, a het SNP at chr1:1001 and a
hom SNP at chr2:801, 100 bp pairs every 9 bp; ``tests/test_pipeline_e2e.py``)
both packages run ``ug``, ``depth`` (summary, the full output surface,
the CLI's flags), ``vcf_filter``, ``joint`` on two gVCFs from the port's
``htc`` and ``concat`` on the same inputs, and write the same files.  The
joint merge's GenotypeGVCFs semantics (``tests/test_joint_fidelity.py``)
hold on the port.  ``baserecal`` then ``printreads`` through the port's
CLI give the table and BAM of ``bqsr``; ``conf`` prints the
configuration; ``gatk`` translates GATK4- and GATK3-style walker
invocations (and ``-ERC GVCF``) as the reference does, with the same
outputs and exit codes; and for every one of the reference's 16 commands
a bad argument vector exits with the reference's code.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu import cli as jcli, stages as jstages
from falcon_genome_tpu.config import Config, Machine
from falcon_genome_tpu.io.dna import decode_seq, revcomp_codes
from falcon_genome_tpu.io.fasta import write_fasta
from falcon_genome_tpu.io.fastq import write_fastq
from falcon_genome_tpu.io.vcf import read_vcf
from falcon_genome_tpu.stages import vcfstages as JVS
from falcon_genome_tpu.utils.compare import compare_bam, compare_vcf
from falcon_genome_tpu_torch import cli as tcli, convert, stages as tstages
from falcon_genome_tpu_torch.bqsr import RecalTable
from falcon_genome_tpu_torch.io import vcf as TV
from falcon_genome_tpu_torch.stages import vcfstages as TVS

torch.set_num_threads(1)

CPU = torch.device("cpu")
DEPTH_SUFFIXES = ("", ".sample_summary", ".sample_statistics",
                  ".sample_cumulative_coverage_counts",
                  ".sample_cumulative_coverage_proportions",
                  ".sample_interval_summary", ".sample_gene_summary")


@pytest.fixture(scope="module")
def conf():
    c = Config(machine=Machine(8, 16), environ={}, load_files=False)
    c.set("gatk.ncontigs", 4)
    c.set("gatk.nprocs", 2)
    return c


@pytest.fixture(scope="module")
def world(tmp_path_factory, conf):
    """The reference's e2e world, aligned by the port (``align`` on the
    CPU; the BAM equals the reference's, tests/test_torch_germline.py),
    and the port's ``htc`` VCF (with its shard parts) and two gVCFs."""
    tmp = tmp_path_factory.mktemp("torch_host")
    rng = np.random.default_rng(11)
    chr1 = rng.integers(0, 4, 4000).astype(np.uint8)
    chr2 = rng.integers(0, 4, 2500).astype(np.uint8)
    write_fasta(tmp / "ref.fa", {"chr1": decode_seq(chr1),
                                 "chr2": decode_seq(chr2)})
    hap2_c1 = chr1.copy()
    hap2_c1[1000] = (hap2_c1[1000] + 1) % 4
    hap_c2 = chr2.copy()
    hap_c2[800] = (hap_c2[800] + 2) % 4
    read_len, frag = 100, 250
    names, s1, s2 = [], [], []
    i = 0
    for contig, haps in (("chr1", (chr1, hap2_c1)),
                         ("chr2", (hap_c2, hap_c2))):
        for start in range(0, len(haps[0]) - frag, 9):
            hap = haps[i % 2]
            names.append(f"frag{contig}_{start}")
            s1.append(decode_seq(hap[start:start + read_len]))
            s2.append(decode_seq(revcomp_codes(
                hap[start + frag - read_len:start + frag])))
            i += 1
    quals = ["I" * read_len] * len(names)
    write_fastq(tmp / "reads_1.fastq.gz", names, s1, quals)
    write_fastq(tmp / "reads_2.fastq.gz", names, s2, quals)
    ref = str(tmp / "ref.fa")
    tconf = convert.config(conf)
    bam = str(tmp / "aligned.bam")
    tstages.run_align(tconf, ref, bam, fastq1=str(tmp / "reads_1.fastq.gz"),
                      fastq2=str(tmp / "reads_2.fastq.gz"), sample_id="s1",
                      read_group="rg0", force=True, device=CPU)
    calls = str(tmp / "calls.vcf")
    tstages.run_htc(tconf, ref, bam, calls, produce_vcf=True, sample="s1",
                    force=True, device=CPU)
    gdir = tmp / "gvcfs"
    gdir.mkdir()
    for s in ("s1", "s2"):
        tstages.run_htc(tconf, ref, bam, str(gdir / f"{s}.g.vcf"),
                        sample=s, force=True, device=CPU)
    return dict(tmp=tmp, ref=ref, bam=bam, calls=calls, gdir=str(gdir))


def _both(conf, run_ref, run_port, out_dir: Path, *args, **kw) -> dict:
    """Run a stage of each package with the same arguments, the output
    path (``out_dir/<ref|port>``) after them."""
    out = {}
    for name, run, c in (("ref", run_ref, conf),
                         ("port", run_port, convert.config(conf))):
        out[name] = str(out_dir / name)
        run(c, *args, out[name], **kw)
    return out


def _same_vcf(a: str, b: str) -> list:
    ha, ra = read_vcf(a)
    hb, rb = read_vcf(b)
    assert vars(ha) == vars(hb)
    assert [vars(r) for r in ra] == [vars(r) for r in rb]
    return rb


def test_ug_matches_reference(world, conf, tmp_path):
    out = _both(conf, jstages.run_ug, tstages.run_ug, tmp_path,
                world["ref"], world["bam"], sample="s1", force=True)
    recs = _same_vcf(out["ref"], out["port"])
    got = {(r.contig, r.pos) for r in recs}
    assert {("chr1", 1001), ("chr2", 801)} <= got


@pytest.mark.parametrize("full", [False, True])
def test_depth_matches_reference(world, conf, tmp_path, full):
    """The summary alone, or geneList + per-base + interval +
    cumulative outputs (DepthWorker.cpp:46-91)."""
    kw = dict(sample="s1", force=True)
    if full:
        genes = tmp_path / "genes.list"
        genes.write_text("GENE1 chr1 900 1200\nGENE2 chr2 700 900\n")
        kw.update(gene_list=str(genes), omit_base_output=False,
                  omit_intervals=False)
    out = _both(conf, jstages.run_depth, tstages.run_depth, tmp_path,
                world["ref"], world["bam"], **kw)
    written = 0
    for suffix in DEPTH_SUFFIXES:
        a, b = Path(out["ref"] + suffix), Path(out["port"] + suffix)
        assert a.exists() == b.exists(), suffix
        if a.exists():
            assert a.read_text() == b.read_text(), suffix
            written += 1
    assert written == (7 if full else 5)
    mean = float(Path(out["port"] + ".sample_summary").read_text()
                 .splitlines()[1].split("\t")[2])
    assert 10 < mean < 40


def test_depth_cli_flags_match_reference(world, conf, tmp_path,
                                         monkeypatch):
    import falcon_genome_tpu.config as jconfig
    import falcon_genome_tpu_torch.config as tconfig
    monkeypatch.setattr(jconfig, "init", lambda: conf)
    monkeypatch.setattr(tconfig, "init", lambda: convert.config(conf))
    argv = ["depth", "-r", world["ref"], "-i", world["bam"], "-b", "-v",
            "-S", "s1", "-f"]
    assert jcli.main(argv + ["-o", str(tmp_path / "ref")]) == 0
    assert tcli.main(argv + ["-o", str(tmp_path / "port")]) == 0
    for suffix in DEPTH_SUFFIXES:
        a, b = tmp_path / f"ref{suffix}", tmp_path / f"port{suffix}"
        assert a.exists() == b.exists(), suffix
        if a.exists():
            assert a.read_text() == b.read_text(), suffix
    assert not (tmp_path / "port").exists()     # -b omits base output
    assert not (tmp_path / "port.sample_interval_summary").exists()
    assert (tmp_path / "port.sample_summary").exists()


@pytest.mark.parametrize("expr,name", [("QUAL < 1000000", "ALLQ"),
                                       ("QD < 2.0 || DP > 30", "LOWQD")])
def test_vcf_filter_matches_reference(world, conf, tmp_path, expr, name):
    out = _both(conf, jstages.run_vcf_filter, tstages.run_vcf_filter,
                tmp_path, world["ref"], world["calls"], filter_expr=expr,
                filter_name=name, force=True)
    recs = _same_vcf(out["ref"], out["port"])
    assert recs
    if name == "ALLQ":
        assert all(r.filter == "ALLQ" for r in recs)


def test_joint_matches_reference(world, conf, tmp_path):
    out = _both(conf, jstages.run_joint, tstages.run_joint, tmp_path,
                world["ref"], world["gdir"], force=True)
    recs = _same_vcf(out["ref"], out["port"])
    header, _ = read_vcf(out["port"])
    assert header.samples == ["s1", "s2"]
    r = [x for x in recs if (x.contig, x.pos) == ("chr1", 1001)][0]
    assert r.samples[0]["GT"] == r.samples[1]["GT"] == "0/1"


def test_concat_matches_reference(world, conf, tmp_path):
    parts = world["calls"] + ".parts"
    for name, run, c in (("ref", jstages.run_concat, conf),
                         ("port", tstages.run_concat,
                          convert.config(conf))):
        run(c, parts, str(tmp_path / f"{name}.vcf.gz"), force=True)
    recs = _same_vcf(str(tmp_path / "ref.vcf.gz"),
                     str(tmp_path / "port.vcf.gz"))
    assert recs and (tmp_path / "port.vcf.gz.tbi").exists()
    assert compare_vcf(str(tmp_path / "ref.vcf.gz"),
                       str(tmp_path / "port.vcf.gz")).equivalent


# ---- tests/test_joint_fidelity.py's cases, on both packages -------------

def _var(V, contig, pos, ref, alts, gt, ad, pl, dp=30, gq=99, qual=100.0):
    return V.VcfRecord(
        contig=contig, pos=pos, ref=ref, alts=alts, qual=qual,
        fmt=["GT", "AD", "DP", "GQ", "PL"],
        samples=[{"GT": gt, "AD": ad, "DP": dp, "GQ": gq, "PL": pl}])


def _block(V, contig, pos, end, gq=50, dp=25):
    return V.VcfRecord(
        contig=contig, pos=pos, ref="A", alts=["<NON_REF>"],
        info={"END": end}, fmt=["GT", "DP", "GQ"],
        samples=[{"GT": "0/0", "DP": dp, "GQ": gq}])


def _merge_case(V, name):
    """Per-sample record lists of one merge case."""
    if name == "ad_pl_remap_through_nonref":
        return [[_var(V, "chr1", 100, "A", ["T", "<NON_REF>"], "0/1",
                      [12, 11, 0], [40, 0, 45, 60, 50, 70])],
                [_var(V, "chr1", 100, "A", ["G", "<NON_REF>"], "0/1",
                      [14, 13, 0], [38, 0, 42, 58, 48, 66])]]
    if name == "indel_suffix_extension":
        return [[_var(V, "chr1", 200, "A", ["T", "<NON_REF>"], "0/1",
                      [10, 9, 0], [30, 0, 35, 45, 40, 60])],
                [_var(V, "chr1", 200, "AT", ["A", "<NON_REF>"], "0/1",
                      [8, 7, 0], [28, 0, 33, 44, 39, 58])]]
    if name == "homref_block_reconstitution":
        return [[_var(V, "chr1", 300, "C", ["G", "<NON_REF>"], "0/1",
                      [15, 14, 0], [45, 0, 50, 65, 55, 80])],
                [_block(V, "chr1", 250, 350, gq=48, dp=22)]]
    return [[_var(V, "chr1", 400, "A", ["T", "<NON_REF>"], "0/1",
                  [10, 10, 0], [50, 0, 55, 70, 60, 90], qual=100.0)],
            [_var(V, "chr1", 400, "A", ["T", "<NON_REF>"], "0/1",
                  [11, 9, 0], [48, 0, 52, 68, 58, 88], qual=100.0)]]


@pytest.mark.parametrize("name", ["ad_pl_remap_through_nonref",
                                  "indel_suffix_extension",
                                  "homref_block_reconstitution",
                                  "qual_is_exact_af_not_sum"])
def test_joint_merge_matches_reference(name):
    from falcon_genome_tpu.io import vcf as JV
    want = JVS._merge_shard_sites(
        [JVS._sample_evidence(s) for s in _merge_case(JV, name)],
        ["s1", "s2"])
    got = TVS._merge_shard_sites(
        [TVS._sample_evidence(s) for s in _merge_case(TV, name)],
        ["s1", "s2"])
    assert [vars(r) for r in got] == [vars(r) for r in want]
    r = got[0]
    if name == "ad_pl_remap_through_nonref":
        gi = r.alts.index("G") + 1
        assert r.samples[0]["PL"][TVS._gt_idx(0, gi)] == 60
    elif name == "indel_suffix_extension":
        assert r.ref == "AT" and set(r.alts) == {"TT", "A"}
    elif name == "homref_block_reconstitution":
        assert r.samples[1]["PL"] == [0, 48, 96] and r.info["AF"] == [0.25]
    else:
        assert r.qual is not None and r.qual != pytest.approx(200.0)


@pytest.mark.parametrize("gls", [
    [[1e-9, 1.0, 1e-9]], [[10 ** -1.0, 1.0, 10 ** -1.0]],
    [[1.0, 1e-5, 1e-10]] * 4,
    [[1e-6, 1.0, 1e-6]] + [[1.0, 1e-6, 1e-12]] * 3,
    [[1e-6, 1.0, 1e-6]] * 3 + [[1.0, 1e-6, 1e-12]], []])
def test_exact_af_qual_matches_reference(gls):
    assert TVS._exact_af_qual(gls) == JVS._exact_af_qual(gls)
    assert [TVS._gt_idx(j, k) for j in range(3) for k in range(j, 3)] == \
        [JVS._gt_idx(j, k) for j in range(3) for k in range(j, 3)]


# ---- baserecal + printreads and conf through the port's CLI -------------

def test_baserecal_printreads_cli_give_bqsr(world, conf, tmp_path):
    common = ["-r", world["ref"], "-i", world["bam"], "-f",
              "-O", "gatk.ncontigs=4", "-O", "gatk.nprocs=2",
              "-O", f"log_dir={tmp_path / 'log'}"]
    table = tmp_path / "table.npz"
    assert tcli.main(["--device", "cpu", "baserecal", "-o", str(table),
                      *common]) == 0
    assert tcli.main(["--device", "cpu", "printreads", "-b", str(table),
                      "-o", str(tmp_path / "pr.bam"), *common]) == 0
    assert tcli.main(["--device", "cpu", "bqsr", "-o",
                      str(tmp_path / "bq.bam"), *common]) == 0
    jtable = tmp_path / "jtable.npz"
    jstages.run_baserecal(conf, world["ref"], world["bam"], str(jtable),
                          force=True)
    jstages.run_printreads(conf, world["ref"], world["bam"], str(jtable),
                           str(tmp_path / "jpr.bam"), force=True)
    got = RecalTable.load(str(table))
    for other in (tmp_path / "bq.recal.npz", jtable):
        want = RecalTable.load(str(other))
        for f in ("qual_obs", "qual_err", "cycle_obs", "cycle_err",
                  "ctx_obs", "ctx_err"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.qual_obs.sum() > 0
    for other in ("bq.bam", "jpr.bam"):
        d = compare_bam(str(tmp_path / "pr.bam"), str(tmp_path / other),
                        compare_tags=True)
        assert d.equivalent and d.matching > 500, (other, d)


def test_conf_prints_the_configuration(capsys):
    assert tcli.main(["conf"]) == 0
    out = capsys.readouterr().out
    assert "gatk.ncontigs" in out
    assert jcli.main(["conf"]) == 0


GATK_CASES = {
    "gatk4_haplotypecaller": (["HaplotypeCaller", "-R", "{ref}", "-I",
                               "{bam}", "-O", "{out}.vcf.gz", "-f"],
                              ".vcf.gz"),
    "gatk3_unifiedgenotyper": (["-T", "UnifiedGenotyper", "-R", "{ref}",
                                "-I", "{bam}", "-o", "{out}.vcf", "-f"],
                               ".vcf"),
    "gatk4_gvcf": (["HaplotypeCaller", "-R", "{ref}", "-I", "{bam}",
                    "-ERC", "GVCF", "-O", "{out}.g.vcf.gz", "-f"],
                   ".g.vcf.gz"),
    "unknown_walker": (["-T", "NopeWalker", "-R", "{ref}"], None),
}


@pytest.mark.parametrize("case", list(GATK_CASES))
def test_gatk_passthrough_matches_reference(world, conf, tmp_path,
                                            monkeypatch, case):
    """``gatk`` with a walker in GATK4 style, in GATK3 ``-T`` style, with
    ``-ERC GVCF`` (a gVCF instead of ``--produce-vcf``), and an unknown
    walker: the port's exit code and output are the reference's."""
    import falcon_genome_tpu.config as jconfig
    import falcon_genome_tpu_torch.config as tconfig
    monkeypatch.setattr(jconfig, "init", lambda: conf)
    monkeypatch.setattr(tconfig, "init", lambda: convert.config(conf))
    args, suffix = GATK_CASES[case]

    def argv(name):
        return ["gatk"] + [a.format(ref=world["ref"], bam=world["bam"],
                                    out=tmp_path / name) for a in args]
    want = _exit_code(jcli.main, argv("ref"))
    got = _exit_code(tcli.main, ["--device", "cpu", *argv("port")])
    assert got == want == (1 if suffix is None else 0)
    if suffix is None:
        return
    recs = _same_vcf(str(tmp_path / f"ref{suffix}"),
                     str(tmp_path / f"port{suffix}"))
    variants = {(r.contig, r.pos) for r in recs if not r.is_gvcf_block}
    assert ("chr1", 1001) in variants
    assert any(r.is_gvcf_block for r in recs) == (case == "gatk4_gvcf")


def _bad_argv(cmd: str, tmp: Path) -> list[str]:
    """A vector the command refuses: an input that does not exist, or a
    missing required option (argparse)."""
    ref, out = ["-r", str(tmp / "no.fa")], ["-o", str(tmp / "out")]
    inp = ["-i", str(tmp / "no.bam")]
    return {
        "align": ["align", *ref, *out, "-1", str(tmp / "no_1.fq"),
                  "-2", str(tmp / "no_2.fq")],
        "markdup": ["markdup", *inp, *out],
        "baserecal": ["baserecal", *ref, *inp, *out],
        "printreads": ["printreads", *ref, *inp, *out],     # no -b
        "bqsr": ["bqsr", *ref, *inp, *out],
        "htc": ["htc", *ref, *inp, *out, "-v"],
        "mutect2": ["mutect2", *ref, *out, "-t", str(tmp / "no_t.bam")],
        "indel": ["indel", *ref, *inp, *out],
        "joint": ["joint", *ref, *out, "-i", str(tmp / "no_dir")],
        "ug": ["ug", *ref, *inp, *out],
        "gatk": ["gatk", "-T", "NopeWalker"],
        "depth": ["depth", *ref, *inp],                     # no -o
        "vcf_filter": ["vcf_filter", *ref, *out, "-i", str(tmp / "no.vcf"),
                       "--filter-expression", "QUAL < 30"],
        "germline": ["germline", *ref, *out, "-1", str(tmp / "no_1.fq"),
                     "-2", str(tmp / "no_2.fq"), "-v"],
        "concat": ["concat", *out, "-i", str(tmp / "no_dir")],
        "conf": ["conf", "--no-such-flag"],
    }[cmd]


def _exit_code(main, argv) -> int:
    try:
        return main(argv)
    except SystemExit as e:                # argparse: usage error
        return e.code


@pytest.mark.parametrize("cmd", list(jcli.COMMANDS))
def test_cli_exit_codes_match_reference(cmd, tmp_path):
    """Every command of the reference on a bad argument vector: the
    port's exit code is the reference's."""
    argv = _bad_argv(cmd, tmp_path)
    got = _exit_code(tcli.main, ["--device", "cpu", *argv])
    assert list(tcli.COMMANDS) == list(jcli.COMMANDS)
    want = _exit_code(jcli.main, argv)
    assert got == want
    assert want != 0 or cmd == "conf"
    assert not (tmp_path / "out").exists()
