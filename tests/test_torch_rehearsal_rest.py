"""The port's mesh, long-read, indel and joint-cohort rehearsals and its
two Smith-Waterman bench scripts, each through its ``main`` at a tiny
size on the CPU, against the JAX side.

- ``mesh_rehearsal`` on the WGS rehearsal's 8 kb chain (align and
  markdup of ``wgs_rehearsal``): the mesh run equals the single one, and
  its VCF equals the JAX package's ``run_htc`` on the same ``dedup.bam``;
- ``longread_rehearsal`` on a 100 kb reference: ``gen_reads`` byte-equal
  to the JAX script's, the BAM record-equal to the JAX ``run_align(
  long_reads=True)``;
- ``indel_rehearsal`` on the 8 kb chain: ``realigned.bam`` equal to the
  JAX ``run_indel``'s, the row with the dataset's own genome and reads;
- ``joint_cohort`` over the 8 kb reference: the gVCFs' records equal the
  JAX script's ``gen_cohort``'s, the joint VCF the JAX ``run_joint``'s,
  and a flipped genotype fails the gate;
- ``bench_longread``: its mapped count equals the JAX aligner's on the
  same reads; ``bench_sw_parts``: the composed parts equal
  ``sw_extend_batch``, which equals the JAX package's at B = 64.
"""
import importlib.util
import json
import logging
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu import stages as jstages
from falcon_genome_tpu.aligner import IndexParams as JIndexParams
from falcon_genome_tpu.aligner import MinimizerIndex as JMinimizerIndex
from falcon_genome_tpu.config import init as jconf_init
from falcon_genome_tpu.io import native_ext
from falcon_genome_tpu.io.fasta import FastaFile, write_fasta
from falcon_genome_tpu.io.dna import decode_seq
from falcon_genome_tpu.io.vcf import read_vcf
from falcon_genome_tpu.longread import LongReadAligner as JLongReadAligner
from falcon_genome_tpu.longread import LongReadParams as JLongReadParams
from falcon_genome_tpu.ops import smith_waterman as jsw
from falcon_genome_tpu.ops.sw_ref import SWParams as JSWParams
from falcon_genome_tpu.stages.vcfstages import run_joint as jrun_joint
from falcon_genome_tpu.utils.compare import compare_bam, compare_vcf
from falcon_genome_tpu_torch import longread as tlongread
from falcon_genome_tpu_torch.benchmarks import (
    bench_longread, bench_sw_parts, indel_rehearsal, joint_cohort,
    longread_rehearsal, mesh_rehearsal, wgs_rehearsal as W)
from falcon_genome_tpu_torch.ops import smith_waterman as sw
from falcon_genome_tpu_torch.ops.sw_ref import SWParams

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "benchmarks"
GENOME_MB = 0.008
JOINT_SITES = 40

pytestmark = pytest.mark.skipif(
    not native_ext.available(),
    reason="the rehearsals' BAM paths need the native library")


def load_jax_script(name: str):
    """A root script as a module (its ``from wgs_rehearsal import`` found
    beside it), the root logger left as it was."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(SCRIPTS))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(SCRIPTS))
        root.handlers[:] = handlers
        root.setLevel(level)
    return mod


def jax_conf(work: Path):
    conf = jconf_init(environ={})
    conf.set("temp_dir", str(work / "tmp"))
    conf.set("log_dir", str(work / "log"))
    return conf


def last_row(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The WGS rehearsal's dataset at 8 kb / 666 pairs, aligned and
    deduplicated by the port's ``wgs_rehearsal`` (``dedup.bam``)."""
    work = tmp_path_factory.mktemp("rest_chain")
    saved = (W.G, W.N_PAIRS, W.N_SNPS)
    try:
        W.G, W.N_PAIRS, W.N_SNPS = W.scale(GENOME_MB)
        assert W.main([str(work), "--stages", "a,m", "--device", "cpu",
                       "--out", str(work / "wgs.json")]) == 0
    finally:
        W.G, W.N_PAIRS, W.N_SNPS = saved
    assert (work / "dedup.bam").exists()
    return work


def test_mesh_rehearsal(chain, tmp_path, capsys):
    """The 8-shard (data=4, region=2) mesh run equals the single run, and
    the single run's VCF equals the JAX package's ``run_htc``."""
    out = tmp_path / "mesh.json"
    assert mesh_rehearsal.main([str(chain), str(GENOME_MB), "--device",
                                "cpu", "--out", str(out)]) == 0
    res = last_row(capsys)
    assert res == json.loads(out.read_text())
    assert res["equal"] is True and res["span_mb"] == GENOME_MB
    assert res["single"]["n_calls"] == res["mesh8"]["n_calls"] > 0
    for run in ("single", "mesh8"):
        assert {"wall_s", "n_calls"} <= res[run].keys()
        assert res[run]["pairhmm_cards"] == ["cpu"]
        assert res[run]["peak_device_gb"] is None
        assert set(res[run]["launches"].values()) == {0}
    assert (res["card"], res["cards"]) == ("cpu", 1)
    want = tmp_path / "jax.vcf.gz"
    jstages.run_htc(jax_conf(tmp_path), str(chain / "ref.fa"),
                    str(chain / "dedup.bam"), str(want), produce_vcf=True,
                    intervals=str(chain / f"slice{GENOME_MB:g}.bed"),
                    force=True)
    for run in ("single", "mesh8"):
        got = str(chain / f"mesh_gate_{run}.vcf.gz")
        assert [vars(r) for r in read_vcf(got)[1]] == \
            [vars(r) for r in read_vcf(str(want))[1]]
        c = compare_vcf(str(want), got)
        assert c.equivalent and c.concordant > 0


def test_mesh_rehearsal_reports_a_difference(chain, tmp_path, monkeypatch,
                                             capsys):
    """Runs that disagree exit 1 and print the first differences (the
    stage stood in for by a copy of ``test_mesh_rehearsal``'s VCF, one
    record dropped from the mesh run's)."""
    import shutil

    from falcon_genome_tpu_torch import stages as tstages
    from falcon_genome_tpu_torch.io import vcf as tvcf
    work = tmp_path / "w"
    work.mkdir()
    for name in ("ref.fa", "ref.fa.fai", "dedup.bam", "dedup.bam.bai"):
        if (chain / name).exists():
            (work / name).symlink_to(chain / name)
    vcf = chain / "mesh_gate_single.vcf.gz"
    monkeypatch.setattr(tstages, "run_htc",
                        lambda conf, ref, bam, out, **k: shutil.copy(vcf, out))
    real = tvcf.read_vcf

    def one_fewer(path):
        hdr, recs = real(path)
        return hdr, (recs[1:] if "mesh8" in str(path) else recs)
    monkeypatch.setattr(tvcf, "read_vcf", one_fewer)
    assert mesh_rehearsal.main([str(work), str(GENOME_MB), "--device",
                                "cpu", "--out",
                                str(tmp_path / "m.json")]) == 1
    text = capsys.readouterr().out
    assert "only single: [(" in text and "only mesh: []" in text
    assert json.loads((tmp_path / "m.json").read_text())["equal"] is False


@pytest.fixture(scope="module")
def longread_runs(tmp_path_factory):
    """``longread_rehearsal`` (0.1 Mbp of reads on a 100 kb reference) in
    the port and, on the same FASTQ, the JAX package's stage."""
    root = tmp_path_factory.mktemp("longread")
    codes = np.random.default_rng(5).integers(0, 4, 100_000).astype(np.uint8)
    for d in ("port", "jax"):
        (root / d).mkdir()
        write_fasta(root / d / "ref.fa", {"chr1": decode_seq(codes)})
    out = root / "port.json"
    assert longread_rehearsal.main([str(root / "port"), "0.1", "--device",
                                    "cpu", "--out", str(out)]) == 0
    jax_mod = load_jax_script("longread_rehearsal")
    fa = FastaFile(str(root / "jax" / "ref.fa"))
    jax_mod.gen_reads(root / "jax", fa.contig_codes("chr1"), 100_000,
                      np.random.default_rng(77))
    jstages.run_align(jax_conf(root / "jax"), str(root / "jax" / "ref.fa"),
                      str(root / "jax" / "long_aligned.bam"),
                      fastq1=str(root / "port" / "long_reads.fastq"),
                      sample_id="lr", long_reads=True, force=True)
    return root, json.loads(out.read_text())["longread"]


def test_longread_reads_equal_jax_script(longread_runs):
    root, _ = longread_runs
    got = (root / "port" / "long_reads.fastq").read_bytes()
    assert got == (root / "jax" / "long_reads.fastq").read_bytes()
    assert got.count(b"\n@lr") >= 5


def test_longread_bam_equals_jax(longread_runs):
    root, row = longread_runs
    d = compare_bam(str(root / "jax" / "long_aligned.bam"),
                    str(root / "port" / "long_aligned.bam"),
                    compare_tags=True)
    assert d.equivalent and d.matching >= row["reads"], d
    assert {"wall_s", "peak_rss_gb", "reads", "total_mbp", "mbp_per_s",
            "reads_per_s", "mapped_frac"} <= row.keys()
    assert row["mapped_frac"] >= 0.95 and row["total_mbp"] == 0.1
    assert row["launches"] == dict.fromkeys(W.KERNELS, 0)
    assert (row["card"], row["peak_device_gb"]) == ("cpu", None)


def test_indel_rehearsal(chain, tmp_path, capsys):
    """``realigned.bam`` equals the JAX ``run_indel``'s; the row has the
    dataset's genome and reads and the count the stage logged."""
    out, series = tmp_path / "r.json", tmp_path / "series.json"
    assert indel_rehearsal.main([str(chain), "--device", "cpu", "--out",
                                 str(out), "--series", str(series)]) == 0
    row = last_row(capsys)
    assert row == json.loads(out.read_text())["indel"]
    snaps = json.loads(series.read_text())["indel"]
    assert {"start", "end", "samples"} <= snaps.keys() and snaps["samples"]
    assert row["peak_split"]["rss_gb"] > 0
    assert {"wall_s", "peak_rss_gb", "genome_mb", "reads",
            "s_per_mb"} <= row.keys()
    assert (row["genome_mb"], row["reads"]) == (
        GENOME_MB, 2 * W.scale(GENOME_MB)[1])
    assert isinstance(row["realigned_reads"], int)
    assert row["launches"] == dict.fromkeys(W.KERNELS, 0)
    want = tmp_path / "jax.bam"
    jstages.run_indel(jax_conf(tmp_path), str(chain / "ref.fa"),
                      str(chain / "dedup.bam"), str(want), force=True)
    d = compare_bam(str(want), str(chain / "realigned.bam"),
                    compare_tags=True)
    assert d.equivalent and d.matching > 1000, d


def test_realigned_count_from_the_log():
    assert indel_rehearsal.realigned(
        ["x", "indel: 17 reads realigned → out.bam"]) == 17
    assert indel_rehearsal.realigned(["no count"]) is None


@pytest.fixture
def few_sites(monkeypatch):
    """The cohort's truth sites cut to fit the 8 kb reference, on both
    scripts."""
    jax_mod = load_jax_script("joint_cohort")
    for mod in (joint_cohort, jax_mod):
        monkeypatch.setattr(mod, "N_SITES", JOINT_SITES)
    return jax_mod


def test_joint_cohort(chain, tmp_path, few_sites, capsys):
    """Five samples: gVCF records equal the JAX script's, the joint VCF
    equals the JAX ``run_joint``'s, and the gate passes."""
    out = tmp_path / "r.json"
    (tmp_path / "ref.fa").symlink_to(chain / "ref.fa")
    assert joint_cohort.main([str(tmp_path), "5", "--device", "cpu",
                              "--out", str(out)]) == 0
    row = last_row(capsys)
    assert row == json.loads(out.read_text())["joint_cohort"]
    assert {"samples", "sites", "genome_mb", "wall_s", "peak_rss_gb",
            "missing_sites", "extra_sites", "gt_errors", "ac_errors",
            "pass"} <= row.keys()
    assert row["pass"] and (row["samples"], row["sites"]) == (5,
                                                              JOINT_SITES)
    assert row["genome_mb"] == GENOME_MB
    assert row["launches"] == dict.fromkeys(W.KERNELS, 0)
    jwork = tmp_path / "jax"
    jwork.mkdir()
    gdir, contig, pos, gts = few_sites.gen_cohort(
        jwork, str(chain / "ref.fa"), 5, np.random.default_rng(7))
    port_dir = tmp_path / "joint_cohort"
    for s in range(5):
        name = f"gvcfs/s{s:03d}.g.vcf.gz"
        want, got = read_vcf(str(jwork / name)), read_vcf(
            str(port_dir / name))
        assert vars(got[0]) == vars(want[0])
        assert [vars(r) for r in got[1]] == [vars(r) for r in want[1]]
    jout = str(jwork / "joint.vcf.gz")
    jrun_joint(jax_conf(jwork), str(chain / "ref.fa"), str(gdir), jout,
               force=True)
    assert [vars(r) for r in read_vcf(str(port_dir / "joint.vcf.gz"))[1]] \
        == [vars(r) for r in read_vcf(jout)[1]]


def test_joint_cohort_gate_fails_on_a_flipped_genotype(
        chain, tmp_path, few_sites, monkeypatch, capsys):
    real = joint_cohort.gen_cohort

    def flipped(*args):
        gdir, contig, pos, gts = real(*args)
        gts = gts.copy()
        gts[1, 0] = (gts[1, 0] + 1) % 3
        return gdir, contig, pos, gts
    monkeypatch.setattr(joint_cohort, "gen_cohort", flipped)
    (tmp_path / "ref.fa").symlink_to(chain / "ref.fa")
    assert joint_cohort.main([str(tmp_path), "3", "--device", "cpu",
                              "--out", str(tmp_path / "r.json")]) == 1
    row = last_row(capsys)
    assert not row["pass"] and row["gt_errors"] >= 1


def test_bench_longread_mapped_equals_jax(monkeypatch, capsys):
    """The reads ``bench_longread`` aligns, through the JAX package's
    aligner: the same mapped count, and each alignment equal."""
    seen = []
    real = tlongread.LongReadAligner.align_batch

    def align_batch(self, reads):
        out = real(self, reads)
        seen.append((reads, out))
        return out
    monkeypatch.setattr(tlongread.LongReadAligner, "align_batch",
                        align_batch)
    assert bench_longread.main(["3", "3000", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    mapped = int(re.search(r"mapped (\d+)/3", out).group(1))
    row = json.loads(out.strip().splitlines()[-1])
    assert row["mapped"] == mapped and row["card"] == "cpu"
    assert (row["peak_device_gb"], set(row["launches"].values())) == (
        None, {0})
    assert "cumulative" in out
    assert len(seen) == 4 and all(r is seen[0][0] for r, _ in seen)
    genome = np.random.default_rng(3).integers(
        0, 4, bench_longread.G).astype(np.uint8)
    lp = JLongReadParams(index=JIndexParams(k=19, w=10, max_hits=256))
    jeng = JLongReadAligner(JMinimizerIndex([("chr1", genome)], lp.index),
                            lp)
    want = jeng.align_batch(seen[0][0])
    assert sum(a.mapped for a in want) == mapped == 3
    assert [vars(a) for a in seen[-1][1]] == [vars(a) for a in want]


def test_bench_sw_parts_equal_sw_extend_batch(capsys):
    """The composed parts equal ``sw_extend_batch`` (the script checks
    it), and the port's ``sw_extend_batch`` equals the JAX package's
    (``backend="jax"``) on the script's lanes."""
    assert bench_sw_parts.main(["64", "--device", "cpu"]) == 0
    row = last_row(capsys)
    assert row["parts_equal_sw_extend_batch"] is True
    assert row["launches"] == dict.fromkeys(W.KERNELS, 0)
    assert set(row["ms"]) == {
        "sw_extend_batch e2e", "host pack", "host -> card copy",
        "K2 sw_pointers (ptrs on card)", "K3 sw_traceback",
        "card -> host copy", "host decode (_results_from_packed)"}
    R, W_ = bench_sw_parts.R, bench_sw_parts.W
    reads, rl, wins, wl = bench_sw_parts.lanes(64, np.random.default_rng(0))
    got = sw.sw_extend_batch(reads, rl, wins, wl, SWParams(), sw.SWBucket(
        max_read_len=R, max_win_len=W_, device=torch.device("cpu")))
    want = jsw.sw_extend_batch(reads, rl, wins, wl, JSWParams(), jsw.SWBucket(
        max_read_len=R, max_win_len=W_, backend="jax"))
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert all(r.score > 0 for r in got)
