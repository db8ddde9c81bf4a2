"""The port's WGS rehearsal (``falcon_genome_tpu_torch/benchmarks/
wgs_rehearsal.py``) on the CPU, against the JAX side.

One small dataset (8 kb, 666 pairs of 150 bp, 25x) from the port's
``gen_dataset`` feeds three chains of align → markdup → bqsr → htc with
256 buckets, as the rehearsal runs them:

- the port's ``main`` with every stage forced out of core
  (``tpu.align.spill_mb=0``, ``tpu.bam.stream_mb=0``): align's bucket
  spill, markdup streamed over the tree, bqsr streaming ``dedup.bam``
  through its ``.bai``, htc region-pruned over the recalibrated tree;
- the JAX package's stages on the same inputs with the same options;
- the port's ``main`` at the default thresholds (in memory).

Every ``part-*.bam`` of the aligned and recalibrated trees, the dedup
BAM, the recalibration table and the VCF of the first equal the other
two's.  The dataset equals the JAX script's byte for byte, and
``classify_extras`` equals the JAX script's (nested in its ``main``, so
taken from its source)."""
import ast
import importlib.util
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu import stages as jstages
from falcon_genome_tpu.config import init as jconf_init
from falcon_genome_tpu.io import native_ext
from falcon_genome_tpu.utils.compare import compare_bam, compare_vcf
from falcon_genome_tpu_torch.benchmarks import wgs_rehearsal as W

sys.path.insert(0, str(Path(__file__).parent))
from torch_parity import assert_vcf_records_equal  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "benchmarks" / "wgs_rehearsal.py"
GENOME_MB = 0.008
DATASET = ("ref.fa", "r_1.fastq", "r_2.fastq", "truth.npy")
# fewer shards than the defaults: the plain versions pay for each one
OPTIONS = ["gatk.ncontigs=4", "gatk.nprocs=2"]
OUT_OF_CORE = ["tpu.align.spill_mb=0", "tpu.bam.stream_mb=0"]
CPU = torch.device("cpu")

pytestmark = pytest.mark.skipif(
    not native_ext.available(),
    reason="the out-of-core paths need the native library")


def load_jax_script():
    """The JAX script as a module, the root logger left as it was (the
    script configures logging when imported)."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    spec = importlib.util.spec_from_file_location("jax_wgs_rehearsal",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    return mod


def jax_classify_extras():
    """``classify_extras`` as the JAX script defines it inside ``main``."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in main.body
              if isinstance(n, ast.FunctionDef)
              and n.name == "classify_extras")
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(JAX_SCRIPT),
                 "exec"), ns)
    return ns["classify_extras"]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("rehearsal_data")
    jax_mod = load_jax_script()
    saved = (W.G, W.N_PAIRS, W.N_SNPS)
    sizes = W.scale(GENOME_MB)
    try:
        for mod in (W, jax_mod):
            mod.G, mod.N_PAIRS, mod.N_SNPS = sizes
        W.gen_dataset(root / "port")
        (root / "jax").mkdir()
        jax_mod.gen_dataset(root / "jax")
    finally:
        W.G, W.N_PAIRS, W.N_SNPS = saved
    return {"port": root / "port", "jax": root / "jax"}


def link_dataset(src: Path, work: Path) -> None:
    work.mkdir(parents=True)
    for name in DATASET + ("dataset.json",):
        (work / name).symlink_to((src / name).resolve())


def run_main(work: Path, out: Path, options: list[str]) -> dict:
    argv = [str(work), "--device", "cpu", "--out", str(out)]
    for o in options:
        argv += ["-O", o]
    saved = (W.G, W.N_PAIRS, W.N_SNPS)
    try:
        W.G, W.N_PAIRS, W.N_SNPS = W.scale(GENOME_MB)
        assert W.main(argv) == 0
    finally:
        W.G, W.N_PAIRS, W.N_SNPS = saved
    # a genome other than the default 60 Mb has a section of its own
    return json.loads(out.read_text())[f"wgs@{GENOME_MB:g}mb"]


def run_jax_chain(work: Path, options: list[str]) -> dict[str, str]:
    """The JAX package's stages as the rehearsal calls them; the paths
    align and markdup logged."""
    conf = jconf_init(environ={})
    conf.set("temp_dir", str(work / "tmp"))
    conf.set("log_dir", str(work / "log"))
    for kv in options:
        conf.set(*kv.split("=", 1))
    ds, out = W.dataset_files(work), W.outputs(work)
    with W.Measured(CPU) as m:
        jstages.run_align(conf, ds["ref"], out["bam"], fastq1=ds["fq1"],
                          fastq2=ds["fq2"], sample_id="s", num_buckets=256,
                          merge=False, force=True)
        jstages.run_markdup(conf, out["buckets"], out["dedup"], force=True)
        jstages.run_bqsr(conf, ds["ref"], out["dedup"], out["recal"],
                         force=True)
        jstages.run_htc(conf, ds["ref"], out["recal"], out["vcf"],
                        produce_vcf=True, force=True)
    return W.logged_paths(m.log)


@pytest.fixture(scope="module")
def chains(tmp_path_factory, datasets):
    root = tmp_path_factory.mktemp("rehearsal_chains")
    runs = {}
    for name, options in (("port_ooc", OPTIONS + OUT_OF_CORE),
                          ("port_mem", OPTIONS)):
        link_dataset(datasets["port"], root / name)
        runs[name] = (root / name, run_main(root / name,
                                            root / f"{name}.json", options))
    link_dataset(datasets["port"], root / "jax_ooc")
    runs["jax_ooc"] = (root / "jax_ooc",
                       run_jax_chain(root / "jax_ooc", OPTIONS + OUT_OF_CORE))
    return runs


@pytest.mark.parametrize("name", DATASET)
def test_dataset_equals_jax_script(datasets, name):
    got = (datasets["port"] / name).read_bytes()
    assert got == (datasets["jax"] / name).read_bytes()
    assert len(got) > 0


def test_dataset_cached_only_at_its_sizes(datasets, tmp_path, capsys):
    """A work directory's dataset is reused at the sizes it was made
    with, and made anew at others."""
    work = tmp_path / "w"
    work.mkdir()
    for name in DATASET + ("dataset.json",):
        (work / name).write_bytes((datasets["port"] / name).read_bytes())
    saved = (W.G, W.N_PAIRS, W.N_SNPS)
    try:
        W.G, W.N_PAIRS, W.N_SNPS = W.scale(GENOME_MB)
        W.gen_dataset(work)
        assert "dataset cached" in capsys.readouterr().out
        W.G, W.N_PAIRS, W.N_SNPS = W.scale(GENOME_MB / 2)
        W.gen_dataset(work)
        assert "dataset cached" not in capsys.readouterr().out
    finally:
        W.G, W.N_PAIRS, W.N_SNPS = saved
    assert W.dataset_pairs(work) == W.scale(GENOME_MB / 2)[1]
    assert len(np.load(work / "truth.npy")) == W.scale(GENOME_MB / 2)[2]


def test_paths_taken(chains):
    """Forced out of core, each stage of both packages leaves memory;
    at the default thresholds the port's stay in it."""
    ooc, mem = chains["port_ooc"][1], chains["port_mem"][1]
    assert {s: ooc[s]["path"] for s in W.STAGES.values()} == {
        "align": "bucket spill", "markdup": "streamed", "bqsr": "stream",
        "htc": "tree"}
    assert {mem[s]["path"] for s in W.STAGES.values()} == {"in memory"}
    assert chains["jax_ooc"][1] == {"align": "bucket spill",
                                    "markdup": "streamed"}


@pytest.mark.parametrize("run", ["port_ooc", "port_mem"])
def test_rows_carry_the_jax_script_keys(chains, run):
    res = chains[run][1]
    for stage in W.STAGES.values():
        assert {"wall_s", "peak_rss_gb", "reads_per_s", "peak_device_gb",
                "launches", "path"} <= res[stage].keys()
        assert res[stage]["input_mb"] > 0
        assert res[stage]["peak_device_gb"] is None      # no card
        assert res[stage]["launches"] == dict.fromkeys(W.KERNELS, 0)
    assert {"sensitivity", "extra_calls", "precision", "input",
            "extra_classification", "extras_gatk_concordant", "pass_rule",
            "precision_pass"} <= res["htc"].keys()
    assert res["htc"]["input"] == "recal"
    assert res["htc"]["pairhmm_call_sizes"]["pairs"] > 0
    assert res["htc"]["sensitivity"] > 0.5
    assert res["germline_e2e_reads_per_s"] > 0
    assert (res["genome_mb"], res["pairs"], res["card"]) == (
        GENOME_MB, W.scale(GENOME_MB)[1], "cpu")


def _same(work_a: Path, work_b: Path, artifact: str) -> None:
    out_a, out_b = W.outputs(work_a), W.outputs(work_b)
    if artifact in ("buckets", "recal"):
        parts = sorted(p.name for p in Path(out_a[artifact]).glob(
            "part-*.bam"))
        assert parts and parts == sorted(
            p.name for p in Path(out_b[artifact]).glob("part-*.bam"))
        for name in parts:
            d = compare_bam(str(Path(out_a[artifact]) / name),
                            str(Path(out_b[artifact]) / name),
                            compare_tags=True)
            assert d.equivalent, (name, d)
    elif artifact == "dedup":
        d = compare_bam(out_a["dedup"], out_b["dedup"], compare_tags=True)
        assert d.equivalent and d.matching > 1000, d
    elif artifact == "recal_table":
        a = np.load(str(work_a / "recal.recal.npz"))
        b = np.load(str(work_b / "recal.recal.npz"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["qual_obs"].sum() > 0
    else:
        c = compare_vcf(out_a["vcf"], out_b["vcf"])
        assert c.equivalent and c.concordant > 0, c
        # every field of every record, PL and GQ included
        assert assert_vcf_records_equal(out_a["vcf"], out_b["vcf"]) == \
            c.concordant


ARTIFACTS = ["buckets", "dedup", "recal_table", "recal", "vcf"]


@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_out_of_core_chain_matches_jax(chains, artifact):
    _same(chains["port_ooc"][0], chains["jax_ooc"][0], artifact)


@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_out_of_core_chain_matches_in_memory(chains, artifact):
    _same(chains["port_ooc"][0], chains["port_mem"][0], artifact)


def test_classify_extras_matches_jax_script(chains):
    """On the recalibrated tree: the planted SNPs (GATK's likelihood
    forces them), sites without an alt read and sites whose only alt
    reads are sequencing errors."""
    work = chains["port_ooc"][0]
    truth = np.load(work / "truth.npy")
    others = np.setdiff1d(np.arange(1000, 7000, 31), truth)
    pos = set(truth.tolist()) | set(others.tolist())
    args = (pos, W.outputs(work)["recal"], str(work / "ref.fa"))
    got = W.classify_extras(*args)
    assert got == jax_classify_extras()(*args)
    forced = [c["gatk_forced"] for c in got]
    assert len(got) == len(pos) and any(forced) and not all(forced)
    assert any("n_alt" in c and not c["gatk_forced"] for c in got)
