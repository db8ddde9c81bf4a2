"""Kernel build and dispatch rules of the port, its isolation from the
JAX package, and the state converters.

The CUDA sources are built with nvcc at first use; without nvcc the build
raises (no fallback).  A wrapper runs the plain version only for CPU
tensors and refuses any other non-CUDA device.  The port and
``chip_smoke.py`` import neither ``jax`` nor ``falcon_genome_tpu``.
``convert`` carries the reference's parameter dataclasses, arrays and
host objects over field by field."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu.aligner import AlignerParams as JAlignerParams
from falcon_genome_tpu.bqsr import RecalTable as JRecalTable
from falcon_genome_tpu.models.haplotypecaller import HTCParams as JHTCParams
from falcon_genome_tpu.ops.pairhmm import PairHMMParams as JPairHMMParams
from falcon_genome_tpu.ops.smith_waterman import (
    PairPolicy as JPairPolicy, SWBucket as JSWBucket)
import falcon_genome_tpu_torch
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.ops import (
    _build, bench_kernels, pairhmm, smith_waterman)
from falcon_genome_tpu_torch.ops.sw_ref import SWParams

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = Path(falcon_genome_tpu_torch.__file__).resolve().parent
BLOCKED = ("jax", "jaxlib", "falcon_genome_tpu")


def test_kernel_sources_present():
    for name in _build.SOURCES:
        src = (_build.CSRC / name).read_text()
        assert "sm_90a" in src and 'extern "C"' in src
    exported = "".join((_build.CSRC / n).read_text() for n in _build.SOURCES)
    for entry in _build.SIGNATURES:
        assert f"int {entry}(" in exported


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load()
    assert not (tmp_path / "build").exists()


def test_build_flags_per_source(monkeypatch, tmp_path):
    """One nvcc per source: only PairHMM's carries -ftz=true and
    --fmad=false (the FMA ceiling keeps nvcc's contraction), and the
    per-source flags enter the library's digest."""
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
        "done\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    so = _build.build()
    assert so.exists()
    lines = log.read_text().splitlines()
    compiles = {Path(ln.split()[-1]).name: ln for ln in lines if " -c " in ln}
    assert sorted(compiles) == sorted(_build.SOURCES)
    for src, ln in compiles.items():
        extra = "-ftz=true" in ln and "--fmad=false" in ln
        assert extra == (src == "pairhmm.cu"), ln
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {})
    assert _build.library_path() != so


@pytest.mark.parametrize("op", ["sw_score", "sw_full", "pairhmm",
                                "pairhmm_pb", "fma_ceiling",
                                "sw_score_ablate"])
def test_wrappers_refuse_non_cuda_devices(op):
    meta = torch.device("meta")
    if op == "fma_ceiling":
        with pytest.raises(ValueError, match="no FMA-ceiling kernel"):
            bench_kernels.fma_ceiling(
                torch.ones((8, 4), device=meta), 272)
        return
    if op == "pairhmm":
        t = [torch.zeros((4, 8), dtype=torch.uint8, device=meta)] * 2 + [
            torch.zeros(4, dtype=torch.int32, device=meta),
            torch.zeros((4, 16), dtype=torch.uint8, device=meta),
            torch.zeros(4, dtype=torch.int32, device=meta)]
        with pytest.raises(ValueError, match="no PairHMM kernel"):
            pairhmm.pairhmm_sc(*t, 45, 45, 10)
        return
    if op == "pairhmm_pb":
        t = [torch.zeros((4, 8), dtype=torch.uint8, device=meta)] * 5 + [
            torch.zeros(4, dtype=torch.int32, device=meta),
            torch.zeros((4, 16), dtype=torch.uint8, device=meta),
            torch.zeros(4, dtype=torch.int32, device=meta)]
        with pytest.raises(ValueError, match="no PairHMM kernel"):
            pairhmm.pairhmm_pb(*t)
        return
    read = torch.zeros((4, 8), dtype=torch.int8, device=meta)
    lens = torch.zeros(4, dtype=torch.int32, device=meta)
    win = torch.zeros((4, 16), dtype=torch.int8, device=meta)
    if op == "sw_score_ablate":
        fn = bench_kernels.sw_score_ablate
    else:
        fn = getattr(smith_waterman, op)
    extra = (100,) if op == "sw_full" else ()
    with pytest.raises(ValueError, match="no Smith-Waterman kernel"):
        fn(read, lens, win, lens, SWParams(), *extra)


def test_convert_parameter_dataclasses():
    cpu = torch.device("cpu")
    jb = JSWBucket(max_read_len=64, max_win_len=96, backend="jax")
    assert convert.sw_bucket(jb, cpu) == smith_waterman.SWBucket(64, 96, cpu)
    jp = JPairHMMParams(max_read_len=40, max_hap_len=128, backend="jax")
    assert convert.pairhmm_params(jp, cpu) == pairhmm.PairHMMParams(
        40, 128, cpu)
    assert dataclasses.asdict(convert.pair_policy(JPairPolicy(
        max_insert=700))) == dataclasses.asdict(JPairPolicy(max_insert=700))
    ja = JAlignerParams(max_candidates=3, rescue_window=512)
    ta = convert.aligner_params(ja)
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    jh = JHTCParams(gcp=12, emit_gvcf=True, min_call_qual=20.0)
    th = convert.htc_params(jh, cpu)
    want = dataclasses.asdict(jh)
    del want["pairhmm"]
    got = dataclasses.asdict(th)
    assert got.pop("device") == cpu
    assert got == want


def test_convert_arrays():
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 5, 300).astype(np.uint8)
    g = convert.genome_tensor(genome, cpu)
    assert g.dtype == torch.int8 and np.array_equal(g.numpy(), genome)
    reads = rng.integers(0, 5, (6, 32)).astype(np.uint8)
    r = convert.read_table(reads, cpu)
    assert r.shape == (6, 32) and np.array_equal(r.numpy(), reads)
    jt = JRecalTable.zeros(["rg0", "rg1"])
    jt.qual_obs[1, 30] = 7.0
    jt.cycle_err[0, 20, 5] = 2.0
    tt = convert.recal_table(jt)
    assert tt.read_groups == ["rg0", "rg1"]
    ten = convert.recal_tensors(tt, cpu)
    for f in ("qual_obs", "qual_err", "cycle_obs", "cycle_err", "ctx_obs",
              "ctx_err"):
        assert np.array_equal(ten[f].numpy(), getattr(jt, f))


def _imported_tops(path: Path) -> set[str]:
    """Top-level names of the absolute imports in a source file."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` imports neither ``jax`` nor
    ``falcon_genome_tpu``, only the port."""
    top = _imported_tops(REPO / "chip_smoke.py")
    assert "falcon_genome_tpu_torch" in top
    assert not top & set(BLOCKED), sorted(top)


PORT_SOURCES = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_port_sources_import_nothing_of_jax(rel):
    """No file of the package names ``jax``, ``jaxlib`` or
    ``falcon_genome_tpu`` in an import (the golden models
    ``ops/pairhmm_ref.py`` and ``ops/sw_ref.py`` among them)."""
    assert {"ops/pairhmm_ref.py", "ops/sw_ref.py"} <= set(PORT_SOURCES)
    assert not _imported_tops(PKG / rel) & set(BLOCKED)


# Refuses jax, jaxlib and falcon_genome_tpu, imports every module of the
# port and chip_smoke.py, runs the CLI's help, the bench's argument
# parsing, the two golden models and the memory probe's ``--watch`` around
# a child, and checks that none of the refused names was imported.
_ISOLATED = r"""
import importlib, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "falcon_genome_tpu")

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is refused in this process")
        return None

sys.meta_path.insert(0, _Refuse())
import falcon_genome_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from falcon_genome_tpu_torch import bench, cli
assert cli.main(["--device", "cpu", "--help"]) == 0
assert bench.build_parser().parse_args(["--work", "w"]).work == "w"
import numpy as np
from falcon_genome_tpu_torch.ops import pairhmm_logp_ref
from falcon_genome_tpu_torch.ops.sw_ref import sw_align_ref
codes = np.array([[0, 1, 2, 3]], np.uint8)
q = np.full((1, 4), 30, np.uint8)
n4 = np.array([4], np.int32)
assert np.isfinite(pairhmm_logp_ref(codes, q, q, q, q, n4, codes, n4)).all()
assert sw_align_ref(codes[0], codes[0]).score == 4
from falcon_genome_tpu_torch.benchmarks import rss_probe
assert rss_probe.main(["--watch", "--period", "0.05", "--", sys.executable,
                       "-c", "raise SystemExit(5)"]) == 5
leaked = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("MODULES", " ".join(names))
print("ISOLATED", len(names))
"""


def test_port_runs_with_jax_and_the_jax_package_refused():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _ISOLATED, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n = int(res.stdout.split("ISOLATED")[1])
    assert n == len([p for p in PKG.rglob("*.py")
                     if p.name != "__init__.py" or p.parent != PKG])
    imported = res.stdout.split("MODULES")[1].split("ISOLATED")[0].split()
    for name in ("ops.pairhmm_ref", "ops.sw_ref", "bamops", "bqsr",
                 "aligner"):
        assert f"falcon_genome_tpu_torch.{name}" in imported, name


def _device_defaults() -> dict[str, object]:
    """Every default of a ``device`` parameter of a public function or
    method, or of a dataclass field, in the port, by qualified name."""
    import importlib
    import inspect
    import pkgutil
    found = {}
    for m in pkgutil.walk_packages(falcon_genome_tpu_torch.__path__,
                                   "falcon_genome_tpu_torch."):
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [(name, obj)]
            if inspect.isclass(obj):
                if dataclasses.is_dataclass(obj):
                    for f in dataclasses.fields(obj):
                        if f.name == "device":
                            found[f"{m.name}.{name}"] = f.default
                    continue
                fns = [(f"{name}.{k}", v) for k, v in vars(obj).items()
                       if inspect.isfunction(v)]
            for qual, fn in fns:
                leaf = qual.split(".")[-1]
                if not callable(fn) or (leaf.startswith("_")
                                        and leaf != "__init__"):
                    continue
                try:
                    par = inspect.signature(fn).parameters.get("device")
                except (TypeError, ValueError):
                    continue
                if par is not None and par.default is not par.empty:
                    found[f"{m.name}.{qual}"] = par.default
    return found


def test_entry_points_default_to_the_card(tmp_path):
    """Every dataclass and ``run_*`` (and every other signature) of the
    port that takes a device defaults to the card.  Without a card a call
    that takes the default raises, writes no output and never runs the
    plain versions."""
    from falcon_genome_tpu_torch.device import DEFAULT_DEVICE
    defaults = _device_defaults()
    for name in ("ops.smith_waterman.SWBucket", "ops.pairhmm.PairHMMParams",
                 "models.haplotypecaller.HTCParams",
                 "models.mutect2.Mutect2Params", "stages.align.run_align",
                 "stages.calling.run_htc", "stages.calling.run_mutect2",
                 "stages.germline.run_germline",
                 "aligner.AlignerEngine.__init__",
                 "models.haplotypecaller.read_hap_likelihood_matrix",
                 "longread.LongReadAligner.__init__",
                 "stages.indel.run_indel"):
        assert f"falcon_genome_tpu_torch.{name}" in defaults, name
    assert DEFAULT_DEVICE == torch.device("cuda")
    wrong = {k: v for k, v in defaults.items() if v != DEFAULT_DEVICE}
    assert not wrong, wrong
    # the window-gather entry takes its device from its bucket
    import inspect
    bucket = inspect.signature(
        smith_waterman.sw_extend_win_dispatch).parameters["bucket"]
    assert bucket.default.device == DEFAULT_DEVICE
    if torch.cuda.is_available():
        return
    from falcon_genome_tpu_torch.config import Config, Machine
    from falcon_genome_tpu_torch.device import DeviceUnavailable
    from falcon_genome_tpu_torch.io.bam import write_bam
    from falcon_genome_tpu_torch.io.dna import decode_seq
    from falcon_genome_tpu_torch.io.fasta import write_fasta
    from falcon_genome_tpu_torch.io.sam import (
        SamHeader, SamRecord, cigar_from_str)
    from falcon_genome_tpu_torch.stages import run_htc
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, 2000).astype(np.uint8)
    write_fasta(tmp_path / "ref.fa", {"chr1": decode_seq(ref)})
    recs = [SamRecord(f"r{i}", 0, 0, p, 60, cigar_from_str("100M"),
                      seq=decode_seq(ref[p:p + 100]), qual="I" * 100)
            for i, p in enumerate(range(0, 1900, 10))]
    write_bam(tmp_path / "in.bam", SamHeader(contigs=[("chr1", 2000)]),
              recs)
    conf = Config(machine=Machine(2, 4), environ={}, load_files=False)
    conf.set("log_dir", str(tmp_path / "log"))
    out = tmp_path / "calls.vcf"
    before = {p.name for p in tmp_path.iterdir()}
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        run_htc(conf, str(tmp_path / "ref.fa"), str(tmp_path / "in.bam"),
                str(out), produce_vcf=True)
    assert not out.exists()
    assert {p.name for p in tmp_path.iterdir()} == before
    # below the stages: a bucket or parameter set left at its default
    # puts its first tensor on the card, which raises here
    reads = rng.integers(0, 4, (4, 64)).astype(np.uint8)
    lens = np.full(4, 64, np.int32)
    with pytest.raises((RuntimeError, AssertionError)):
        smith_waterman.sw_extend_batch(reads, lens, reads, lens,
                                       SWParams(), smith_waterman.SWBucket())
    with pytest.raises((RuntimeError, AssertionError)):
        pairhmm.pairhmm_logp(reads, np.full((4, 64), 30, np.uint8), 45, 45,
                             10, lens, reads, lens)
    from falcon_genome_tpu_torch.aligner import IndexParams, MinimizerIndex
    from falcon_genome_tpu_torch.longread import LongReadAligner
    from falcon_genome_tpu_torch.stages import run_indel
    idx = MinimizerIndex([("chr1", ref)], IndexParams(k=19, w=10))
    with pytest.raises((RuntimeError, AssertionError)):
        LongReadAligner(idx).align_batch([ref[100:1100]])
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        run_indel(conf, str(tmp_path / "ref.fa"), str(tmp_path / "in.bam"),
                  str(tmp_path / "out.bam"))
    assert {p.name for p in tmp_path.iterdir()} == before
