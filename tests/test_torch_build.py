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


@pytest.mark.parametrize("rel", sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_port_sources_import_nothing_of_jax(rel):
    """No file of the package names ``jax``, ``jaxlib`` or
    ``falcon_genome_tpu`` in an import."""
    assert not _imported_tops(PKG / rel) & set(BLOCKED)


# Refuses jax, jaxlib and falcon_genome_tpu, imports every module of the
# port and chip_smoke.py, runs the CLI's help and the bench's argument
# parsing, and checks that none of the refused names was imported.
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
leaked = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
assert not leaked, leaked
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
