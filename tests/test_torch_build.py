"""Kernel build and dispatch rules of the port, and the state converters.

The CUDA sources are built with nvcc at first use; without nvcc the build
raises (no fallback).  A wrapper runs the plain version only for CPU
tensors and refuses any other non-CUDA device.  ``convert`` carries the
reference's parameter dataclasses and arrays over field by field."""
import dataclasses

import numpy as np
import pytest
import torch

from falcon_genome_tpu.aligner import AlignerParams as JAlignerParams
from falcon_genome_tpu.bqsr import RecalTable as JRecalTable
from falcon_genome_tpu.models.haplotypecaller import HTCParams as JHTCParams
from falcon_genome_tpu.ops.pairhmm import PairHMMParams as JPairHMMParams
from falcon_genome_tpu.ops.smith_waterman import (
    PairPolicy as JPairPolicy, SWBucket as JSWBucket)
from falcon_genome_tpu_torch import convert
from falcon_genome_tpu_torch.ops import _build, pairhmm, smith_waterman
from falcon_genome_tpu_torch.ops.sw_ref import SWParams

torch.set_num_threads(1)


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


@pytest.mark.parametrize("op", ["sw_score", "sw_full", "pairhmm",
                                "pairhmm_pb"])
def test_wrappers_refuse_non_cuda_devices(op):
    meta = torch.device("meta")
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


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` reaches the reference's host modules only through
    the port: it imports neither ``jax`` nor ``falcon_genome_tpu``."""
    import ast
    from pathlib import Path
    src = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    names = []
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    top = {n.split(".")[0] for n in names}
    assert "falcon_genome_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "falcon_genome_tpu"}, sorted(top)
