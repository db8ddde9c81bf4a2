"""The port's copies of the root ``benchmarks/`` scripts of the germline
path, each through its ``main`` at a tiny size on the CPU: exit 0 and a
result row with the JAX script's quantities (``germline_cmd``,
``profile_align``, ``profile_htc``, ``bench_align``, ``bench_germline``,
``markdup_scale``).  ``markdup_scale`` must find exactly the planted
duplicates, with flags equal to the in-memory path's.  Every script's
``--device cuda`` raises without a card, also those of the somatic,
mesh, long-read, indel and joint-cohort rehearsals and the two
Smith-Waterman bench scripts (``tests/test_torch_rehearsal_somatic.py``
and ``tests/test_torch_rehearsal_rest.py`` run them)."""
import importlib
import json

import pytest
import torch

from falcon_genome_tpu_torch.benchmarks import (
    bench_align, bench_germline, germline_cmd, markdup_scale, profile_align,
    profile_htc, wgs_rehearsal as W)
from falcon_genome_tpu_torch.device import DeviceUnavailable
from falcon_genome_tpu_torch.io import native_ext

torch.set_num_threads(1)

GENOME_MB = 0.008
OPTIONS = ["-O", "gatk.ncontigs=4", "-O", "gatk.nprocs=2"]
OUT_OF_CORE = ["-O", "tpu.align.spill_mb=0", "-O", "tpu.bam.stream_mb=0"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The rehearsal's dataset at 8 kb / 666 pairs."""
    work = tmp_path_factory.mktemp("scripts_work")
    saved = (W.G, W.N_PAIRS, W.N_SNPS)
    try:
        W.G, W.N_PAIRS, W.N_SNPS = W.scale(GENOME_MB)
        W.gen_dataset(work)
    finally:
        W.G, W.N_PAIRS, W.N_SNPS = saved
    return work


def last_row(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.skipif(not native_ext.available(),
                    reason="the out-of-core paths need the native library")
def test_germline_cmd(work, tmp_path, capsys):
    """The one-command ``germline`` forced out of core: its row, the
    paths it took and its accuracy."""
    out = tmp_path / "res.json"
    assert germline_cmd.main([str(work), "--device", "cpu", "--out",
                              str(out), *OPTIONS, *OUT_OF_CORE]) == 0
    row = last_row(capsys)
    assert row == json.loads(out.read_text())["germline_cmd"]
    assert {"wall_s", "peak_rss_gb", "reads_per_s", "sensitivity",
            "extra_calls", "precision"} <= row.keys()
    assert row["path"] == {"align": "bucket spill", "markdup": "streamed",
                           "bqsr": "stream", "htc": "tree"}
    assert row["sensitivity"] > 0.5 and row["precision"] > 0.5
    assert (row["peak_device_gb"], row["card"]) == (None, "cpu")


def test_profile_align(work, capsys):
    assert profile_align.main([str(work), "--batches", "2", "--batch", "128",
                               "--device", "cpu"]) == 0
    row = last_row(capsys)
    assert row["reads"] == 2 * 2 * 128 and row["reads_per_s"] > 0
    assert set(row["phases_s"]) == {
        "fastq_decode", "seed+chain+jobs", "ship_reads",
        "sw_score+pair+extend+traceback", "collect(NM,mapq,rescue)",
        "emit_columns"}


def test_profile_htc(tmp_path, capsys):
    pst = tmp_path / "htc.pstats"
    assert profile_htc.main(["--genome-mb", "0.02", "--device", "cpu",
                             "--pstats", str(pst)]) == 0
    row = last_row(capsys)
    assert pst.stat().st_size > 0
    assert row["reads"] == len(range(0, 20_000 - 150, 10))
    assert row["snps"] == 20 and row["tp"] >= 18
    assert row["call_interval_s"] > 0 and len(row["top_own_s"]) == 15


def test_bench_align(capsys):
    assert bench_align.main(["--genome-mb", "0.05", "--reads", "200",
                             "--device", "cpu"]) == 0
    row = last_row(capsys)
    assert {"index_build_s", "entries", "align_s", "reads_per_s",
            "mapped"} <= row.keys()
    assert row["reads"] == 200 and row["mapped"] > 0.9


def test_bench_germline(capsys):
    assert bench_germline.main(["--genome-mb", "0.008", "--device",
                                "cpu"]) == 0
    row = last_row(capsys)
    assert {"wall_s", "reads_per_s", "tp", "snps", "extra_calls"} <= \
        row.keys()
    assert row["snps"] == 4 and row["tp"] >= 3


@pytest.mark.skipif(not native_ext.available(),
                    reason="the streamed markdup needs the native library")
def test_markdup_scale_exact(tmp_path, capsys):
    assert markdup_scale.main(["--records", "20000", "--check-memory",
                               "--out", str(tmp_path / "md")]) == 0
    row = last_row(capsys)
    assert row["records"] == 20000
    assert row["ndup"] == row["ndup_expected"] == row["in_memory_ndup"] > 0
    assert row["dup_exact"] and row["flags_equal"]
    assert not (tmp_path / "md").exists()          # removed without --keep


@pytest.mark.parametrize("script, argv", [
    ("wgs_rehearsal", ["{tmp}/w", "--out", "{tmp}/r.json"]),
    ("germline_cmd", ["{tmp}/w", "--out", "{tmp}/r.json"]),
    ("profile_align", ["{tmp}/w"]),
    ("profile_htc", ["--genome-mb", "0.01", "--pstats", "{tmp}/h.pstats"]),
    ("bench_align", ["--genome-mb", "0.01"]),
    ("bench_germline", ["--genome-mb", "0.01"]),
    ("mutect2_rehearsal", ["{tmp}/w", "--out", "{tmp}/r.json"]),
    ("mesh_rehearsal", ["{tmp}/w", "--out", "{tmp}/m.json"]),
    ("longread_rehearsal", ["{tmp}/w", "--out", "{tmp}/r.json"]),
    ("bench_longread", ["4", "3000"]),
    ("bench_sw_parts", ["64"]),
    ("indel_rehearsal", ["{tmp}/w", "--out", "{tmp}/r.json"]),
    ("joint_cohort", ["{tmp}/w", "3", "--out", "{tmp}/r.json"]),
])
def test_cuda_without_card_raises(script, argv, tmp_path):
    """No fallback to the CPU: ``--device cuda`` without a card raises
    before any work or output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    main = importlib.import_module(
        f"falcon_genome_tpu_torch.benchmarks.{script}").main
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    with pytest.raises(DeviceUnavailable):
        main([*argv, "--device", "cuda"])
    assert list(tmp_path.iterdir()) == []
