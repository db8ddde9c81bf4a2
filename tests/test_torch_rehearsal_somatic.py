"""The port's mutect2 rehearsal (``falcon_genome_tpu_torch/benchmarks/
mutect2_rehearsal.py``) on the CPU, against the JAX script.

Both scripts run their ``main`` at 20 kb (25x of 150 bp a sample, 4
somatic SNVs, 8 germline hets), the JAX one with its results file moved
into the test's directory.  The dataset (``ref.fa``, ``tumor.bam``,
``normal.bam``, their ``.bai`` and ``somatic.npy``) is byte-equal, the
somatic VCF record-equal, and the row carries the JAX script's keys.  The
port builds each chunk's records from arrays (``chunk_columns``): equal
to ``RecordColumns.from_records`` of the JAX script's ``SamRecord``s."""
import importlib.util
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu.io import native_ext
from falcon_genome_tpu.io.columns import RecordColumns
from falcon_genome_tpu.io.dna import decode_seq
from falcon_genome_tpu.io.sam import SamRecord, cigar_from_str
from falcon_genome_tpu.io.vcf import read_vcf
from falcon_genome_tpu.utils.compare import compare_vcf
from falcon_genome_tpu_torch.benchmarks import mutect2_rehearsal as M

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "benchmarks" / "mutect2_rehearsal.py"
SIZES = {"G": 20_000, "N_SOMATIC": 4, "N_GERMLINE": 8}
DATASET = ("ref.fa", "tumor.bam", "tumor.bam.bai", "normal.bam",
           "normal.bam.bai", "somatic.npy")
# the JAX script's row (benchmarks/mutect2_rehearsal.py:153-161)
JAX_KEYS = {"wall_s", "peak_rss_gb", "reads_per_s", "genome_mb",
            "somatic_sensitivity", "extra_calls", "precision"}

pytestmark = pytest.mark.skipif(
    not native_ext.available(),
    reason="the BAM writer needs the native library")


def load_jax_script(path: Path, name: str):
    """A root script as a module, the root logger left as it was."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("m2_rehearsal")
    jax_mod = load_jax_script(JAX_SCRIPT, "jax_mutect2_rehearsal")
    # the JAX main writes its row beside ``__file__``: keep it here
    jax_mod.__file__ = str(root / "jax_script" / JAX_SCRIPT.name)
    (root / "jax_script").mkdir()
    saved = {k: getattr(M, k) for k in SIZES}
    argv, handlers = sys.argv, list(logging.getLogger().handlers)
    try:
        for mod in (M, jax_mod):
            for k, v in SIZES.items():
                setattr(mod, k, v)
        assert M.main([str(root / "port"), "--device", "cpu",
                       "--out", str(root / "port.json")]) == 0
        sys.argv = [str(JAX_SCRIPT), str(root / "jax")]
        jax_mod.main()
    finally:
        sys.argv = argv
        logging.getLogger().handlers[:] = handlers
        for k, v in saved.items():
            setattr(M, k, v)
    return {"port": root / "port", "jax": root / "jax",
            "port_row": json.loads((root / "port.json").read_text()),
            "jax_row": json.loads((root / "jax_script" /
                                   "wgs_rehearsal.json").read_text())}


@pytest.mark.parametrize("name", DATASET)
def test_dataset_equals_jax_script(runs, name):
    got = (runs["port"] / name).read_bytes()
    assert got == (runs["jax"] / name).read_bytes()
    assert len(got) > 0


def test_somatic_vcf_equals_jax_script(runs):
    a, b = (str(runs[k] / "somatic.vcf.gz") for k in ("jax", "port"))
    _, want = read_vcf(a)
    _, got = read_vcf(b)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    c = compare_vcf(a, b)
    assert c.equivalent and c.concordant == len(want) >= SIZES["N_SOMATIC"]


def test_row_carries_the_jax_script_keys(runs):
    row, want = runs["port_row"]["mutect2"], runs["jax_row"]["mutect2"]
    assert JAX_KEYS <= row.keys() and set(want) == JAX_KEYS
    for k in ("somatic_sensitivity", "extra_calls", "precision"):
        assert row[k] == want[k], k
    assert row["somatic_sensitivity"] >= 0.75
    assert row["genome_mb"] == SIZES["G"] / 1e6
    assert (row["card"], row["peak_device_gb"]) == ("cpu", None)
    assert row["launches"] == dict.fromkeys(
        ("fgt_sw_score", "fgt_sw_full", "fgt_sw_traceback", "fgt_pairhmm"),
        0)
    sizes = row["pairhmm_call_sizes"]
    assert sizes["pairs"] > 0 and sum(sizes["calls"].values()) > 0


@pytest.mark.parametrize("first", [0, 7])
def test_chunk_columns_equal_from_records(first):
    """What the JAX script makes of a chunk's ``SamRecord``s, field by
    field, and as the bytes the BAM encoder writes."""
    rng = np.random.default_rng(first)
    starts = np.sort(rng.integers(0, 10_000, 33))
    seqs = rng.integers(0, 4, (33, M.READ_LEN)).astype(np.uint8)
    recs = [SamRecord(f"TUMOR{first + i}", 0x10 * (i % 2), 0,
                      int(starts[i]), 60, cigar_from_str(f"{M.READ_LEN}M"),
                      seq=decode_seq(seqs[i]), qual=M.QUAL_CHR * M.READ_LEN)
            for i in range(len(starts))]
    for r in recs:
        r.set_tag("RG", "Z", "rg-TUMOR")
    want = RecordColumns.from_records(recs)
    got = M.chunk_columns("TUMOR", first, starts, seqs)
    for f in ("fixed", "names", "name_off", "cigar_ops", "cigar_lens",
              "cig_off", "seq", "qual", "seq_off", "tags", "tag_off",
              "tag_len"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.seq_mode, got.qual_mode) == (want.seq_mode, want.qual_mode)
    assert bytes(got.encode()) == bytes(want.encode())
