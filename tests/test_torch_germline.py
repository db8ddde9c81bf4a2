"""The ported slice end to end: ``germline`` (align → markdup → bqsr →
htc) through the port against the reference's ``run_germline`` on the
reference's e2e world, the port's CLI in a process where JAX cannot be
imported, and the CLI's device and exit-code policy."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_genome_tpu import stages as jstages
from falcon_genome_tpu.config import Config, Machine
from falcon_genome_tpu.io.dna import decode_seq, revcomp_codes
from falcon_genome_tpu.io.fasta import write_fasta
from falcon_genome_tpu.io.fastq import write_fastq
from falcon_genome_tpu.utils.compare import compare_bam, compare_vcf
from falcon_genome_tpu_torch import cli, convert, stages as tstages
from falcon_genome_tpu_torch.device import DeviceUnavailable, resolve_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def conf():
    c = Config(machine=Machine(8, 16), environ={}, load_files=False)
    c.set("gatk.ncontigs", 4)
    c.set("gatk.nprocs", 2)
    c.set("bwa.num_buckets", 8)
    return c


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference e2e world (tests/test_pipeline_e2e.py): two contigs,
    a het SNP and a hom SNP, 100 bp pairs every 9 bp."""
    tmp = tmp_path_factory.mktemp("torch_e2e")
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
    return dict(tmp=tmp, ref=str(tmp / "ref.fa"),
                fq1=str(tmp / "reads_1.fastq.gz"),
                fq2=str(tmp / "reads_2.fastq.gz"))


def _parts(d: Path) -> list[str]:
    return sorted(p.name for p in d.glob("part-*.bam"))


def test_germline_matches_reference(world, conf):
    out = {}
    for name, run, c, extra in (
            ("ref", jstages.run_germline, conf, {}),
            ("port", tstages.run_germline, convert.config(conf),
             {"device": torch.device("cpu")})):
        vcf = world["tmp"] / f"{name}.vcf.gz"
        run(c, world["ref"], str(vcf), fastq1=world["fq1"],
            fastq2=world["fq2"], sample_id="s1", produce_vcf=True,
            force=True, **extra)
        out[name] = (vcf, Path(str(vcf) + ".work"))
    (rv, rw), (pv, pw) = out["ref"], out["port"]
    for sub in ("aligned", "recal"):
        assert _parts(rw / sub) == _parts(pw / sub) != []
        for part in _parts(rw / sub):
            d = compare_bam(str(rw / sub / part), str(pw / sub / part),
                            compare_tags=True)
            assert d.equivalent, (sub, part, d)
    d = compare_bam(str(rw / "dedup.bam"), str(pw / "dedup.bam"),
                    compare_tags=True)
    assert d.equivalent and d.matching > 1000
    c = compare_vcf(str(rv), str(pv))
    assert c.equivalent and c.concordant == 2
    # the port's own copy of the gates gives the same verdicts
    from falcon_genome_tpu_torch.utils import compare as tcompare
    td = tcompare.compare_bam(str(rw / "dedup.bam"), str(pw / "dedup.bam"),
                              compare_tags=True)
    assert td.equivalent and td.matching == d.matching
    tc = tcompare.compare_vcf(str(rv), str(pv))
    assert tc.equivalent and tc.concordant == c.concordant


# Blocks every import of jax, then imports each module of the port and
# runs its CLI germline on the CPU.
_NO_JAX = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, _Block())
import falcon_genome_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from falcon_genome_tpu_torch import cli
rc = cli.main(sys.argv[1:])
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
sys.exit(rc)
"""


def test_cli_germline_runs_without_jax(world, tmp_path):
    out = tmp_path / "nojax.vcf.gz"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "--device", "cpu", "germline",
         "-r", world["ref"], "-1", world["fq1"], "-2", world["fq2"],
         "-o", str(out), "-v", "-f", "-O", "gatk.ncontigs=2",
         "-O", "bwa.num_buckets=4"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert out.exists()


def test_cuda_device_without_card_is_an_error(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        resolve_device("cuda")
    rc = cli.main(["--device", "cuda", "germline", "-r", world["ref"],
                   "-1", world["fq1"], "-2", world["fq2"],
                   "-o", str(tmp_path / "x.vcf.gz")])
    assert rc == 1
    assert not (tmp_path / "x.vcf.gz").exists()


# the reference's exit codes: a missing reference FASTA (3), a GATK
# walker whose translated arguments its subcommand's parser refuses
# (argparse's 2, raised as SystemExit as the reference does), an unknown
# command (1), help (0); every command's codes are held to the
# reference's in tests/test_torch_vcfstages.py
@pytest.mark.parametrize("argv,rc", [
    (["--device", "cpu", "indel", "-r", "x", "-o", "y", "-i", "z"], 3),
    (["gatk", "-T", "HaplotypeCaller"], 2),
    (["no_such_command"], 1),
    (["--device", "cpu", "--help"], 0),
])
def test_cli_exit_codes(argv, rc, capsys):
    try:
        got = cli.main(argv)
    except SystemExit as e:
        got = e.code
    assert got == rc
