"""The port's host-memory probe and the repairs of its host memory, on the
CPU.

* ``benchmarks/rss_probe.py``: the ``/proc/self/status`` reader (VmRSS is
  the sum of its anonymous, file and shared parts), glibc's
  ``mallinfo2()`` (a block above the mmap threshold shows as mapped and
  leaves with its free), the snapshot, the split at a peak and a stage's
  row, and the probe's steps and ``--cli`` mode at a tiny size;
* ``wgs_rehearsal.Measured``: rows carry ``peak_rss_anon_gb`` and
  ``peak_rss_file_gb`` beside ``peak_rss_gb``, still the peak of VmRSS;
* a run that launches no kernel opens no CUDA context: ``resolve_device``
  brings CUDA up for no one, and ``bqsr``, ``baserecal`` and ``ug`` with
  ``--device cuda``, and ``joint_cohort --device cuda``, make no CUDA call
  that would (``torch.cuda`` patched to count, a card pretended), while
  ``--device cuda`` without a card still exits 1;
* ``indel``'s genomes on the device are shipped once a contig under
  eight runner threads, and its records equal a one-thread run's; a
  FASTA contig asked for by eight threads at once is decoded once;
* on a kernel whose ``/proc/self/status`` lacks ``RssAnon`` and
  ``RssFile`` the split comes from ``/proc/self/smaps``, or is None.
"""
import json
import time

import numpy as np
import pytest
import torch

from falcon_genome_tpu_torch import cli as tcli
from falcon_genome_tpu_torch.benchmarks import joint_cohort, rss_probe
from falcon_genome_tpu_torch.benchmarks.wgs_rehearsal import Measured
from falcon_genome_tpu_torch.config import Config, Machine
from falcon_genome_tpu_torch.device import resolve_device
from falcon_genome_tpu_torch.io.bam import read_bam, write_bam
from falcon_genome_tpu_torch.io.dna import decode_seq
from falcon_genome_tpu_torch.io.fasta import write_fasta
from falcon_genome_tpu_torch.io.sam import SamHeader, SamRecord, cigar_from_str
from falcon_genome_tpu_torch.stages import indel as TI

CPU = torch.device("cpu")

STATUS = """Name:\tpython
VmHWM:\t  812345 kB
VmRSS:\t  700000 kB
RssAnon:\t  500000 kB
RssFile:\t  190000 kB
RssShmem:\t   10000 kB
Threads:\t17
"""


# ---- the probe's readers ---------------------------------------------------

def test_proc_status_parses_the_fields():
    assert rss_probe.proc_status(STATUS) == {
        "VmHWM": 812345, "VmRSS": 700000, "RssAnon": 500000,
        "RssFile": 190000, "RssShmem": 10000, "Threads": 17}


def test_proc_status_of_this_process_sums():
    """The kernel's VmRSS is its three parts' sum, read at once."""
    st = rss_probe.proc_status()
    assert set(rss_probe.STATUS_KEYS) <= st.keys()
    assert st["VmRSS"] == st["RssAnon"] + st["RssFile"] + st["RssShmem"]
    assert st["VmHWM"] >= st["VmRSS"] > 0 and st["Threads"] >= 1


def test_mallinfo_counts_a_block_mapped_on_its_own():
    """64 MiB is above glibc's largest mmap threshold: the block counts in
    ``hblkhd`` while it lives and leaves it when freed."""
    m0 = rss_probe.mallinfo()
    assert m0 is not None and set(m0) == set(rss_probe.MALLINFO2_FIELDS)
    a = np.ones(64 << 20, np.uint8)
    m1 = rss_probe.mallinfo()
    assert m1["hblkhd"] - m0["hblkhd"] >= 64 << 20
    del a
    assert rss_probe.mallinfo()["hblkhd"] - m0["hblkhd"] < 1 << 20
    assert m1["uordblks"] <= m1["arena"]


SMAPS = """7f0000000000-7f0000100000 r-xp 00000000 08:01 1234 /usr/lib/libx.so
Size:               1024 kB
Rss:                 600 kB
Anonymous:             0 kB
AnonHugePages:         0 kB
7f0000100000-7f0000200000 rw-p 00000000 00:00 0
Size:               1024 kB
Rss:                 900 kB
Anonymous:           900 kB
AnonHugePages:       512 kB
7ffd00000000-7ffd00021000 rw-p 00000000 00:00 0          [stack]
Rss:                  12 kB
Anonymous:            12 kB
"""


def test_smaps_parts_split_file_and_anonymous_pages():
    assert rss_probe.smaps_parts(SMAPS) == {"anon": 912, "file": 600,
                                            "huge": 512}
    assert rss_probe.smaps_parts("") is None


def test_a_kernel_without_rss_parts(monkeypatch):
    """Where ``/proc/self/status`` lacks RssAnon and RssFile the split
    comes from ``/proc/self/smaps`` (the sampler: RssFile from it, RssAnon
    as VmRSS less it); where that is missing too, the fields are None
    (never 0) and the rows say so."""
    from falcon_genome_tpu_torch.benchmarks import wgs_rehearsal
    full = rss_probe.proc_status()
    bare = {k: full[k] for k in ("VmRSS", "Threads")}
    for mod in (rss_probe, wgs_rehearsal):
        monkeypatch.setattr(mod, "proc_status", lambda text=None: bare)
    s = rss_probe.snapshot()
    assert s["anon_gb"] > 0 and s["file_gb"] > 0 and s["hwm_gb"] is None
    with Measured(CPU) as m:
        time.sleep(0.3)
    row = m.row(1)
    assert row["peak_rss_file_gb"] > 0 and row["peak_rss_anon_gb"] > 0
    assert row["peak_rss_anon_gb"] == pytest.approx(
        bare["VmRSS"] / 1e6 - m.sampler.peak_file, abs=0.011)
    for mod in (rss_probe, wgs_rehearsal):
        monkeypatch.setattr(mod, "smaps_parts", lambda text=None: None)
    monkeypatch.setattr(rss_probe, "anon_huge_kb", lambda path=None: None)
    s = rss_probe.snapshot()
    assert (s["anon_gb"], s["file_gb"], s["huge_gb"]) == (None, None, None)
    assert rss_probe.peak_split([s])["anon_outside_malloc_gb"] is None
    with Measured(CPU) as m:
        time.sleep(0.3)
    row = m.row(1)
    assert row["peak_rss_gb"] > 0
    assert all(row[k] is None for k in (
        "peak_rss_anon_gb", "peak_rss_file_gb", "rss_anon_added_gb",
        "rss_anon_left_gb"))
    rec = {"start": s, "end": s, "samples": [], "wall_s": 0.3,
           "peak_rss_gb": 1.0}
    row = rss_probe.stage_row(1.0, "bqsr", rec)
    assert (row["anon_added_gb"], row["anon_left_gb"]) == (None, None)


def test_snapshot_and_the_split_at_its_peak():
    s = rss_probe.snapshot()
    for k in ("rss_gb", "anon_gb", "file_gb", "shmem_gb", "hwm_gb",
              "huge_gb", "malloc_arena_gb", "malloc_in_use_gb",
              "malloc_free_gb", "malloc_mmapped_gb", "pinned_gb"):
        assert s[k] is not None and s[k] >= 0, k
    assert abs(s["rss_gb"] - s["anon_gb"] - s["file_gb"]
               - s["shmem_gb"]) < 1e-3
    assert s["pinned_gb"] == 0 and s["cuda_initialized"] is False
    low = {**s, "t_s": 0.0}
    high = {**s, "t_s": 1.0, "rss_gb": s["rss_gb"] + 1,
            "anon_gb": s["anon_gb"] + 1}
    split = rss_probe.peak_split([low, high, low])
    assert split["at_s"] == 1.0 and split["rss_gb"] == high["rss_gb"]
    assert split["live_heap_gb"] == pytest.approx(
        s["malloc_in_use_gb"] + s["malloc_mmapped_gb"], abs=1e-4)
    assert split["anon_outside_malloc_gb"] == pytest.approx(
        high["anon_gb"] - s["malloc_arena_gb"] - s["malloc_mmapped_gb"],
        abs=1e-4)
    assert rss_probe.peak_split([]) is None


def test_stage_row_adds_and_leaves():
    s = rss_probe.snapshot()
    start = {**s, "anon_gb": 1.0, "threads": 9}
    mid = {**s, "anon_gb": 3.5, "threads": 40, "t_s": 1.0}
    end = {**s, "anon_gb": 2.0, "threads": 9}
    row = rss_probe.stage_row(16.0, "htc", {
        "start": start, "end": end, "samples": [mid], "wall_s": 3.0,
        "peak_rss_gb": 4.0})
    assert (row["anon_added_gb"], row["anon_left_gb"],
            row["threads_peak"]) == (2.5, 1.0, 40)
    assert row["peak_split"]["anon_gb"] == 3.5


def test_probe_steps_and_cli_mode_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "probe.json"
    assert rss_probe.main(["--device", "cpu", "--genomes", "",
                           "--lanes", "8", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    names = [s["step"] for s in doc["steps"]]
    assert names[:2] == ["python + numpy", "import torch"]
    assert names[-4:] == [f"first K{k} launch ({f})" for k, f in (
        (1, "sw_score"), (2, "sw_pointers"), (3, "sw_traceback"),
        (4, "pairhmm_sc"))]
    assert doc["card"] == "cpu" and doc["stages"] == []
    assert doc["host"]["cpu_count"] >= doc["host"]["affinity"] >= 1
    assert not any(s["cuda_initialized"] for s in doc["steps"])
    assert set(doc["cost_ms"]) == {"proc_status", "smaps", "snapshot"}
    assert rss_probe.main(["--out", str(out), "--cli", "--device", "cpu",
                           "conf"]) == 0
    cli = json.loads(out.read_text())["cli"]
    assert (cli["rc"], cli["cuda_initialized"]) == (0, False)
    assert cli["peak_rss_gb"] >= cli["peak_rss_anon_gb"] > 0


# ---- Measured's columns ----------------------------------------------------

def test_measured_rows_split_the_peak():
    """``peak_rss_gb`` stays the peak of VmRSS; its anonymous and file
    peaks stand beside it, with the anonymous memory the block added and
    left behind (here 200 MB it keeps)."""
    with Measured(CPU) as m:
        keep = np.ones(200 << 20, np.uint8)
        time.sleep(0.6)
    row = m.row(1)
    assert row["peak_rss_gb"] == round(m.sampler.peak, 2)
    assert row["peak_rss_gb"] >= row["peak_rss_anon_gb"] > 0
    assert row["peak_rss_gb"] >= row["peak_rss_file_gb"] > 0
    assert row["rss_anon_added_gb"] >= 0.19
    assert row["rss_anon_left_gb"] >= 0.19
    assert row["peak_device_gb"] is None and "peak_split" not in row
    with Measured(CPU, series=True) as m:
        time.sleep(1.2)
    assert len(m.series) >= 2
    assert m.memory()["peak_split"]["rss_gb"] > 0
    del keep


def test_rehearsal_series_per_stage(tmp_path):
    """``wgs_rehearsal --series``: a snapshot a second for each stage run,
    merged into one file across processes, and the split at each peak."""
    from falcon_genome_tpu_torch.benchmarks import wgs_rehearsal as W
    saved = (W.G, W.N_PAIRS, W.N_SNPS)
    out, series = tmp_path / "rows.json", tmp_path / "series.json"
    try:
        W.G, W.N_PAIRS, W.N_SNPS = W.scale(0.01)
        for stages in ("a", "m"):
            assert W.main([str(tmp_path / "w"), "--stages", stages,
                           "--device", "cpu", "--out", str(out),
                           "--series", str(series)]) == 0
    finally:
        W.G, W.N_PAIRS, W.N_SNPS = saved
    rows, snaps = (json.loads(f.read_text()) for f in (out, series))
    assert set(snaps) == {"align", "markdup"}
    for stage in snaps:
        assert snaps[stage]["samples"] and snaps[stage]["end"]["rss_gb"] > 0
        assert rows[stage]["peak_split"]["rss_gb"] > 0
        assert rows[stage]["rss_anon_left_gb"] is not None


# ---- no CUDA context without a kernel --------------------------------------

CONTEXT_CALLS = ("set_device", "current_device", "synchronize", "init",
                 "_lazy_init", "reset_peak_memory_stats",
                 "max_memory_allocated")


@pytest.fixture
def pretend_card(monkeypatch):
    """A card that ``is_available`` reports and that every call which would
    bring CUDA up counts instead."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for name in CONTEXT_CALLS:
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: calls.append(_n) or 0)
    return calls


def test_resolve_device_brings_cuda_up_for_no_one(pretend_card):
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert pretend_card == [] and not torch.cuda.is_initialized()


def _world(tmp_path):
    """A 4 kb contig and clean 80 bp reads every 10 bp."""
    chrom = np.random.default_rng(3).integers(0, 4, 4000).astype(np.uint8)
    write_fasta(tmp_path / "ref.fa", {"chr1": decode_seq(chrom)})
    recs = [SamRecord(f"r{s}", 0, 0, s, 60, cigar_from_str("80M"),
                      seq=decode_seq(chrom[s:s + 80]), qual="I" * 80)
            for s in range(0, len(chrom) - 80, 10)]
    write_bam(tmp_path / "in.bam", SamHeader(
        contigs=[("chr1", len(chrom))], sort_order="coordinate"), recs)
    return str(tmp_path / "ref.fa"), str(tmp_path / "in.bam"), len(recs)


HOST_COMMANDS = {"bqsr": "out.bam", "baserecal": "table.npz",
                 "ug": "out.vcf"}


@pytest.mark.parametrize("cmd", sorted(HOST_COMMANDS))
def test_host_command_opens_no_context(cmd, tmp_path, pretend_card):
    """``bqsr``, ``baserecal`` and ``ug`` launch no kernel without a mesh
    of several devices: with ``--device cuda`` they run and make no call
    that brings CUDA up."""
    ref, bam, _ = _world(tmp_path)
    argv = ["--device", "cuda", cmd, "-r", ref, "-i", bam, "-o",
            str(tmp_path / HOST_COMMANDS[cmd]), "-f",
            "-O", f"log_dir={tmp_path / 'log'}",
            "-O", f"temp_dir={tmp_path / 'tmp'}"]
    assert tcli.main(argv) == 0
    assert pretend_card == [] and not torch.cuda.is_initialized()
    assert (tmp_path / HOST_COMMANDS[cmd]).exists()


@pytest.mark.parametrize("cmd", sorted(HOST_COMMANDS))
def test_host_command_without_a_card_still_refuses_cuda(cmd, tmp_path):
    ref, bam, _ = _world(tmp_path)
    out = tmp_path / HOST_COMMANDS[cmd]
    assert tcli.main(["--device", "cuda", cmd, "-r", ref, "-i", bam,
                      "-o", str(out), "-f"]) == 1
    assert not out.exists()


def test_joint_cohort_on_cuda_opens_no_context(tmp_path, pretend_card,
                                               monkeypatch, capsys):
    """``joint_cohort --device cuda`` is host work: measured, it makes no
    call that brings CUDA up, and its row says nothing was on the card."""
    chrom = np.random.default_rng(4).integers(0, 4, 12_000).astype(np.uint8)
    write_fasta(tmp_path / "ref.fa", {"chr1": decode_seq(chrom)})
    monkeypatch.setattr(joint_cohort, "card_label", lambda d: "card")
    out = tmp_path / "rows.json"
    assert joint_cohort.main([str(tmp_path), "2", "--device", "cuda",
                              "--out", str(out)]) == 0
    row = json.loads(out.read_text())["joint_cohort"]
    assert row["pass"] and row["peak_device_gb"] == 0.0
    assert {"peak_rss_anon_gb", "peak_rss_file_gb"} <= row.keys()
    assert pretend_card == [] and not torch.cuda.is_initialized()


# ---- indel's genome cache and the FASTA cache ------------------------------

def test_indel_ships_each_genome_once_under_eight_threads(tmp_path,
                                                          monkeypatch):
    """Eight shards of one contig on eight runner threads: the contig goes
    to the device once (a slow copy lets every thread find the cache
    empty without the lock), and the records equal a one-thread run's."""
    ref, bam, n = _world(tmp_path)
    shipped = []
    ship = TI.device_genome

    def slow(codes, device):
        shipped.append(len(codes))
        time.sleep(0.3)
        return ship(codes, device)

    monkeypatch.setattr(TI, "device_genome", slow)
    out = {}
    for threads in (8, 1):
        conf = Config(machine=Machine(8, 16), environ={}, load_files=False)
        conf.set("gatk.ncontigs", 8)
        conf.set("gatk.nprocs", threads)
        conf.set("log_dir", str(tmp_path / f"log{threads}"))
        shipped.clear()
        out[threads] = str(tmp_path / f"t{threads}.bam")
        TI.run_indel(conf, ref, bam, out[threads], force=True, device=CPU)
        assert shipped == [4000], threads
    recs = {k: [(r.qname, r.pos, r.cigar) for r in read_bam(p)[1]]
            for k, p in out.items()}
    assert len(recs[8]) == n and recs[8] == recs[1]



def test_fasta_contig_decoded_once_under_eight_threads(tmp_path,
                                                        monkeypatch):
    """A stage's runner threads ask for the same contig at once: it is
    decoded once, and every thread gets that one array."""
    from concurrent.futures import ThreadPoolExecutor

    from falcon_genome_tpu_torch.io import fasta
    chrom = np.random.default_rng(6).integers(0, 4, 5000).astype(np.uint8)
    write_fasta(tmp_path / "ref.fa", {"chr1": decode_seq(chrom)})
    decoded = []
    encode = fasta.encode_seq_np

    def slow(raw):
        decoded.append(len(raw))
        time.sleep(0.3)
        return encode(raw)

    monkeypatch.setattr(fasta, "encode_seq_np", slow)
    fa = fasta.FastaFile(tmp_path / "ref.fa")
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda _: fa.contig_codes("chr1"), range(8)))
    assert decoded == [5000]
    assert all(g is got[0] for g in got)
    assert np.array_equal(got[0], chrom)
