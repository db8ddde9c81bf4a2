"""WGS rehearsal of the port: a 60 Mb genome, 5 M pairs of 150 bp reads
(25x), through the germline chain stage by stage.

Port of ``benchmarks/wgs_rehearsal.py``: align (bucket-spill dataflow into
a 256-bucket ``part-%06d`` tree) → markdup (streamed over the tree) →
bqsr (baserecal + printreads, streamed over ``dedup.bam`` and its
``.bai``) → htc (region-pruned over the recalibrated tree and its
``part-*.list`` sidecars), with the kernels on ``--device``.  Each stage's
row records its wall, reads/s, peak RSS (``RssSampler``: VmRSS, and the
peaks of its parts ``RssAnon`` and ``RssFile``; the ``RssAnon`` a stage
added and left behind), peak device
memory (``torch.cuda.max_memory_allocated``, reset per stage), the
launches of each kernel in the stage (``ops.smith_waterman.LAUNCHES``,
``ops.pairhmm.LAUNCHES``) and which path the stage took (``path``).  The
htc row adds SNP sensitivity and precision against the planted truth, the
extra calls classified by ``classify_extras`` and the pairs of its
PairHMM calls (``call_sizes.summary``).

The dataset (``ref.fa``, ``r_{1,2}.fastq``, ``truth.npy``; byte-equal to
the JAX script's from the same sizes) is cached in the work directory, so
``--stages`` can run one stage a process.  ``WGS_G_MB`` in the
environment sets the genome in Mb (default 60; ``WGS_SMOKE=1`` gives the
0.6 Mb smoke scale); pairs and SNPs follow it at 25x and 1 SNP/kb.
Results merge into ``--out`` (default ``wgs_rehearsal.json`` beside this
file): at the default 60 Mb at its top level, at any other genome in a
section ``wgs@<Mb>mb`` of their own, so no run overwrites the rows of
another size.

Usage:
    WGS_G_MB=60 python -m \
        falcon_genome_tpu_torch.benchmarks.wgs_rehearsal
        [WORKDIR] [--stages a,m,b,h] [--device cuda|cpu]
        [-O KEY=VALUE ...] [--out PATH] [--series PATH]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .rss_probe import peak_split, proc_status, smaps_parts, snapshot

REPO = Path(__file__).resolve().parents[2]
DEFAULT_WORK = REPO / "build" / "wgs_rehearsal"
DEFAULT_OUT = Path(__file__).with_name("wgs_rehearsal.json")

READ_LEN = 150
FRAG = 350
DEPTH = 25
SMOKE_MB = 0.6


def scale(genome_mb: float) -> tuple[int, int, int]:
    """(genome length, read pairs, SNPs) at 25x and 1 SNP/kb."""
    g = int(round(genome_mb * 1e6))
    return g, g * DEPTH // (2 * READ_LEN), g // 1000


DEFAULT_MB = 60
G_MB = float(os.environ.get("WGS_G_MB") or
             (SMOKE_MB if os.environ.get("WGS_SMOKE") else DEFAULT_MB))
G, N_PAIRS, N_SNPS = scale(G_MB)

STAGES = {"a": "align", "m": "markdup", "b": "bqsr", "h": "htc"}
# the ports of K1-K4, the kernels of this path
KERNELS = ("fgt_sw_score", "fgt_sw_full", "fgt_sw_traceback", "fgt_pairhmm")


# seconds between reads of /proc/self/smaps where the status has no split
# (parsing it holds the interpreter for milliseconds)
PARTS_PERIOD = 5.0


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class RssSampler:
    """Per-stage peak RSS by sampling /proc/self/status VmRSS.

    ru_maxrss is a process-lifetime max: any stage after a spike would
    inherit the spike's number.  VmRSS is current residency, so its max
    over the stage window attributes memory to the stage that used it.
    The peaks of its parts ``RssAnon`` and ``RssFile`` are kept beside it
    (``peak_anon``, ``peak_file``).  On kernels whose status lacks them,
    ``RssFile`` is read from ``/proc/self/smaps`` every
    :data:`PARTS_PERIOD` seconds and ``RssAnon`` is VmRSS less it; None
    where neither file gives them.  With ``series_period``, a full
    ``rss_probe.snapshot`` every ``series_period`` seconds (``series``).
    """

    def __init__(self, period: float = 0.25,
                 series_period: float | None = None):
        self.peak = 0.0
        self.peak_anon: float | None = None
        self.peak_file: float | None = None
        self.series: list[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(period, series_period), daemon=True)
        self._thread.start()

    def _run(self, period: float, series_period: float | None) -> None:
        t0 = time.perf_counter()
        next_sample = next_parts = t0
        file_kb = None          # RssFile from smaps, where status lacks it
        while not self._stop.is_set():
            st = proc_status()
            now = time.perf_counter()
            if "RssAnon" in st:
                anon, file = st["RssAnon"], st.get("RssFile", 0)
            else:
                if now >= next_parts:
                    next_parts = now + PARTS_PERIOD
                    file_kb = (smaps_parts() or {}).get("file")
                anon = file = None
                if file_kb is not None and "VmRSS" in st:
                    anon, file = st["VmRSS"] - file_kb, file_kb
            if "VmRSS" in st:
                self.peak = max(self.peak, st["VmRSS"] / 1e6)
            if anon is not None:
                self.peak_anon = max(self.peak_anon or 0.0, anon / 1e6)
                self.peak_file = max(self.peak_file or 0.0, file / 1e6)
            if series_period and now >= next_sample:
                self.series.append({"t_s": round(now - t0, 2),
                                    **snapshot()})
                next_sample += series_period
            self._stop.wait(period)

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return self.peak


def _sizes() -> dict:
    return {"G": G, "N_PAIRS": N_PAIRS, "N_SNPS": N_SNPS}


def dataset_files(work: Path) -> dict:
    return {"ref": str(work / "ref.fa"), "fq1": str(work / "r_1.fastq"),
            "fq2": str(work / "r_2.fastq")}


def gen_reference(work: Path, rng=None) -> np.ndarray:
    """``ref.fa`` alone: the genome's codes, the first draw of ``rng``
    (``default_rng(42)`` where not given), as :func:`gen_dataset` writes
    it; for the scripts that read only the reference (long reads, the
    joint cohort)."""
    from ..io.dna import decode_seq
    from ..io.fasta import write_fasta
    if rng is None:
        rng = np.random.default_rng(42)
    Path(work).mkdir(parents=True, exist_ok=True)
    chrom = rng.integers(0, 4, G).astype(np.uint8)
    write_fasta(Path(work) / "ref.fa", {"chr1": decode_seq(chrom)})
    return chrom


def gen_dataset(work: Path) -> dict:
    """Reference ``ref.fa``, read pairs ``r_{1,2}.fastq`` and the planted
    SNPs ``truth.npy`` from ``default_rng(42)``, in the JAX script's draw
    order (so its bytes equal that script's at the same sizes).  Reused
    when ``dataset.json`` records the same sizes."""
    from ..io.dna import decode_seq, revcomp_codes

    work = Path(work)
    ds = dataset_files(work)
    ref_fa, fq1, fq2 = (Path(ds[k]) for k in ("ref", "fq1", "fq2"))
    truth = work / "truth.npy"
    meta = work / "dataset.json"
    if (all(p.exists() for p in (ref_fa, fq1, fq2, truth, meta))
            and json.loads(meta.read_text()) == _sizes()):
        print("dataset cached")
        return ds
    work.mkdir(parents=True, exist_ok=True)
    meta.unlink(missing_ok=True)
    rng = np.random.default_rng(42)
    t0 = time.perf_counter()
    chrom = gen_reference(work, rng)
    alt = chrom.copy()
    snps = np.sort(rng.choice(np.arange(1000, G - 1000), N_SNPS,
                              replace=False))
    alt[snps] = (alt[snps] + 1) % 4
    np.save(truth, snps)
    print(f"genome written in {time.perf_counter() - t0:.0f}s")

    # fragments in chunks; 0.2% sequencing error; qual 'I'.  The draws
    # stay per fragment, in this order: the files must equal the JAX
    # script's byte for byte
    t0 = time.perf_counter()
    qline = "I" * READ_LEN
    CH = 200_000
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        done = 0
        while done < N_PAIRS:
            n = min(CH, N_PAIRS - done)
            starts = rng.integers(0, G - FRAG, n)
            hap_is_alt = rng.random(n) < 0.5
            for i in range(n):
                s = int(starts[i])
                hap = alt if hap_is_alt[i] else chrom
                r1 = hap[s:s + READ_LEN].copy()
                r2c = hap[s + FRAG - READ_LEN:s + FRAG]
                e1 = rng.random(READ_LEN) < 0.002
                r1[e1] = (r1[e1] + 1) % 4
                r2 = revcomp_codes(r2c).copy()
                e2 = rng.random(READ_LEN) < 0.002
                r2[e2] = (r2[e2] + 1) % 4
                name = f"f{done + i}"
                f1.write(f"@{name}\n{decode_seq(r1)}\n+\n{qline}\n")
                f2.write(f"@{name}\n{decode_seq(r2)}\n+\n{qline}\n")
            done += n
            if done % 1_000_000 == 0:
                print(f"  {done / 1e6:.0f}M pairs "
                      f"({time.perf_counter() - t0:.0f}s)")
    print(f"reads written in {time.perf_counter() - t0:.0f}s")
    meta.write_text(json.dumps(_sizes()))
    return ds


def dataset_pairs(work: Path) -> int:
    """Read pairs of the dataset cached in ``work``."""
    return json.loads((Path(work) / "dataset.json").read_text())["N_PAIRS"]


def classify_extras(extra_pos, bam_dir, ref_fa, call_conf=30.0):
    """GATK-concordance check for extra calls (compareVCF.sh's pass
    rule is 0 variants non-concordant WITH THE GATK BASELINE, not
    with simulation truth).  For each extra site, recompute GATK's
    exact diploid genotype likelihoods from the pileup (allele
    error rate from the recalibrated base quals) — if the resulting
    variant QUAL clears stand_call_conf, GATK emits the same call on
    this data and the site is concordant-extra, not a defect."""
    import math

    from ..io.fasta import FastaFile
    from ..io.intervals import Interval
    from ..stages.bamstages import BamInputSource
    fa = FastaFile(ref_fa)
    contig = fa.dict.contigs[0].name
    codes = fa.contig_codes(contig)
    src = BamInputSource(bam_dir)
    out = []
    for p in sorted(extra_pos):
        p = int(p)
        counts = {}
        quals = {}
        for r in src.records_for(
                [Interval(contig, max(1, p - 200), p + 200)]):
            if r.is_unmapped or r.is_duplicate or (r.flag & 0x900):
                continue
            i, j = 0, r.pos
            off = None
            for op, n in r.cigar:
                if op == 0:
                    if j <= p < j + n:
                        off = i + (p - j)
                        break
                    i += n
                    j += n
                elif op in (1, 4):
                    i += n
                elif op in (2, 3):
                    j += n
            if off is None or off >= len(r.seq):
                continue
            b = r.seq[off]
            counts[b] = counts.get(b, 0) + 1
            quals.setdefault(b, []).append(ord(r.qual[off]) - 33)
        ref_b = "ACGTN"[codes[p]]
        alts = [(n, b) for b, n in counts.items() if b != ref_b]
        if not alts:
            out.append({"pos": p, "gatk_forced": False, "qual": 0.0})
            continue
        n_alt, alt_b = max(alts)
        n_ref = counts.get(ref_b, 0)
        e = 10 ** (-np.mean(quals[alt_b]) / 10.0)
        l00 = (n_ref * math.log10(1 - e)
               + n_alt * math.log10(e / 3))
        l01 = (n_ref + n_alt) * math.log10(0.5 * (1 - e) + 0.5 * e / 3)
        q = 10.0 * (l01 - l00)
        out.append({"pos": p, "alt": alt_b, "n_ref": n_ref,
                    "n_alt": n_alt,
                    "gatk_qual": round(q, 1),
                    "gatk_forced": bool(q >= call_conf)})
    return out


# ---------------------------------------------------------------------------
# what a stage costs and which path it took
# ---------------------------------------------------------------------------

def card_label(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() or torch.cuda.get_device_name(device)


def launch_counts() -> dict[str, int]:
    from ..ops import pairhmm, smith_waterman
    counts = {**smith_waterman.LAUNCHES, **pairhmm.LAUNCHES}
    return {k: counts[k] for k in KERNELS}


class LogLines(logging.Handler):
    """Messages of the package's log while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def saw(self, text: str) -> bool:
        return any(text in m for m in self.lines)


class Measured:
    """Wall, peak RSS (VmRSS and its anonymous and file parts), peak device
    memory, kernel launches and log lines of the work inside a ``with``
    block; with ``series``, a snapshot of the process's memory every
    second (``rss_probe.snapshot``) and the split at its peak."""

    def __init__(self, device: torch.device, series: bool = False):
        self.device = device
        self.log = LogLines()
        self.series_period = 1.0 if series else None

    def __enter__(self):
        # the path a stage took is read from its INFO lines
        logger = logging.getLogger("falcon_genome_tpu")
        self.level = logger.level
        if logger.getEffectiveLevel() > logging.INFO:
            logger.setLevel(logging.INFO)
        logger.addHandler(self.log)
        if self._cuda_up():
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.launches0 = launch_counts()
        self.start = snapshot()
        self.sampler = RssSampler(series_period=self.series_period)
        self.t0 = time.perf_counter()
        return self

    def _cuda_up(self) -> bool:
        """Whether the device is a card and CUDA is up in this process:
        measuring work that put nothing on the card opens no context."""
        return self.device.type == "cuda" and torch.cuda.is_initialized()

    def __exit__(self, *exc):
        if self._cuda_up():
            torch.cuda.synchronize(self.device)
        self.wall = time.perf_counter() - self.t0
        self.rss = self.sampler.stop()
        self.series = self.sampler.series
        self.end = snapshot()
        logger = logging.getLogger("falcon_genome_tpu")
        logger.removeHandler(self.log)
        logger.setLevel(self.level)
        now = launch_counts()
        self.launches = {k: now[k] - self.launches0[k] for k in KERNELS}
        self.device_gb = (
            None if self.device.type != "cuda"
            else torch.cuda.max_memory_allocated(self.device) / 1e9
            if self._cuda_up() else 0.0)
        return False

    def memory(self) -> dict:
        """The memory columns of a row: peak VmRSS (``peak_rss_gb``, the
        number the JAX side's rows carry), the peaks of its anonymous and
        file parts, the ``RssAnon`` the work added over its start and left
        behind at its end, peak device memory, and with ``series`` the
        split at the peak (``rss_probe.peak_split``)."""
        def r2(v):          # None: the kernel gives no such field
            return None if v is None else round(v, 2)

        anon0, anon1 = self.start["anon_gb"], self.end["anon_gb"]
        peak_anon = self.sampler.peak_anon
        known = None not in (anon0, anon1, peak_anon)
        out = {"peak_rss_gb": round(self.rss, 2),
               "peak_rss_anon_gb": r2(peak_anon),
               "peak_rss_file_gb": r2(self.sampler.peak_file),
               "rss_anon_added_gb": r2(max(peak_anon, anon1) - anon0
                                       if known else None),
               "rss_anon_left_gb": r2(anon1 - anon0 if known else None),
               "peak_device_gb": (None if self.device_gb is None
                                  else round(self.device_gb, 3))}
        if self.series_period:
            out["peak_split"] = peak_split(self.series)
        return out

    def row(self, n_reads: int) -> dict:
        mem = self.memory()
        return {"wall_s": round(self.wall, 1),
                "peak_rss_gb": mem.pop("peak_rss_gb"),
                "reads_per_s": round(n_reads / max(self.wall, 1e-9), 1),
                **mem, "launches": self.launches}


def logged_paths(log: LogLines) -> dict[str, str]:
    """The paths align and markdup took, by the lines they log."""
    return {"align": ("bucket spill" if log.saw("bucket-spill dataflow")
                      else "in memory"),
            "markdup": ("streamed" if log.saw("markdup (streamed")
                        else "in memory")}


def input_mb(*paths: str) -> float:
    """MB (1e6 bytes) of the files, a folder counting its ``part-*.bam``:
    what a stage compares with its out-of-core threshold (MiB)."""
    total = 0
    for p in map(Path, paths):
        parts = sorted(p.glob("part-*.bam")) if p.is_dir() else [p]
        total += sum(x.stat().st_size for x in parts)
    return round(total / 1e6, 3)


def input_path(conf, path: str) -> str:
    """How a BAM stage reads ``path`` under ``conf``: ``stream`` (per
    shard through the ``.bai``), ``tree`` (region-pruned parts with
    sidecars) or ``in memory``."""
    from ..stages.bamstages import BamInputSource
    src = BamInputSource.from_conf(conf, path)
    if src.parts is not None:
        return "tree"
    return "stream" if src.stream else "in memory"


def make_conf(work: Path, options: list[str] = ()):
    """The rehearsal's configuration: temp and log dirs in ``work``, then
    the ``-O KEY=VALUE`` overrides."""
    from ..config import init as conf_init
    conf = conf_init(environ={})
    conf.set("temp_dir", str(Path(work) / "tmp"))
    conf.set("log_dir", str(Path(work) / "log"))
    for kv in options:
        if "=" not in kv:
            raise ValueError(f"-O expects KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        conf.set(k, v)
    return conf


def outputs(work: Path) -> dict[str, str]:
    work = Path(work)
    return {"bam": str(work / "aligned.bam"),
            "buckets": str(work / "aligned"),   # part-%06d bucket tree
            "dedup": str(work / "dedup.bam"),
            "recal": str(work / "recal"),
            "vcf": str(work / "calls.vcf.gz")}


def rehearse(work: Path, run_stages, device: torch.device, conf,
             results: dict, save=lambda results: None,
             series: dict | None = None) -> dict:
    """Run ``run_stages`` (names of :data:`STAGES`) on the dataset cached
    in ``work``; each stage's row goes into ``results``, which ``save``
    gets after every stage.  With a ``series`` dict, each stage is also
    sampled every second and ``series[stage]`` gets its snapshots
    (``start``, ``end``, ``samples``; ``rss_probe.snapshot``)."""
    from .. import stages
    from .call_sizes import PairHMMCalls, summary

    ds = dataset_files(work)
    out = outputs(work)
    n_reads = 2 * dataset_pairs(work)

    def record(name, fn, path, *inputs):
        size = input_mb(*inputs)
        with Measured(device, series=series is not None) as m:
            fn()
        results[name] = {**m.row(n_reads), "path": path(m.log),
                         "input_mb": size}
        if series is not None:
            series[name] = {"start": m.start, "end": m.end,
                            "samples": m.series}
        save(results)
        mem = results[name]
        print(f"== {name}: {m.wall:.0f}s (stage peak rss {m.rss:.1f} GB, "
              f"anon {mem['peak_rss_anon_gb']} GB, file "
              f"{mem['peak_rss_file_gb']} GB, "
              f"process max {peak_rss_gb():.1f} GB, device "
              f"{results[name]['peak_device_gb']} GB, launches "
              f"{m.launches}, path {results[name]['path']})")

    if "align" in run_stages:
        # reference flow: the aligner emits a position-bucketed tree
        # (BWAWorker --num_buckets) and markdup streams it
        record("align", lambda: stages.run_align(
            conf, ds["ref"], out["bam"], fastq1=ds["fq1"], fastq2=ds["fq2"],
            sample_id="s", num_buckets=256, merge=False, force=True,
            device=device),
            lambda log: logged_paths(log)["align"], ds["fq1"], ds["fq2"])
    if "markdup" in run_stages:
        record("markdup", lambda: stages.run_markdup(
            conf, out["buckets"], out["dedup"], force=True),
            lambda log: logged_paths(log)["markdup"], out["buckets"])
    if "bqsr" in run_stages:
        record("bqsr", lambda: stages.run_bqsr(
            conf, ds["ref"], out["dedup"], out["recal"], force=True),
            lambda log: input_path(conf, out["dedup"]), out["dedup"])
    if "htc" in run_stages:
        # reference pipeline order: the caller consumes the
        # RECALIBRATED BAM (worker-germline.cpp chains bqsr → htc) —
        # BQSR learning the empirical ~q27 of the sim's 0.2% error is
        # exactly what suppresses 2-read error-pileup het calls
        htc_in = (out["recal"] if Path(out["recal"]).exists()
                  else out["dedup"])
        calls = PairHMMCalls()

        def htc():
            with calls:
                stages.run_htc(conf, ds["ref"], htc_in, out["vcf"],
                               produce_vcf=True, force=True, device=device)

        record("htc", htc, lambda log: input_path(conf, htc_in), htc_in)
        results["htc"]["pairhmm_call_sizes"] = summary(calls.sizes)
        results["htc"].update(accuracy(work, out["vcf"], htc_in, ds["ref"]))
        results["htc"]["input"] = ("recal" if htc_in == out["recal"]
                                   else "dedup")
        save(results)
        h = results["htc"]
        print(f"   sensitivity {h['sensitivity']}, extra "
              f"{h['extra_calls']} ({h['extras_gatk_concordant']} "
              f"GATK-concordant), precision {h['precision']}")
    total = sum(v["wall_s"] for k, v in results.items()
                if k in STAGES.values())
    if total:
        results["germline_e2e_reads_per_s"] = round(n_reads / total, 1)
        save(results)
    return results


def accuracy(work: Path, vcf: str, bam: str, ref: str) -> dict:
    """SNP sensitivity and precision against the planted truth, and the
    extra calls classified (the reference's pass rule, compareVCF.sh:
    230-258: zero calls non-concordant with the GATK baseline; a
    truth-extra call that GATK's own likelihood model emits on this
    pileup is concordant, any other fails)."""
    from ..io.vcf import read_vcf
    truth = set(np.load(Path(work) / "truth.npy").tolist())
    _, recs = read_vcf(vcf)
    called = {r.pos - 1 for r in recs if not r.is_gvcf_block}
    tp = len(truth & called)
    extras = called - truth
    prec = tp / max(len(called), 1)
    cls = classify_extras(extras, bam, ref)
    unforced = [c for c in cls if not c["gatk_forced"]]
    return {"sensitivity": round(tp / len(truth), 4),
            "extra_calls": len(extras),
            "precision": round(prec, 5),
            "extra_classification": cls,
            "extras_gatk_concordant": len(cls) - len(unforced),
            "pass_rule": ("0 extras non-concordant with the GATK pileup "
                          "likelihood at stand_call_conf 30"),
            "precision_pass": bool(prec >= 0.999 and not unforced)}


def parse_args(argv, description: str, stages: bool = True):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("work", nargs="?", default=str(DEFAULT_WORK))
    if stages:
        ap.add_argument("--stages", default="a,m,b,h")
        ap.add_argument("--series", default=None, metavar="PATH",
                        help="also sample each stage's memory every "
                             "second; the snapshots merge into PATH")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-O", "--option", action="append", default=[],
                    metavar="KEY=VALUE", help="configuration override")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="results JSON (merged with what it holds)")
    return ap.parse_args(argv)


def load_results(path: Path) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def row_key(name: str, size: float, default: float, unit: str) -> str:
    """Where a script's row goes in its results JSON: ``name`` at the
    script's default size, ``name@<size><unit>`` at any other, so that a
    run at one size leaves the rows of every other size in place."""
    return name if size == default else f"{name}@{size:g}{unit}"


def save_row(path: Path, key: str, row: dict) -> None:
    """Merge ``row`` into the results JSON at ``path`` under ``key``."""
    results = load_results(path)
    results[key] = row
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))


def save_series(path: Path, series: dict) -> None:
    """Merge stages' memory snapshots into the JSON at ``path``."""
    merged = {**load_results(path), **series}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(merged))


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv, __doc__.splitlines()[0])
    from ..device import resolve_device
    device = resolve_device(args.device)
    # stage-level timings ("BaseRecalibrator finishes in Ns") come from the
    # package logger — keep them in the rehearsal transcript
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    run_stages = {STAGES[s] for s in args.stages.split(",")}
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    results_path = Path(args.out)
    # the default genome's rows sit at the top level, beside the other
    # scripts' rows; another genome's in a section of their own
    everything = load_results(results_path)
    key = row_key("wgs", G / 1e6, DEFAULT_MB, "mb")
    results = (everything if key == "wgs"
               else everything.setdefault(key, {}))
    if results.get("genome_mb", G / 1e6) != G / 1e6:
        # stage rows of another genome do not add up with this run's
        for k in (*STAGES.values(), "germline_e2e_reads_per_s"):
            results.pop(k, None)
    gen_dataset(work)
    results.update(card=card_label(device), genome_mb=G / 1e6,
                   pairs=N_PAIRS, snps=N_SNPS, options=args.option)

    def save(_):
        results_path.parent.mkdir(parents=True, exist_ok=True)
        results_path.write_text(json.dumps(everything, indent=1))

    conf = make_conf(work, args.option)
    series = None if args.series is None else {}
    rehearse(work, run_stages, device, conf, results, save, series)
    save(results)
    if series is not None:
        save_series(Path(args.series), series)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
