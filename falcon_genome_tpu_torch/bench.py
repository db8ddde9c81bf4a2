"""Benchmark of the port on one NVIDIA GPU: PairHMM forward throughput
(GCUPS) as the headline, the wider envelope in ``extras``.

    python -m falcon_genome_tpu_torch.bench

The counterpart of the repository's ``bench.py``, with its shapes and
metric names:

  pairhmm_forward_gcups     kernel K4, 2048 pairs of 152-base reads (bucket
                            160) against 384-base haplotypes, transitions
                            45/45/10, base qualities 30;
  pairhmm_mesh_gcups        the same through ``sharded_pairhmm_step`` over
                            a mesh of every visible card (``mesh_chips``);
  sw_score_gcups            kernel K1, 2048 lanes of 150-base reads in 400-
                            base windows (bucket 160 x 416);
  align_reads_per_s         ``AlignerEngine.align_batch``: 5000 x 150 bp
                            reads against a 1 Mb genome (+ mapped fraction);
  align_pair_reads_per_s    the pair path: 4096 pairs against 4 Mb;
  longread_mbp_per_s        ``LongReadAligner.align_batch``: 128 x 10 kb
                            reads at 5% error against 1 Mb;
  germline_e2e_*            ``germline`` on a 240 kb simulated contig;
  fma_ceiling_gflops        kernel K6, the 64-chain FMA ceiling of K4's
                            tile (the reference's
                            ``pallas_fma_ceiling_gflops``);
  pairhmm_mfu               K4's arithmetic rate over that ceiling, 15
                            flops per executed cell.

Not carried over: ``pairhmm_issue_util`` / ``sw_issue_util``, which count
the TPU kernels' vector-issue slots and say nothing of the CUDA kernels.

Kernel times are CUDA events around ``N_INNER`` (20) launches after a
warm-up call, best of 3; host-side rates are wall clocks around work that
ends in a synchronise.  The JSON line names the backend and the card
(name and power limit from ``nvidia-smi``).  Without a CUDA device it
exits non-zero and prints no metric; any failure exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BASELINE_GCUPS = 20.0
TRANS = (45, 45, 10)        # HaplotypeCaller's ins/del/gcp phreds
# arithmetic flops per executed cell of the PairHMM recurrence, an FMA
# counted as two (bench.py's KERNEL_FLOPS_PER_CELL)
KERNEL_FLOPS_PER_CELL = 15

# bench.py's shapes: PairHMM pairs at HaplotypeCaller's read and
# haplotype lengths in their buckets
B, R_REAL, H_REAL = 2048, 152, 384
BUCKET_R, BUCKET_H = 160, 384
# score-only Smith-Waterman lanes: 150-base reads in 400-base windows
SW_B, SW_R_REAL, SW_W_REAL = 2048, 150, 400
SW_BUCKET_R, SW_BUCKET_W = 160, 416
ALIGN_GENOME, ALIGN_READS = 1_000_000, 5000
PAIR_GENOME, PAIR_FRAGS = 4_000_000, 4096
LONG_GENOME, LONG_READS, LONG_LEN = 1_000_000, 128, 10_000
GERMLINE_GENOME = 240_000
N_INNER = 20


def fma_trips() -> int:
    """K6's trip count: K4's loop over a (read, hap) bucket, halved as in
    the reference's twin."""
    return (BUCKET_R + BUCKET_H) // 2


def timed(fn, device: torch.device, n_inner: int, n_outer: int = 3
          ) -> float:
    """Best seconds per call of ``fn`` over ``n_outer`` runs of
    ``n_inner`` calls, after one warm-up call: CUDA events on a card, the
    host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(n_outer):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n_inner):
                fn()
            b.record()
            b.synchronize()
            sec = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(n_inner):
                fn()
            sec = time.perf_counter() - t0
        best = min(best, sec)
    return best / n_inner


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pairhmm_inputs(rng, device: torch.device):
    """Lane-major (read, q, rlen, hap, hlen): reads cut from their
    haplotype with 1% substitutions, qualities 30."""
    hap = np.full((B, BUCKET_H), 4, np.uint8)
    hap[:, :H_REAL] = rng.integers(0, 4, (B, H_REAL))
    read = np.full((B, BUCKET_R), 4, np.uint8)
    for b in range(B):
        s = rng.integers(0, H_REAL - R_REAL + 1)
        read[b, :R_REAL] = hap[b, s:s + R_REAL]
    mut = rng.random((B, R_REAL)) < 0.01
    read[:, :R_REAL] = np.where(mut, (read[:, :R_REAL] + 1) % 4,
                                read[:, :R_REAL])
    q = np.full((B, BUCKET_R), 30, np.uint8)
    rlen = np.full(B, R_REAL, np.int32)
    hlen = np.full(B, H_REAL, np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (read, q, rlen, hap, hlen))


def bench_pairhmm(args, device: torch.device):
    """K4 at the HaplotypeCaller configuration.  Returns (GCUPS,
    seconds per call)."""
    from .ops.pairhmm import pairhmm_sc
    read, q, rlen, hap, hlen = args
    per_call = timed(lambda: pairhmm_sc(read, q, rlen, hap, hlen, *TRANS),
                     device, N_INNER)
    return B * R_REAL * H_REAL / per_call / 1e9, per_call


def bench_pairhmm_mesh(args, devices: list[torch.device]):
    """The same pairs through the sharded step over a (data=n, region=1)
    mesh of ``devices``.  Returns (GCUPS, device count)."""
    from .parallel import MeshSpec, make_mesh, sharded_pairhmm_step
    mesh = make_mesh(MeshSpec(data=len(devices), region=1), devices)
    step = sharded_pairhmm_step(mesh, BUCKET_R, BUCKET_H, scalar_trans=TRANS)
    read, q, rlen, hap, hlen = args

    def call():
        out = step(read, q, q, q, q, rlen, hlen, hap)
        for d in devices:
            _sync(d)
        return out

    per_call = timed(call, devices[0], N_INNER)
    return B * R_REAL * H_REAL / per_call / 1e9, len(devices)


def sw_inputs(rng, device: torch.device):
    """Lane-major (read, rlen, win, wlen): windows of ``SW_W_REAL`` random
    bases, reads cut from them with 1% substitutions."""
    rl, wl = SW_R_REAL, SW_W_REAL
    win = np.full((SW_B, SW_BUCKET_W), 4, np.int8)
    win[:, :wl] = rng.integers(0, 4, (SW_B, wl))
    read = np.full((SW_B, SW_BUCKET_R), 4, np.int8)
    for b in range(SW_B):
        s = rng.integers(0, wl - rl + 1)
        read[b, :rl] = win[b, s:s + rl]
    mut = rng.random((SW_B, rl)) < 0.01
    read[:, :rl] = np.where(mut, (read[:, :rl] + 1) % 4, read[:, :rl])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
                 (read, np.full(SW_B, rl, np.int32), win,
                  np.full(SW_B, wl, np.int32)))


def bench_sw_score(rng, device: torch.device):
    """K1, the aligner's candidate ranking.  Returns (GCUPS, seconds per
    call)."""
    from .ops.smith_waterman import sw_score
    from .ops.sw_ref import SWParams
    read, rlen, win, wlen = sw_inputs(rng, device)
    params = SWParams()
    per_call = timed(lambda: sw_score(read, rlen, win, wlen, params),
                     device, N_INNER)
    return SW_B * SW_R_REAL * SW_W_REAL / per_call / 1e9, per_call


def bench_fma_ceiling(device: torch.device):
    """K6 on K4's (read bucket, pairs) tile.  Returns (GFLOP/s, seconds
    per call)."""
    from .ops.bench_kernels import fma_ceiling, fma_ceiling_flops
    x = torch.ones((BUCKET_R, B), dtype=torch.float32, device=device)
    per_call = timed(lambda: fma_ceiling(x, fma_trips()), device, N_INNER)
    flops = fma_ceiling_flops(BUCKET_R, B, fma_trips())
    return flops / per_call / 1e9, per_call


def pairhmm_mfu(gcups: float, ceiling_gflops: float) -> float:
    """K4's arithmetic rate over the FMA ceiling: GCUPS counts useful
    cells (R_REAL x H_REAL per pair); the kernel executes BUCKET_R rows
    x (R_REAL + H_REAL) diagonals, which scales the rate up
    before the division (bench.py's ``pairhmm_mfu``)."""
    executed = BUCKET_R * (R_REAL + H_REAL) / (R_REAL * H_REAL)
    return gcups * executed * KERNEL_FLOPS_PER_CELL / ceiling_gflops


def bench_align(rng, device: torch.device):
    """``AlignerEngine.align_batch`` on single reads (1% substitutions,
    both strands).  Returns (reads/s, mapped fraction)."""
    from .aligner import AlignerEngine, AlignerParams, IndexParams, \
        MinimizerIndex
    from .io.dna import revcomp_codes
    G, n, L = ALIGN_GENOME, ALIGN_READS, 150
    chrom = rng.integers(0, 4, G).astype(np.uint8)
    idx = MinimizerIndex([("chr1", chrom)], IndexParams(k=17, w=7))
    reads = np.zeros((n, L), np.uint8)
    for i in range(n):
        p = rng.integers(0, G - L)
        r = chrom[p:p + L].copy()
        mut = rng.random(L) < 0.01
        r = np.where(mut, (r + rng.integers(1, 4, L)) % 4, r).astype(
            np.uint8)
        reads[i] = revcomp_codes(r) if rng.random() < 0.5 else r
    lens = np.full(n, L, np.int32)
    eng = AlignerEngine(idx, AlignerParams(), device=device)
    eng.align_batch(reads[:64], lens[:64])
    eng.align_batch(reads, lens)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        res = eng.align_batch(reads, lens)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return n / best, sum(a.mapped for a in res) / n


def bench_align_pair(rng, device: torch.device):
    """The pair path (dispatch, then collect) on FR pairs, 350 bp
    fragments, 0.5% substitutions.  Returns (reads/s, mapped fraction)."""
    from .aligner import AlignerEngine, AlignerParams, IndexParams, \
        MinimizerIndex
    from .io.dna import revcomp_codes
    G, B1, L, frag = PAIR_GENOME, PAIR_FRAGS, 150, 350
    chrom = rng.integers(0, 4, G).astype(np.uint8)
    idx = MinimizerIndex([("chr1", chrom)], IndexParams(k=17, w=7))
    c1 = np.zeros((B1, L), np.uint8)
    c2 = np.zeros((B1, L), np.uint8)
    for i in range(B1):
        p = int(rng.integers(0, G - frag))
        r1 = chrom[p:p + L].copy()
        r2 = revcomp_codes(chrom[p + frag - L:p + frag].copy())
        for r in (r1, r2):
            mut = rng.random(L) < 0.005
            r[mut] = (r[mut] + 1) % 4
        c1[i], c2[i] = r1, r2
    lens = np.full(B1, L, np.int32)
    eng = AlignerEngine(idx, AlignerParams(), device=device)
    eng.align_pair_collect(eng.align_pair_dispatch(c1, lens, c2, lens))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        r1, r2 = eng.align_pair_collect(
            eng.align_pair_dispatch(c1, lens, c2, lens))
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    mapped = (int(r1.mapped.sum()) + int(r2.mapped.sum())) / (2 * B1)
    return 2 * B1 / best, mapped


def bench_longread(rng, device: torch.device) -> float:
    """``LongReadAligner.align_batch`` on ONT-class reads (5% errors: 60%
    substitutions, 40% deletions) against a 1 Mb genome; 128 reads are
    the engine's host/device pipeline over sub-batches (production
    batches are 512, ``tpu.batch.long_reads``).  Returns Mbp/s (best of
    3, after one warm-up call)."""
    from .aligner import IndexParams, MinimizerIndex
    from .longread import LongReadAligner, LongReadParams
    G, n, L = LONG_GENOME, LONG_READS, LONG_LEN
    genome = rng.integers(0, 4, G).astype(np.uint8)
    lp = LongReadParams(index=IndexParams(k=19, w=10, max_hits=256))
    eng = LongReadAligner(MinimizerIndex([("chr1", genome)], lp.index), lp,
                          device=device)
    reads = []
    for _ in range(n):
        p = int(rng.integers(0, G - L))
        r = genome[p:p + L].copy()
        err = rng.random(L) < 0.05
        sub = rng.random(L) < 0.6
        r[err & sub] = (r[err & sub] + 1) % 4
        reads.append(r[~(err & ~sub)])
    eng.align_batch(reads)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = eng.align_batch(reads)
        best = min(best, time.perf_counter() - t0)
    if sum(a.mapped for a in res) < n * 0.9:
        raise RuntimeError("longread mapped fraction below 0.9")
    return sum(len(r) for r in reads) / best / 1e6


def bench_germline_e2e(rng, device: torch.device, work: str):
    """``germline`` (align → markdup → bqsr → htc) on a simulated contig:
    error-free quality-40 pairs every 11 bp, a het SNP every 2 kb.  Returns
    (reads/s end to end, SNP sensitivity, extra calls)."""
    import os

    from .config import Config, Machine
    from .io.dna import decode_seq, revcomp_codes
    from .io.fasta import write_fasta
    from .io.fastq import write_fastq
    from .io.vcf import read_vcf
    from .stages import run_germline

    G, L, frag = GERMLINE_GENOME, 150, 350
    chrom = rng.integers(0, 4, G).astype(np.uint8)
    ref = os.path.join(work, "ref.fa")
    write_fasta(ref, {"chr20": decode_seq(chrom)})
    alt = chrom.copy()
    truth = np.arange(1200, G - 1200, 2000)
    alt[truth] = (alt[truth] + 1) % 4
    names, s1, s2 = [], [], []
    for i, start in enumerate(range(0, G - frag, 11)):
        hap = alt if i % 2 else chrom
        names.append(f"f{start}")
        s1.append(decode_seq(hap[start:start + L]))
        s2.append(decode_seq(revcomp_codes(hap[start + frag - L:
                                               start + frag])))
    quals = ["I" * L] * len(names)
    fq1 = os.path.join(work, "r_1.fastq")
    fq2 = os.path.join(work, "r_2.fastq")
    write_fastq(fq1, names, s1, quals)
    write_fastq(fq2, names, s2, quals)
    conf = Config(machine=Machine(2, 16), environ={}, load_files=False)
    conf.set("temp_dir", work)
    conf.set("log_dir", os.path.join(work, "log"))
    # the reference's scatter for this input scale
    conf.set("bwa.num_buckets", 4)
    conf.set("gatk.ncontigs", 4)
    out = os.path.join(work, "out.vcf.gz")
    t0 = time.perf_counter()
    run_germline(conf, ref, out, fastq1=fq1, fastq2=fq2, sample_id="s",
                 produce_vcf=True, force=True, device=device)
    _sync(device)
    dt = time.perf_counter() - t0
    _, recs = read_vcf(out)
    called = {r.pos - 1 for r in recs if not r.is_gvcf_block}
    ts = set(truth.tolist())
    return 2 * len(names) / dt, len(ts & called) / len(ts), len(called - ts)


def run(device: torch.device, devices: list[torch.device], work: str) -> dict:
    """Every metric on ``device`` (``devices`` form the mesh); the
    reference's JSON object, without the card's fields."""
    rng = np.random.default_rng(0)
    args = pairhmm_inputs(rng, device)
    gcups, _ = bench_pairhmm(args, device)
    extras = {}
    mesh_gcups, nchips = bench_pairhmm_mesh(args, devices)
    extras["pairhmm_mesh_gcups"] = round(mesh_gcups, 3)
    extras["mesh_chips"] = nchips
    sw_gcups, _ = bench_sw_score(rng, device)
    extras["sw_score_gcups"] = round(sw_gcups, 3)
    rps, mapped = bench_align(rng, device)
    extras["align_reads_per_s"] = round(rps, 1)
    extras["align_mapped_frac"] = round(mapped, 4)
    rps, mapped = bench_align_pair(rng, device)
    extras["align_pair_reads_per_s"] = round(rps, 1)
    extras["align_pair_mapped_frac"] = round(mapped, 4)
    extras["longread_mbp_per_s"] = round(bench_longread(rng, device), 3)
    ceiling, _ = bench_fma_ceiling(device)
    extras["fma_ceiling_gflops"] = round(ceiling, 1)
    extras["pairhmm_mfu"] = round(pairhmm_mfu(gcups, ceiling), 3)
    rps, sens, extra_calls = bench_germline_e2e(
        np.random.default_rng(11), device, work)
    extras["germline_e2e_reads_per_s"] = round(rps, 1)
    extras["germline_e2e_sensitivity"] = round(sens, 4)
    extras["germline_e2e_extra_calls"] = extra_calls
    return {"metric": "pairhmm_forward_gcups", "value": round(gcups, 3),
            "unit": "GCUPS", "vs_baseline": round(gcups / BASELINE_GCUPS, 3),
            "extras": extras}


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    _, limit = smi.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"device": torch.cuda.get_device_name(0),
            "power_limit": limit.strip()}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m falcon_genome_tpu_torch.bench",
        description="PairHMM/Smith-Waterman/aligner/germline benchmark of "
                    "the port on one CUDA card; prints one JSON line")
    ap.add_argument("--work", default=None,
                    help="directory to hold the germline run's temporary "
                         "directory (default: the system's)")
    return ap


def main(argv: list[str] | None = None) -> int:
    ns = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; this benchmark measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    with tempfile.TemporaryDirectory(prefix="fgt-bench-",
                                     dir=ns.work) as work:
        result = run(device, devices, work)
    result["backend"] = "cuda"
    result.update(card())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
