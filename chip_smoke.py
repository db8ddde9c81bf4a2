#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``falcon_genome_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its numbers; any failure exits non-zero):

1. card: device name, ``nvidia-smi`` name and power limit, whether the
   host C++ extension built;
2. build: compiles the CUDA kernels from ``falcon_genome_tpu_torch/csrc``
   (nvcc, sm_90a) and reports build time, registers and spills, and the
   instructions of one sweep step in the library's SASS for the two
   PairHMM instantiations of the main path and for every instantiation
   of the Smith-Waterman sweep (with its integer max/min), and of K7's
   instantiations at the ablation's R = 160 (all 104 checked to hold
   their sweep loop);
3. kernels vs their plain PyTorch versions on the card at the main
   path's shapes: Smith-Waterman K1-K3 bit-equal (K2/K3 at the aligner's,
   mate rescue's and HaplotypeCaller's buckets, with K2's byte bound from
   its pointer array, and for K3 the walk per mapped lane, mean and
   longest, its round trips, its byte bound and its latency floor),
   PairHMM K4 (scalar
   transitions) and K5 (per-base transition planes) bit-equal with the
   same -inf lanes, also
   on quality-0 rescue pairs whose mass passes through float32's
   subnormal range, in small batches at the other row counts and the
   sweep's edges, and on pairs rescaled at diagonal 64; the kernels'
   phred table on the card bit-equal to the port's table (the
   reference's powf); K4 and K5 on the 128 seeded pairs of
   ``tests/data/pairhmm_reference_bits.npz`` bit-equal to the reference's
   ``_pairhmm_jax`` bits stored there (45/45/10 and BI/BD-like planes);
   median times of both;
4. ``germline`` end to end through the CLI (``--device cuda``) on a
   simulated 1 Mb contig at 30x (150 bp pairs), with per-stage wall time,
   reads/s, kernel launch counts (each must be > 0) and call accuracy
   against the planted truth (SNP sensitivity and precision >= 0.98);
5. the same slice on a 50 kb cut with ``--device cpu`` and ``--device
   cuda``: BAMs record-equivalent, VCF with 0 non-concordant records;
6. the multi-device path: (a) on a 4-shard mesh over the visible cards
   (``cuda:(i % count)``) the sharded steps (K5 on every shard plus the
   summed BQSR histogram), ``pairhmm_logp`` with planes and
   ``pairhmm_logp_pairs`` equal the single-device K5 call and calls, and
   ``accumulate_table`` / ``coordinate_order`` equal their single-device
   results on the 50 kb sample's records (each PairHMM call runs whole
   on one card of the mesh, ``parallel.mesh.call_device``); the sharded
   step's time over one K5 call's, and its ``torch.profiler`` trace per
   card (kernels, copies, busy ms, idle share, longest gap;
   ``benchmarks/mesh_trace.py``);
   the step, ``pairhmm_logp`` and ``pairhmm_logp_pairs`` under the mesh
   against one card at 8192 pairs and at the callers' median call
   (``mesh_trace.SIZES``), bit-equal, their time ratios printed;
   (b) ``bqsr`` and ``htc`` through the CLI in two ``gloo`` processes
   (``tpu.dist.*``) equal a single-process run: recal table and BAM,
   VCF records; (c) only where more than one card is visible (``chiprun
   --chips 4``), ``germline`` on 50 kb with the CLI's default mesh over
   every card against one card (``-O tpu.mesh.data=1``): record-equal,
   with both walls;
7. the benchmark path: kernel K6 (the FMA ceiling) bit-equal to its plain
   version on random inputs, its FFMA count per trip in the built library's
   SASS (``cuobjdump``) and its rate at most 105% of the card's published
   float32 peak; kernel K7 (the Smith-Waterman ablation) bit-equal to its
   plain version in all four variants, its base equal to K1; then
   ``python -m falcon_genome_tpu_torch.bench`` (its JSON line is printed)
   and the ablation script, each through its ``main``;
8. (run after phase 5, on phase 4's outputs) the somatic path: a
   simulated 1 Mb tumor (60x, ~200 somatic SNVs at allele fraction 0.3)
   and normal (30x) with phase 4's germline variants in both, ``align``
   and ``markdup`` of each and ``mutect2 -t tumor -n normal`` through the
   CLI on the card, with the wall of each step, the K2/K3/K4 launches of
   ``mutect2`` (each > 0, no other kernel), every Smith-Waterman (R, W)
   and PairHMM (R, H) bucket it launched, and K2/K3 (bit-equal) and K4
   (bit-equal, the same -inf lanes) held against their plain versions at each
   of them on that run's inputs, with kernel, plain and bound times;
   somatic SNV sensitivity and precision >= 0.9 and no germline site
   with ``FILTER=PASS``; ``mutect2`` over six 301 bp windows of the same
   BAMs with ``--device cpu`` and ``--device cuda``, record-equal; then
   ``ug``, ``depth``, ``vcf_filter``, ``htc`` gVCFs for ``joint``, and
   ``concat`` once each on phase 4's outputs (exit 0, non-empty outputs);
9. (run after phase 8) long reads, indel realignment and the ``gatk``
   passthrough through the CLI on the card: (a) ``align --long-reads`` of
   ONT-class reads (log-normal lengths, median 10 kb, 3-30 kb, 5% errors,
   both strands) at 10x of a simulated 1 Mb contig, in production widths
   (512 reads a batch, sub-batches of 256, chunks of 144/240 in the
   160/256 bucket), with its wall, Mbp/s and reads/s, its K2/K3 launches
   (no other kernel), every Smith-Waterman (R, W) bucket and the widest
   call, K2/K3 held against their plain versions at each bucket on that
   run's own gathered inputs, and mapped >= 0.95 and placed (100 bp, right
   strand) >= 0.95; (b) ``germline --long-reads`` on a 200 kb contig with
   40 het SNVs at 30x of 10 kb reads (the reference test's error profile):
   its buckets, K4 held at those past 256 rows, SNV sensitivity >= 0.7,
   precision printed; (c) ``indel`` on phase 4's 1 Mb / 30x deduplicated BAM: wall,
   reads realigned, K2/K3 launches and buckets held as in (a), lanes with
   wlen > W; (d) ``--device cpu`` against ``--device cuda``, record-equal
   BAMs: ``indel`` on phase 5's 50 kb BAM, ``align --long-reads`` of 20
   reads of 5 kb on a 100 kb contig; (e) ``gatk HaplotypeCaller -R -I -O``
   on phase 5's 50 kb BAM record-equal to ``htc --produce-vcf``;
10. (run after phase 5) the aligner's record API and the golden models:
   ``AlignerEngine.align_pair_batch`` (K1 → K2 → K3) on the card over
   phase 5's 50 kb read pairs in batches of 4096, with its pairs/s and
   K1-K3 launches (each > 0; the K1-K3 rows' ``launches_by_path``), its
   ``make_sam_records`` records equal to the columns path's
   (``alignments_to_columns``) and its alignments equal to the same call
   on the CPU; then ``ops/sw_ref.py::sw_align_ref`` on 64 lanes of phase
   3's K2/K3 aligner batch (160/256: equal scores, CIGARs of the read's
   length) and ``ops/pairhmm_ref.py`` on 64 pairs of its K4 batch
   (160/384: within 2e-3 log10 where K4 is finite, -inf only on the
   batch's unrelated pairs), each maximum error printed;
11. (run after phase 5) the out-of-core germline path: (a) the port's
   ``benchmarks/wgs_rehearsal.py`` at its smoke scale (0.6 Mb, 50 k pairs
   of 150 bp, 25x, 600 het SNPs) on the card, align → markdup → bqsr →
   htc with 256 buckets and every stage forced out of core (``-O
   tpu.align.spill_mb=0 -O tpu.bam.stream_mb=0``): align must log its
   bucket-spill dataflow, markdup its streamed pass, ``dedup.bam`` must
   stream through its ``.bai`` and the recalibrated tree be
   region-pruned under that run's configuration, the native library
   must be there, and the rehearsal's accuracy rule must hold (SNP
   sensitivity >= 0.99, precision >= 0.999, every extra call forced by
   GATK's pileup likelihood); (b) the same dataset and stages at the
   default thresholds (in memory): every BAM record-equal to (a)'s and
   the VCF with 0 non-concordant records; per stage its wall, reads/s,
   peak RSS, peak device memory and K1-K4 launches (align K1-K3 and htc
   K2-K4 each > 0), and a ``{"wgs_smoke": ...}`` line.
12. (run right after phase 11, on (a)'s dataset) the port's somatic,
   mesh, long-read, indel and joint-cohort rehearsals and its two
   Smith-Waterman bench scripts, each through its ``main`` on the card
   with every count at 0 just before it and read just after:
   ``mutect2_rehearsal`` on its own 1 Mb tumor/normal pair (25x each;
   K2/K3/K4 launched, somatic sensitivity and precision >= 0.9),
   ``mesh_rehearsal`` over (a)'s whole 0.6 Mb contig (htc on an 8-shard
   (data=4, region=2) mesh record-equal to no mesh), ``longread_rehearsal``
   (6 Mbp of ONT-class reads over (a)'s reference; K2/K3 and no other
   kernel, mapped >= 0.95), ``indel_rehearsal`` on (a)'s ``dedup.bam``
   (exit 0; reads realigned and launches printed), ``joint_cohort`` (5
   samples; its gate passes), ``bench_longread`` (16 reads of 10 kb) and
   ``bench_sw_parts`` (2240 lanes; its parts equal ``sw_extend_batch``,
   each part's ms printed); every Smith-Waterman (R, W) and PairHMM (R,
   H) bucket they launched, each once, held against the plain versions on
   that run's inputs as in phase 8; the K2-K4 rows' ``launches_by_path``
   gain each script; a ``{"rehearsals_smoke": ...}`` line and the phase's
   time.
13. (run right after phase 12, on phase 11(a)'s dataset) the host memory
   of the port's processes, each a fresh process on the card: (a)
   ``benchmarks/rss_probe.py`` from Python with numpy to the first K1-K4
   launches, one line a step (VmRSS, RssAnon, RssFile, threads, pinned
   bytes); no CUDA context before the first tensor on the card and one
   after it; (b) ``bqsr --device cuda`` through the CLI on (a)'s
   ``dedup.bam`` under the probe's ``--cli``: a command that launches no
   kernel exits 0 with no CUDA context in its process; (c) the same
   command as a child of ``rss_probe --watch``: its exit code passed
   through, a peak above 0 and the RssAnon / RssFile split at the peak
   present (from ``smaps`` where the status lacks it), and a child that
   exits 3 makes the probe exit 3.  Phase 11's lines carry each stage's
   peak RssAnon and RssFile beside its peak RSS.

The line before the last is a JSON object with one entry per kernel (its
launches on its path, error against the plain version, kernel, plain and
bound times; K2/K3 also their launches per path); the line before that
gives the pairs of every PairHMM call of phase 4's ``germline`` and phase
8's ``mutect2`` (``{"pairhmm_call_sizes": ...}``: calls, quantiles,
power-of-two bins); the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SW_SRC = "falcon_genome_tpu/ops/smith_waterman.py"
KERNELS = {   # name: (source, TPU kernel it replaces)
    "fgt_sw_score": ("falcon_genome_tpu_torch/csrc/smith_waterman.cu",
                     f"{SW_SRC}:141"),
    "fgt_sw_full": ("falcon_genome_tpu_torch/csrc/smith_waterman.cu",
                    f"{SW_SRC}:67"),
    "fgt_sw_traceback": ("falcon_genome_tpu_torch/csrc/smith_waterman.cu",
                         f"{SW_SRC}:944"),
    "fgt_pairhmm": ("falcon_genome_tpu_torch/csrc/pairhmm.cu",
                    "falcon_genome_tpu/ops/pairhmm.py:238"),
    "fgt_pairhmm_pb": ("falcon_genome_tpu_torch/csrc/pairhmm.cu",
                       "falcon_genome_tpu/ops/pairhmm.py:79"),
    "fgt_fma_ceiling": ("falcon_genome_tpu_torch/csrc/bench_kernels.cu",
                        "bench.py:161"),
    "fgt_sw_score_ablate": ("falcon_genome_tpu_torch/csrc/bench_kernels.cu",
                            "benchmarks/ablate_sw.py:25"),
}
# Published peaks of one H100 SXM at its 700 W limit: float32 outside the
# tensor cores (NVIDIA's data sheet) and HBM3.  For int32 the issue
# limit: one warp instruction per SM sub-partition per clock, 128 lanes
# per SM (integer adds, moves and IMADs also run on the FMA pipe, beside
# the 64 INT32 lanes), x 132 SMs x 1.98 GHz.
PEAK_F32 = 67e12
PEAK_INT32 = 128 * 132 * 1.98e9
PEAK_BYTES = 3.35e12
# operations per cell counted from the sources: Smith-Waterman E 3, F 3,
# substitution 2, H 4 (csrc/smith_waterman.cu, bench_kernels.cu);
# PairHMM M 5 (add, mul, fma, mul), I 3, D 3, an FMA counted as two
# (csrc/pairhmm.cu)
SW_OPS_PER_CELL = 12
PAIRHMM_FLOPS_PER_CELL = 11
# K3's latency floor: the cycles of one round trip of its walk with the
# pointers already on chip: a shared-memory load (~30 cycles), the
# shuffle of the cell that ends the run (~25) and 32 other dependent
# instructions at ~4.5 cycles (test, ballot, bit scan, the step, the next
# trip's addresses; read from the SASS of sw_traceback_kernel's loop at
# kDepth 2), at the card's 1.98 GHz
K3_TRIP_CYCLES = 30 + 25 + 4.5 * 32
SM_CLOCK = 1.98e9


# pairs a PairHMM call (``benchmarks.call_sizes.summary``), by command
CALL_SIZES: dict[str, dict] = {}
# lanes of phase 3's K2/K3 and K4 batches held against the golden models
GOLDEN_LANES = 64
# the golden models' tolerance against K4 (tests/test_pairhmm.py:73)
GOLDEN_PAIRHMM_TOL = 2e-3


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: the bytes the function must
    move over the memory rate, or its operations over ``rate``,
    whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / rate
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sw_cells(rl, wl, R: int, W: int) -> int:
    """Cells a score sweep needs: min(rlen, R) x min(wlen, W) per lane."""
    rl = np.minimum(rl.cpu().numpy().astype(np.int64), R)
    wl = np.minimum(wl.cpu().numpy().astype(np.int64), W)
    return int((rl * wl).sum())


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sw_sweep_counts(so: Path) -> None:
    """Phase 2 for Smith-Waterman: every instantiation of ``sw_kernel``
    (rows per thread NR, K2's pointer stream FULL, the stripe loop of
    R > 32 NR), its instructions per sweep step in the library's SASS and
    how many of them are integer max/min (IMNMX and the DPX forms)."""
    from falcon_genome_tpu_torch.benchmarks import sass
    names = sass.sass_names(so, r"9sw_kernelI")
    check(bool(names), "no sw_kernel in the library's SASS")
    for name in names:
        c = sass.sass_sweep_counts(so, re.escape(name), loop_by=sass.SHFL_UP,
                                   count=sass.MNMX, shfl_per_step=2)
        m = re.search(r"ILi(\d+)ELb(\d)ELb(\d)E", name)
        what = name if m is None else "sw_kernel<{}, {}, {}>".format(
            m.group(1), *("true" if g == "1" else "false"
                          for g in m.groups()[1:]))
        say(f"K1/K2 {what}: {c['per_step']:.1f} instructions per sweep "
            f"step, {c['counted_per_step']:.1f} of them integer max/min "
            f"({c['trip']} in a trip of {c['steps_per_trip']:.0f} steps)")


def ablate_sweep_counts(so: Path) -> None:
    """Phase 2 for K7: every instantiation of ``sw_ablate_kernel`` (rows
    per thread NR, the stripe loop, the flags no_best / no_mask /
    no_window) still holds its sweep loop, unrolled 8 steps a trip (or a
    multiple of 8) in the library's SASS (a variant whose sweep the
    compiler deleted would have none); those at R = 160 (NR = 5, the
    ablation's) hold all three of its loops (a compiler that drops the
    guarded steps before the band under the mask would leave two) and
    print their
    instructions per step in the unguarded loop and in the guarded loops
    before and after the band."""
    from falcon_genome_tpu_torch.benchmarks import sass
    names = sass.sass_names(so, r"16sw_ablate_kernelI")
    check(len(names) == 8 * 13,
          f"{len(names)} instantiations of sw_ablate_kernel, not 104")
    for name in names:
        loops = sass.sass_step_loops(so, re.escape(name))
        check(loops[0][0] >= 8 and loops[0][0] % 8 == 0,
              f"{name}: no sweep loop of 8 steps")
        m = re.search(r"ILi(\d+)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E", name)
        if m and m.group(1) == "5":
            check(len(loops) == 3, f"{name}: {len(loops)} sweep loops, not "
                  f"3 (guarded before the band, unguarded, guarded after)")
            what = "sw_ablate_kernel<5, {}, {}, {}, {}>".format(
                *("true" if g == "1" else "false" for g in m.groups()[1:]))
            say(f"K7 {what}: {loops[0][1]:.1f} instructions per sweep step"
                f", in the guarded loops (before the band, after it) "
                f"{', '.join(f'{n:.1f}' for _, n, _ in loops[1:])}")
    say(f"K7: all {len(names)} instantiations hold their sweep loop")


def walk_trips(torch, ptrs, best, bestpos, max_steps: int, cells: int):
    """Round trips of K3's walk per lane, replayed on the plain version's
    pointers (the walk of ``_traceback_core``): a trip starts where the
    walk does, after a cell that fails its phase's test (hdir 1 in H, the
    extend bit in E or F; it takes one step and ends the run) and after
    ``cells`` cells that pass (one trip's loads)."""
    D, R, B = ptrs.shape
    flat = ptrs.reshape(D * R, B)
    bestpos = bestpos.to(torch.int32)
    d_prog = torch.div(bestpos, 4096, rounding_mode="floor")
    i = bestpos - d_prog * 4096 + 1
    j = d_prog - i + 1
    phase = torch.zeros_like(i)
    active = best > 0
    run = torch.zeros_like(i)
    trips = torch.zeros_like(i)
    for _ in range(max_steps):
        if not bool(active.any()):
            break
        trips += (active & (run == 0)).int()
        idx = ((i + j - 1) * R + (i - 1)).clamp(0, D * R - 1)
        byte = flat.gather(0, idx[None].long())[0].int()
        hdir = byte & 3
        ok = active & (i > 0) & (j > 0)
        passes = ok & torch.where(phase == 0, hdir == 1, torch.where(
            phase == 1, (byte >> 2) & 1 == 1, (byte >> 3) & 1 == 1))
        run = torch.where(passes, (run + 1) % cells, 0)
        is_h = phase == 0
        stop = ok & is_h & (hdir == 0)
        do_m = ok & is_h & (hdir == 1)
        in_e = ok & ((phase == 1) | (is_h & (hdir == 2)))
        in_f = ok & ((phase == 2) | (is_h & (hdir == 3))) & ~in_e
        moving = ok & ~stop
        i = i - (moving & (do_m | in_f)).int()
        j = j - (moving & (do_m | in_e)).int()
        phase = torch.where(in_e & ((byte >> 2) & 1 == 1), 1, torch.where(
            in_f & ((byte >> 3) & 1 == 1), 2, 0))
        active = moving
    return trips + (active & (run == 0)).int()


def k3_cells_per_trip() -> int:
    """32 lanes x ``kDepth`` cells: the pointers one trip of K3 loads."""
    src = (REPO / KERNELS["fgt_sw_traceback"][0]).read_text()
    m = re.search(r"constexpr int kDepth = (\d+);", src)
    check(m is not None, "no kDepth in the Smith-Waterman source")
    return 32 * int(m.group(1))


# ---------------------------------------------------------------------------
# phase 3 inputs: main-path shapes
# ---------------------------------------------------------------------------

def sw_lanes(rng, genome, B, R, W, rl_range, sub=0.01, decoys=0.25):
    """Reads sampled from ``genome`` with ``sub`` substitutions, against
    windows that hold them (a ``decoys`` share of windows are elsewhere)."""
    rl = rng.integers(rl_range[0], rl_range[1] + 1, B).astype(np.int32)
    wl = np.full(B, W - 8, np.int32)
    read = np.full((B, R), 4, np.int8)
    win = np.empty((B, W), np.int8)
    for b in range(B):
        w0 = int(rng.integers(0, len(genome) - W))
        win[b] = genome[w0:w0 + W]
        s = w0 + int(rng.integers(0, W - 8 - rl[b]))
        if rng.random() < decoys:
            s = int(rng.integers(0, len(genome) - rl[b]))
        seg = genome[s:s + rl[b]].copy()
        m = rng.random(rl[b]) < sub
        seg[m] = (seg[m] + 1) % 4
        read[b, :rl[b]] = seg
    return read, rl, win, wl


def hap_lanes(rng, B, R, W):
    """HaplotypeCaller hap → region-reference lanes: haplotypes are the
    region with a SNP and an indel."""
    read = np.full((B, R), 4, np.int8)
    win = rng.integers(0, 4, (B, W)).astype(np.int8)
    rl = np.zeros(B, np.int32)
    wl = rng.integers(W - 80, W + 1, B).astype(np.int32)
    for b in range(B):
        ref = win[b, :wl[b]].copy()
        p = int(rng.integers(20, len(ref) - 20))
        ref[p] = (ref[p] + 1) % 4
        q = int(rng.integers(20, len(ref) - 20))
        L = int(rng.integers(1, 8))
        hap = (np.concatenate([ref[:q], ref[q + L:]]) if b % 2 else
               np.concatenate([ref[:q], rng.integers(0, 4, L), ref[q:]]))
        hap = hap[:R].astype(np.int8)
        read[b, :len(hap)] = hap
        rl[b] = len(hap)
    return read, rl, win, wl


def indel_planes(rng, rlen, R):
    """Per-base insertion/deletion phreds 25-45 varying along each read
    (as BQSR's BI/BD tags), gap continuation 10, phred 0 past rlen."""
    B = len(rlen)
    ins = rng.integers(25, 46, (B, R)).astype(np.uint8)
    dele = rng.integers(25, 46, (B, R)).astype(np.uint8)
    gcp = np.full((B, R), 10, np.uint8)
    pad = np.arange(R)[None, :] >= rlen[:, None]
    for x in (ins, dele, gcp):
        x[pad] = 0
    return ins, dele, gcp


def pad_row_pairs(rng, n, R, H):
    """Pairs only the rescale keeps finite, with pad rows (see
    tests/test_torch_kernels.pad_row_pairs): quality-0 reads of R-10 to
    R-1 bases against 12-20 base haplotypes, gap continuation phred 5."""
    reads = np.ones((n, R), np.uint8)
    q = np.zeros((n, R), np.uint8)
    rl = rng.integers(R - 10, R, n).astype(np.int32)
    hl = rng.integers(12, 21, n).astype(np.int32)
    haps = np.zeros((n, H), np.uint8)
    for b in range(n):
        haps[b, hl[b]:] = 4
    ins, dele, gcp = indel_planes(rng, rl, R)
    gcp[gcp > 0] = 5
    return reads, q, ins, dele, gcp, rl, haps, hl


def edge_lanes(rng, B, R, H):
    """K5 lanes (read, q, ins, del, gcp, rlen, hap, hlen) for a bucket:
    reads cut from their haplotypes with 4% substitutions, and in the
    first 12 lanes the edges of the sweep: hlen = H, rlen = R, rlen = 1,
    rlen + hlen odd and even at the largest sum, N runs, codes above 4,
    every code 0-15 at random, a one-base haplotype, a one-cell matrix."""
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    rl = rng.integers(R // 2, R + 1, B).astype(np.int32)
    hl = rng.integers(R, H + 1, B).astype(np.int32)
    for b in range(B):
        s = int(rng.integers(0, hl[b] - rl[b] + 1))
        seg = haps[b, s:s + rl[b]].copy()
        m = rng.random(rl[b]) < 0.04
        seg[m] = (seg[m] + 1) % 4
        reads[b, :rl[b]] = seg
    hl[0] = H
    rl[1], reads[1] = R, rng.integers(0, 4, R)
    rl[2] = 1
    rl[3], hl[3] = R, H
    rl[4], hl[4] = R - 1, H
    reads[5, ::3] = 4
    haps[6, ::5] = 4
    reads[7, 1], haps[7, 3] = 7, 9
    haps[8] = rng.integers(0, 16, H)
    reads[9] = rng.integers(0, 16, R)
    hl[10] = 1
    rl[11], hl[11] = 1, 1
    q = rng.integers(10, 41, (B, R)).astype(np.uint8)
    return (reads, q, *indel_planes(rng, rl, R), rl, haps, hl)


EARLY_RESCALE_PHREDS = (45, 0, 13)   # ins, del, gcp


def early_rescale_lanes(R, H):
    """K5 lanes whose rescale fires at diagonal 64, the first test (see
    tests/test_torch_kernels.early_rescale_pairs): quality-0 reads of 52,
    64, 65 and 70 bases that mismatch all 12 bases of their haplotype,
    with ins/del/gcp phreds 45/0/13; the first ends on that diagonal."""
    rl = np.array([52, 64, 65, 70], np.int32)
    n = len(rl)
    real = np.arange(R)[None, :] < rl[:, None]
    reads = np.where(real, 1, 4).astype(np.uint8)
    haps = np.zeros((n, H), np.uint8)
    haps[:, 12:] = 4
    planes = [np.where(real, v, 0).astype(np.uint8)
              for v in EARLY_RESCALE_PHREDS]
    return (reads, np.zeros((n, R), np.uint8), *planes, rl, haps,
            np.full(n, 12, np.int32))


def hold_pairhmm(torch, name: str, got, want) -> tuple[float, int]:
    """A PairHMM kernel's result against the plain version's: the same
    -inf lanes and the same bits elsewhere.  Returns the largest
    difference and the number of finite pairs that are not bit-equal
    (both 0, or the check fails)."""
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)),
          f"{name}: -inf lanes differ from the plain version")
    if not bool(fin.any()):
        return 0.0, 0
    err = float((got[fin] - want[fin]).abs().max())
    n = int((got[fin].view(torch.int32) != want[fin].view(torch.int32)).sum())
    check(n == 0, f"{name}: {n} finite pairs are not bit-equal to the plain "
          f"version (largest difference {err})")
    return err, n


def pairhmm_edges(torch, P, to) -> float:
    """K4 and K5 against the plain version in small batches at the other
    row counts the dispatch instantiates (one and eight rows per thread,
    a bucket that does not fill its threads' rows) and at the sweep's
    edges, and on pairs rescaled at diagonal 64.  Returns the largest
    difference."""
    worst = 0.0
    for R, H in ((8, 128), (96, 128), (256, 512), (150, 512)):
        sets = [("edges", edge_lanes(np.random.default_rng(R), 256, R, H),
                 (45, 45, 10))]
        if R >= 96:
            sets.append(("rescaled at d=64", early_rescale_lanes(R, H),
                         EARLY_RESCALE_PHREDS))
        for label, lanes, sc in sets:
            a = to(*lanes)
            want5 = P._pairhmm_plain(*(x.T for x in a[:5]), a[5][None],
                                     a[7][None], a[6].T, R=R, H=H)
            want4 = P._pairhmm_plain(a[0].T, a[1].T, *sc, a[5][None],
                                     a[7][None], a[6].T, R=R, H=H)
            e4, n4 = hold_pairhmm(torch, f"K4 R={R} H={H} {label}",
                                  P.pairhmm_sc(a[0], a[1], a[5], a[6], a[7],
                                               *sc), want4)
            e5, n5 = hold_pairhmm(torch, f"K5 R={R} H={H} {label}",
                                  P.pairhmm_pb(*a), want5)
            finite = (int(torch.isfinite(want4).sum()),
                      int(torch.isfinite(want5).sum()))
            check(label == "edges" or finite == (len(a[5]),) * 2,
                  f"R={R} H={H}: a pair rescaled at d=64 is -inf")
            say(f"K4/K5 R={R} H={H} B={len(a[5])} {label}: max |dlog10| "
                f"{e4:.3g} / {e5:.3g}, not bit-equal {n4} / {n5}, finite "
                f"{finite[0]} / {finite[1]}, -inf lanes equal")
            worst = max(worst, e4, e5)
    return worst


def prob_table_check(torch, P, quals) -> None:
    """The kernels' 256-entry phred table on the card against the port's
    table (the reference's powf bits, which the CPU tests hold to the
    reference): bit-equal for every phred, and through a plane."""
    dev = quals.device
    q = torch.arange(256, dtype=torch.uint8, device=dev)
    table = P._prob_table(dev)
    plane = torch.cat([quals.flatten(), q])
    check(torch.equal(table.cpu(), P._prob_table(torch.device("cpu")))
          and torch.equal(table, P._phred_to_prob(q))
          and torch.equal(table[plane.long()], P._phred_to_prob(plane)),
          "the phred table on the card differs from the port's table")
    say(f"phred table: on the card equal to the port's table, and "
        f"table[q] == _phred_to_prob(q) bit for bit for q = 0..255 and "
        f"through a plane of {plane.numel()} phreds")


def reference_bits_check(torch, P, to) -> None:
    """K4 (45/45/10) and K5 (the stored planes) on the card on the 128
    seeded pairs of ``tests/data/pairhmm_reference_bits.npz``, against the
    reference's ``_pairhmm_jax`` bits stored with them (made on the CPU by
    the JAX package; ``tests/test_torch_pairhmm_fixture.py`` regenerates
    them): the same -inf lanes and the same bits on every finite lane."""
    f = np.load(REPO / "tests" / "data" / "pairhmm_reference_bits.npz")
    reads, q, rl, haps, hl, ins, dele, gcp = to(
        *(f[k] for k in ("reads", "q", "rl", "haps", "hl", "ins", "dele",
                         "gcp")))
    for name, got, want in (
            ("K4", P.pairhmm_sc(reads, q, rl, haps, hl, 45, 45, 10),
             f["logp_sc"]),
            ("K5", P.pairhmm_pb(reads, q, ins, dele, gcp, rl, haps, hl),
             f["logp_pb"])):
        got = got.cpu().numpy()
        fin = np.isfinite(want)
        check(np.array_equal(np.isfinite(got), fin)
              and np.array_equal(np.isneginf(got), np.isneginf(want)),
              f"{name}: -inf lanes differ from the reference's fixture")
        n = int((got[fin].view(np.uint32) != want[fin].view(np.uint32)).sum())
        check(n == 0, f"{name}: {n} of {int(fin.sum())} finite pairs differ "
              f"from the reference's bits in the fixture")
        say(f"{name} on the fixture's {len(want)} pairs (160/384): bit-equal "
            f"to the reference's _pairhmm_jax on all {int(fin.sum())} finite "
            f"pairs, -inf lanes equal ({int((~fin).sum())})")


def phase_kernels(torch, S, P, results) -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 1_000_000).astype(np.int8)

    def to(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in xs]

    # K1: candidate ranking, aligner bucket 160 x 256, 8192 lanes
    read, rl, win, wl = to(*sw_lanes(rng, genome, 8192, 160, 256,
                                     (150, 150)))
    p = S.SWParams()
    ks, kp = S.sw_score(read, rl, win, wl, p)
    _, ps, pp = S._plain_scan(read, rl, win, wl, p)
    torch.cuda.synchronize()
    err = max(int((ks - ps[0]).abs().max()), int((kp - pp[0]).abs().max()))
    check(err == 0, "K1 sw_score differs from the plain sweep")
    t_k = cuda_ms(torch, lambda: S.sw_score(read, rl, win, wl, p), 5)
    t_p = cuda_ms(torch, lambda: S._plain_scan(read, rl, win, wl, p), 2)
    say(f"K1 fgt_sw_score R=160 W=256 B=8192: bit-equal scores+bestpos, "
        f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
    results["fgt_sw_score"] = dict(
        max_abs_err=err, ms=t_k, plain_ms=t_p,
        **bound(read.numel() + win.numel() + 16 * read.shape[0],
                SW_OPS_PER_CELL * sw_cells(rl, wl, 160, 256), PEAK_INT32))

    # K2 + K3: aligner winners, mate rescue, HaplotypeCaller hap → ref
    shapes = [
        ("aligner winners", S.SWParams(), 8192, 160, 256,
         sw_lanes(rng, genome, 8192, 160, 256, (150, 150))),
        ("mate rescue", S.SWParams(), 2048, 160, 1024,
         sw_lanes(rng, genome, 2048, 160, 1024, (150, 150))),
        ("htc hap->ref", S.SWParams(2, 6, 12, 1), 1024, 384, 384,
         hap_lanes(rng, 1024, 384, 384)),
    ]
    k2, k3 = [], []
    golden = {}
    for label, p, B, R, W, lanes in shapes:
        read, rl, win, wl = to(*lanes)
        steps = (R + W if label.startswith("htc") else
                 S._traceback_steps_bound(int(rl.max()), int(wl.max()), p,
                                          S.SWBucket(R, W)))
        kptr, kbest, kpos = S.sw_pointers(read, rl, win, wl, p)
        kout = S.sw_traceback(kptr, kbest, kpos, steps)
        pptr, pbest, ppos = S._plain_scan(read, rl, win, wl, p)
        pout = S._traceback_core(pptr, pbest[0], ppos[0], max_steps=steps)
        torch.cuda.synchronize()
        e2 = max(int((kbest - pbest[0]).abs().max()),
                 int((kpos - ppos[0]).abs().max()))
        e3 = max(int((a.int() - b.int()).abs().max())
                 for a, b in zip(kout, pout))
        check(e2 == 0 and e3 == 0,
              f"K2/K3 differ from the plain versions ({label})")
        t2 = cuda_ms(torch, lambda: S.sw_pointers(read, rl, win, wl, p), 3)
        t3 = cuda_ms(torch, lambda: S.sw_traceback(kptr, kbest, kpos,
                                                   steps), 5)
        t2p = cuda_ms(torch, lambda: S._plain_scan(read, rl, win, wl, p), 1)
        t3p = cuda_ms(torch, lambda: S._traceback_core(
            pptr, pbest[0], ppos[0], max_steps=steps), 1)
        # K2 writes its pointer array, 4 bits a cell over the R rows and
        # W + 31 steps of a lane (``_pointer_shape``); K3 reads the 4-bit
        # pointer of each step it walks (the 2-bit ops it emits)
        packed = kout[0].cpu().numpy()
        walk = sum(((packed >> s) & 3) != 0 for s in (0, 2, 4, 6)).sum(0)
        walked = int(walk.sum())
        mapped = kbest.cpu().numpy() > 0
        trips = walk_trips(torch, pptr, pbest[0], ppos[0], steps,
                           k3_cells_per_trip()).cpu().numpy()
        ptr_bytes = kptr.numel() * kptr.element_size()
        b2 = bound(read.numel() + win.numel() + 16 * B + ptr_bytes,
                   SW_OPS_PER_CELL * sw_cells(rl, wl, R, W), PEAK_INT32)
        b3 = bound(walked / 2 + packed.size + 24 * B, 0, PEAK_INT32)
        # latency floors: the longest chain of round trips, and a walk of
        # one step a round trip, each trip at K3_TRIP_CYCLES
        floor3 = int(trips.max()) * K3_TRIP_CYCLES / SM_CLOCK * 1e3
        floor_step = int(walk.max()) * K3_TRIP_CYCLES / SM_CLOCK * 1e3
        say(f"K2+K3 {label} R={R} W={W} B={B} params={tuple(vars(p).values())}"
            f": bit-equal best, bestpos, op streams, coords; "
            f"K2 kernel {t2:.3f} ms plain {t2p:.3f} ms bound "
            f"{b2['bound_ms']:.3f} ms ({b2['bound_by']}; pointers "
            f"{ptr_bytes / B:.0f} B a lane against (R + W) R = "
            f"{(R + W) * R} before); K3 kernel {t3:.3f} ms plain "
            f"{t3p:.3f} ms byte bound {b3['bound_ms']:.4f} ms latency "
            f"floor {floor3:.4f} ms ({int(trips.max())} round trips of "
            f"the longest chain at {K3_TRIP_CYCLES:.0f} cycles; "
            f"{floor_step:.4f} ms for a step a trip) (max_steps {steps}, "
            f"{walked} steps walked, walk per mapped lane mean "
            f"{walk[mapped].mean() if mapped.any() else 0:.1f} longest "
            f"{int(walk.max())}, round trips mean "
            f"{trips[mapped].mean() if mapped.any() else 0:.2f}, mapped "
            f"{int(mapped.sum())}/{B})")
        if label == "aligner winners":
            # the golden Smith-Waterman model's lanes (phase 10)
            n = GOLDEN_LANES
            golden["sw"] = dict(
                lanes=[np.array(x[:n]) for x in lanes], params=p,
                steps=steps, best=kbest[:n].cpu().numpy(),
                packed=kout[0][:, :n].cpu().numpy(),
                coords=kout[1][:, :n].cpu().numpy())
        k2.append((e2, t2, t2p, b2))
        k3.append((e3, t3, t3p, b3))
        del kptr, pptr
    # the aligner-winner shape is the main path's; the others are printed
    results["fgt_sw_full"] = dict(max_abs_err=max(k[0] for k in k2),
                                  ms=k2[0][1], plain_ms=k2[0][2], **k2[0][3])
    results["fgt_sw_traceback"] = dict(max_abs_err=max(k[0] for k in k3),
                                       ms=k3[0][1], plain_ms=k3[0][2],
                                       **k3[0][3])

    # K4: HaplotypeCaller PairHMM, R=160, H=384, 8192 pairs, 45/45/10
    B, R, H = 8192, 160, 384
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    hl = rng.integers(250, H + 1, B).astype(np.int32)
    rlen = rng.integers(100, 153, B).astype(np.int32)
    reads = np.full((B, R), 4, np.uint8)
    for b in range(B):
        s = int(rng.integers(0, hl[b] - rlen[b]))
        seg = haps[b, s:s + rlen[b]].copy()
        m = rng.random(rlen[b]) < 0.01
        seg[m] = (seg[m] + 1) % 4
        reads[b, :rlen[b]] = seg
    unrelated = rng.random(B) < 0.125
    reads[unrelated] = rng.integers(0, 4, (int(unrelated.sum()), R))
    rlen[unrelated] = 150
    quals = rng.integers(10, 41, (B, R)).astype(np.uint8)
    # pairs only the rescaling keeps finite (see tests/test_torch_pairhmm)
    resc = np.arange(B - 64, B)
    unrelated[resc] = False
    reads[resc], quals[resc], haps[resc] = 1, 0, 0
    rlen[resc] = rng.integers(156, 161, len(resc))
    hl[resc] = rng.integers(170, 201, len(resc))
    for b in resc:
        haps[b, hl[b]:] = 4
    args = to(reads, quals, rlen, haps, hl)
    prob_table_check(torch, P, args[1])
    reference_bits_check(torch, P, to)
    kl = P.pairhmm_sc(*args, 45, 45, 10)
    # the golden PairHMM model's pairs (phase 10)
    golden["hmm"] = dict(
        lanes=[np.array(x[:GOLDEN_LANES]) for x in (reads, quals, rlen,
                                                    haps, hl)],
        logp=kl[:GOLDEN_LANES].cpu().numpy(), trans=(45, 45, 10),
        unrelated=unrelated[:GOLDEN_LANES].copy())
    pl = P._pairhmm_plain(args[0].T, args[1].T, 45, 45, 10, args[2][None],
                          args[4][None], args[3].T, R=R, H=H)
    e4, n4 = hold_pairhmm(torch, "K4", kl, pl)
    fin = torch.isfinite(pl)
    n_resc = int(fin.cpu().numpy()[resc].sum())
    check(n_resc == len(resc), "K4 rescaling pairs floored to -inf")
    t4 = cuda_ms(torch, lambda: P.pairhmm_sc(*args, 45, 45, 10), 5)
    t4p = cuda_ms(torch, lambda: P._pairhmm_plain(
        args[0].T, args[1].T, 45, 45, 10, args[2][None], args[4][None],
        args[3].T, R=R, H=H), 2)
    inf_related = int((~fin).cpu().numpy()[~unrelated].sum())
    say(f"K4 fgt_pairhmm R={R} H={H} B={B} 45/45/10, quals 10-40: "
        f"max |dlog10| {e4:.3g} on {int(fin.sum())} finite pairs, {n4} "
        f"not bit-equal; -inf "
        f"lanes equal: {int((~fin).sum())} ({int(unrelated.sum())} pairs "
        f"unrelated, {inf_related} -inf among related); {n_resc} pairs "
        f"finite only through rescaling; kernel {t4:.3f} ms,"
        f" plain {t4p:.3f} ms")
    cells = int((rlen.astype(np.int64) * hl).sum())
    results["fgt_pairhmm"] = dict(
        max_abs_err=e4, ms=t4, plain_ms=t4p,
        **bound(2 * B * R + B * H + 12 * B, PAIRHMM_FLOPS_PER_CELL * cells,
                PEAK_F32))
    e_crafted = max(crafted_pairs(torch, P, rng, R, H, to),
                    pairhmm_edges(torch, P, to))

    # K5: the same pairs with per-base transition planes; the last 64
    # lanes are pad-row pairs that only the rescale keeps finite
    ins, dele, gcp = indel_planes(rng, rlen, R)
    lanes = [reads, quals, ins, dele, gcp, rlen, haps, hl]
    for x, c in zip(lanes, pad_row_pairs(rng, 64, R, H)):
        x[resc] = c
    k5_args = to(*lanes)

    def plain5(a):
        return P._pairhmm_plain(a[0].T, a[1].T, a[2].T, a[3].T, a[4].T,
                                a[5][None], a[7][None], a[6].T, R=R, H=H)

    kl = P.pairhmm_pb(*k5_args)
    pl = plain5(k5_args)
    e5, n5 = hold_pairhmm(torch, "K5", kl, pl)
    fin = torch.isfinite(pl)
    n_craft = int(fin.cpu().numpy()[resc].sum())
    check(n_craft == len(resc), "K5 crafted pad-row pairs floored to -inf")
    thresh = P.RESCALE_THRESH
    P.RESCALE_THRESH = 0.0
    try:
        craft = plain5([a[resc[0]:] for a in k5_args])
    finally:
        P.RESCALE_THRESH = thresh
    check(not bool(torch.isfinite(craft).any()),
          "K5 crafted pairs are finite without the rescale")
    t5 = cuda_ms(torch, lambda: P.pairhmm_pb(*k5_args), 5)
    t5p = cuda_ms(torch, lambda: plain5(k5_args), 2)
    say(f"K5 fgt_pairhmm_pb R={R} H={H} B={B}, ins/del phreds 25-45 along "
        f"each read, gcp 10, phred 0 past rlen: max |dlog10| {e5:.3g} on "
        f"{int(fin.sum())} finite pairs, {n5} not bit-equal; -inf lanes "
        f"equal: {int((~fin).sum())}; {n_craft} crafted pad-row pairs finite, "
        f"-inf without the rescale; kernel {t5:.3f} ms, plain {t5p:.3f} ms")
    cells = int((lanes[5].astype(np.int64) * lanes[7]).sum())
    results["fgt_pairhmm_pb"] = dict(
        max_abs_err=max(e5, e_crafted), ms=t5, plain_ms=t5p,
        **bound(5 * B * R + B * H + 12 * B, PAIRHMM_FLOPS_PER_CELL * cells,
                PEAK_F32))
    results["fgt_pairhmm"]["max_abs_err"] = max(e4, e_crafted)
    return k5_args, golden


def rescale_pairs(rng, n, R, H):
    """PR 1's quality-0 rescue pairs (tests/test_torch_kernels.
    rescale_pairs): reads of quality 0 that mismatch every base of a
    haplotype a little longer than themselves, so the state falls below
    2^-60, through float32's subnormal range, before the rescale; the
    last pair's likelihood is subnormal itself."""
    reads = np.ones((n, R), np.uint8)
    q = np.zeros((n, R), np.uint8)
    rl = rng.integers(R - 4, R + 1, n).astype(np.int32)
    hl = rng.integers(170, 201, n).astype(np.int32)
    rl[-1], hl[-1] = 155, H
    haps = np.zeros((n, H), np.uint8)
    for b in range(n):
        haps[b, hl[b]:] = 4
    return reads, q, rl, haps, hl


def crafted_pairs(torch, P, rng, R, H, to) -> float:
    """K4 (45/45/10) and K5 (BI/BD-like planes) on the rescue pairs
    against their plain versions, which flush every operation as the
    reference does: bit-equal, the same -inf lanes."""
    reads, q, rl, haps, hl = rescale_pairs(rng, 64, R, H)
    a = to(reads, q, rl, haps, hl)
    pl = to(*indel_planes(rng, rl, R))
    worst = 0.0
    for name, kern, plain in (
            ("K4 45/45/10", lambda: P.pairhmm_sc(*a, 45, 45, 10),
             lambda: P._pairhmm_plain(a[0].T, a[1].T, 45, 45, 10,
                                      a[2][None], a[4][None], a[3].T,
                                      R=R, H=H)),
            ("K5 planes", lambda: P.pairhmm_pb(a[0], a[1], *pl, a[2], a[3],
                                               a[4]),
             lambda: P._pairhmm_plain(a[0].T, a[1].T, *(x.T for x in pl),
                                      a[2][None], a[4][None], a[3].T,
                                      R=R, H=H))):
        want = plain()
        e, n = hold_pairhmm(torch, f"{name}, rescue pairs", kern(), want)
        fin = torch.isfinite(want)
        check(bool(fin.any()), f"{name}: every rescue pair is -inf")
        say(f"{name} on 64 quality-0 rescue pairs (mass through float32's "
            f"subnormal range, rescaled at diagonal 320, the last multiple "
            f"of 64 of their sweeps): max |dlog10| {e:.3g} on "
            f"{int(fin.sum())} finite pairs, {n} not bit-equal, -inf lanes "
            f"equal")
        worst = max(worst, e)
    return worst


# ---------------------------------------------------------------------------
# phases 4-5: the germline slice through the CLI
# ---------------------------------------------------------------------------

class StageClock(logging.Handler):
    """Timestamps of the stage-completion log lines of ``germline``."""
    MARKS = (("align", lambda m: m.startswith("align[") and "records" in m),
             ("markdup", lambda m: m.startswith("markdup")),
             ("bqsr", lambda m: m.startswith("printreads →")),
             ("htc", lambda m: m.startswith("htc →")))

    def __init__(self):
        super().__init__(logging.INFO)
        self.t: dict[str, float] = {}

    def emit(self, record):
        msg = record.getMessage()
        for name, hit in self.MARKS:
            if name not in self.t and hit(msg):
                self.t[name] = record.created


def run_germline(cli, sample, out: Path, device: str,
                 options: tuple[str, ...] = ()) -> dict:
    clock = StageClock()
    logging.getLogger("falcon_genome_tpu").addHandler(clock)
    t0 = time.time()
    try:
        rc = cli.main(["--device", device, "germline", "-r", sample.ref,
                       "-1", sample.fastq1, "-2", sample.fastq2,
                       "-o", str(out), "-v", "-f", *options])
    finally:
        logging.getLogger("falcon_genome_tpu").removeHandler(clock)
    check(rc == 0, f"germline --device {device} exited {rc}")
    wall = time.time() - t0
    stages, prev = {}, t0
    for name, _ in StageClock.MARKS:
        check(name in clock.t, f"no completion line for stage {name}")
        stages[name] = clock.t[name] - prev
        prev = clock.t[name]
    return dict(wall=wall, stages=stages)


def phase_germline(torch, cli, S, P, validate, work: Path, results) -> None:
    from falcon_genome_tpu_torch.benchmarks.call_sizes import (
        PairHMMCalls, summary as call_summary)
    t0 = time.time()
    sample = validate.simulate_sample(work / "1mb", 1_000_000, 30, seed=1)
    n_reads = 2 * sample.n_pairs
    say(f"germline sample: one 1 Mb contig (genome length cut from a 3.1 Gb "
        f"human genome to fit the smoke's time; widths as in production), "
        f"{sample.n_pairs} pairs x 2 x 150 bp (30x), {len(sample.snps)} het "
        f"SNPs, {len(sample.indels)} indels, simulated in "
        f"{time.time() - t0:.1f} s")
    for d in (S.LAUNCHES, P.LAUNCHES):
        for k in d:
            d[k] = 0
    torch.cuda.synchronize()
    with PairHMMCalls() as calls:
        r = run_germline(cli, sample, work / "1mb" / "calls.vcf.gz", "cuda")
    torch.cuda.synchronize()
    CALL_SIZES["germline"] = call_summary(calls.sizes)
    # germline runs K1-K4; K5 (per-base planes) is phase 6's
    launches = {k: n for k, n in {**S.LAUNCHES, **P.LAUNCHES}.items()
                if k != "fgt_pairhmm_pb"}
    for name, sec in r["stages"].items():
        say(f"germline stage {name}: {sec:.2f} s, "
            f"{n_reads / max(sec, 1e-9):.0f} reads/s")
    say(f"germline wall {r['wall']:.2f} s, {n_reads / r['wall']:.0f} reads/s,"
        f" kernel launches {launches}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched by germline")
        results[k]["launches"] = n
    acc = validate.score_calls(str(work / "1mb" / "calls.vcf.gz"), sample)
    say(f"germline accuracy vs planted truth: {json.dumps(acc)}")
    check(acc["snp_sensitivity"] >= 0.98 and acc["precision"] >= 0.98,
          "germline SNP sensitivity or precision below 0.98")
    germline_1mb = (sample, work / "1mb" / "calls.vcf.gz.work",
                    work / "1mb" / "calls.vcf.gz")

    # phase 5: plain versions on the CPU vs kernels on the card, 50 kb
    sample = validate.simulate_sample(work / "50kb", 50_000, 30, seed=2)
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = work / "50kb" / f"{dev}.vcf.gz"
        # one caller thread: the plain versions' own thread pool is
        # oversubscribed when several shards run at once
        r = run_germline(cli, sample, out[dev], dev,
                         ("-O", "gatk.nprocs=1"))
        say(f"50 kb germline --device {dev}: {r['wall']:.2f} s "
            f"(stages {json.dumps(r['stages'])})")
    cmp_ = validate.compare_runs(
        str(out["cpu"]) + ".work", str(out["cuda"]) + ".work",
        str(out["cpu"]), str(out["cuda"]))
    say(f"50 kb cpu vs cuda: {json.dumps(cmp_)}")
    check(all(same for same, _ in cmp_["bam"].values()),
          "50 kb BAMs differ between --device cpu and --device cuda")
    check(cmp_["vcf_equivalent"] and cmp_["vcf_non_concordant"] == 0,
          "50 kb VCFs differ between --device cpu and --device cuda")
    return sample, Path(str(out["cuda"]) + ".work"), germline_1mb


# ---------------------------------------------------------------------------
# phase 11: the out-of-core germline path (the port's WGS rehearsal)
# ---------------------------------------------------------------------------

# what forces every out-of-core path at the rehearsal's smoke scale
OUT_OF_CORE = ["tpu.align.spill_mb=0", "tpu.bam.stream_mb=0"]
# the rehearsal's own accuracy rule (benchmarks/wgs_rehearsal.py)
WGS_SENSITIVITY, WGS_PRECISION = 0.99, 0.999
# kernels each stage of the path must launch: align K1-K3, htc K2-K4
WGS_LAUNCHED = {"align": ("fgt_sw_score", "fgt_sw_full", "fgt_sw_traceback"),
                "htc": ("fgt_sw_full", "fgt_sw_traceback", "fgt_pairhmm")}


def phase_wgs(torch, S, P, validate, work: Path) -> None:
    """(a) ``wgs_rehearsal`` at its smoke scale (0.6 Mb, 50 k pairs, 25x,
    600 SNPs) with every stage forced out of core: align's bucket spill,
    markdup streamed over the 256-bucket tree, bqsr streaming
    ``dedup.bam`` through its ``.bai``, htc region-pruned over the
    recalibrated tree; (b) the same dataset and stages in memory (the
    default thresholds), record-equal to (a)."""
    from falcon_genome_tpu_torch.benchmarks import wgs_rehearsal as W
    from falcon_genome_tpu_torch.io import native_ext
    from falcon_genome_tpu_torch.stages.bamstages import BamInputSource
    check(native_ext.available(),
          "phase 11: the native library is not available (align and "
          "markdup would fall back to memory)")
    W.G, W.N_PAIRS, W.N_SNPS = W.scale(W.SMOKE_MB)
    t0 = time.time()
    W.gen_dataset(work / "ooc")
    (work / "mem").mkdir(parents=True)
    for name in ("ref.fa", "r_1.fastq", "r_2.fastq", "truth.npy",
                 "dataset.json"):
        (work / "mem" / name).symlink_to((work / "ooc" / name).resolve())
    say(f"phase 11 dataset: {W.G / 1e6:g} Mb, {W.N_PAIRS} pairs x 2 x "
        f"{W.READ_LEN} bp (25x), {W.N_SNPS} het SNPs, written in "
        f"{time.time() - t0:.1f} s")
    device = torch.device("cuda", torch.cuda.current_device())
    runs = {}
    for name, options in (("ooc", OUT_OF_CORE), ("mem", [])):
        conf = W.make_conf(work / name, options)
        for d in (S.LAUNCHES, P.LAUNCHES):
            for k in d:
                d[k] = 0
        torch.cuda.synchronize()
        res = W.rehearse(work / name, set(W.STAGES.values()), device, conf,
                         {})
        torch.cuda.synchronize()
        launches = {k: n for k, n in {**S.LAUNCHES, **P.LAUNCHES}.items()
                    if k != "fgt_pairhmm_pb"}
        label = {"ooc": "11a out of core", "mem": "11b in memory"}[name]
        for stage in W.STAGES.values():
            r = res[stage]
            say(f"phase {label}, {stage}: {r['wall_s']} s, "
                f"{r['reads_per_s']} reads/s, peak RSS {r['peak_rss_gb']} "
                f"GB (RssAnon {r['peak_rss_anon_gb']} GB, RssFile "
                f"{r['peak_rss_file_gb']} GB; RssAnon added "
                f"{r['rss_anon_added_gb']}, left {r['rss_anon_left_gb']} "
                f"GB), peak device memory {r['peak_device_gb']} GB, "
                f"launches {json.dumps(r['launches'])}, path {r['path']}")
        for stage, kernels in WGS_LAUNCHED.items():
            for k in kernels:
                check(res[stage]["launches"][k] > 0,
                      f"phase {label}: {stage} did not launch {k}")
        say(f"phase {label}: kernel launches {json.dumps(launches)}, "
            f"{res['germline_e2e_reads_per_s']} reads/s over the four "
            f"stages")
        runs[name] = (conf, res)

    conf, res = runs["ooc"]
    out = W.outputs(work / "ooc")
    check(res["align"]["path"] == "bucket spill",
          "phase 11a: align did not log its bucket-spill dataflow")
    check(res["markdup"]["path"] == "streamed",
          "phase 11a: markdup did not stream the bucket tree")
    check(BamInputSource.from_conf(conf, out["dedup"]).stream,
          "phase 11a: bqsr's input dedup.bam does not stream via its .bai")
    check(bool(BamInputSource.from_conf(conf, out["recal"]).parts),
          "phase 11a: htc's input tree is not region-pruned")
    h = res["htc"]
    unforced = [c for c in h["extra_classification"]
                if not c["gatk_forced"]]
    say(f"phase 11a accuracy: sensitivity {h['sensitivity']}, precision "
        f"{h['precision']}, {h['extra_calls']} extra calls "
        f"({h['extras_gatk_concordant']} that GATK's pileup likelihood "
        f"forces)")
    check(h["sensitivity"] >= WGS_SENSITIVITY
          and h["precision"] >= WGS_PRECISION and not unforced,
          f"phase 11a: accuracy below the rehearsal's rule (sensitivity >= "
          f"{WGS_SENSITIVITY}, precision >= {WGS_PRECISION}, no unforced "
          f"extra call)")
    mem = runs["mem"][1]
    check({mem[stage]["path"] for stage in W.STAGES.values()}
          == {"in memory"},
          "phase 11b: a stage left memory at the default thresholds")
    cmp_ = validate.compare_runs(
        str(work / "ooc"), str(work / "mem"), out["vcf"],
        W.outputs(work / "mem")["vcf"])
    say(f"phase 11 out of core vs in memory: {json.dumps(cmp_)}")
    check(all(same for same, _ in cmp_["bam"].values()),
          "phase 11: BAMs differ between the out-of-core and in-memory runs")
    check(cmp_["vcf_equivalent"] and cmp_["vcf_non_concordant"] == 0,
          "phase 11: VCFs differ between the out-of-core and in-memory runs")
    say(json.dumps({"wgs_smoke": {
        name: {stage: {k: v for k, v in r[stage].items()
                       if k != "extra_classification"}
               for stage in W.STAGES.values()}
        for name, (_, r) in runs.items()}}))


# ---------------------------------------------------------------------------
# phase 13: the host memory of the port's processes
# ---------------------------------------------------------------------------

def rss_probe(argv: list[str], out: Path) -> tuple[dict, str]:
    """``benchmarks/rss_probe.py`` with ``argv`` in a fresh process; its
    JSON document and its standard output."""
    r = subprocess.run(
        [sys.executable, "-m", "falcon_genome_tpu_torch.benchmarks.rss_probe",
         "--out", str(out), *argv], capture_output=True, text=True,
        cwd=REPO, timeout=900)
    check(r.returncode == 0, f"phase 13: rss_probe {' '.join(argv[:3])} "
          f"exited {r.returncode}: {r.stderr[-2000:]}")
    return json.loads(out.read_text()), r.stdout


def phase_rss(wgs: Path, work: Path) -> None:
    """(a) The probe's steps in a fresh process on the card, each step's
    memory printed; CUDA comes up with the first tensor on the card and
    not before.  (b) ``bqsr --device cuda`` on ``wgs``'s ``dedup.bam``, a
    command that launches no kernel, under the probe's ``--cli``: exit 0
    and no CUDA context in its process.  (c) The same command as a child
    of ``rss_probe --watch``: its exit code passed through, a peak above
    0 and the split at the peak present; and a child that exits 3 makes
    the probe exit 3."""
    work.mkdir(parents=True, exist_ok=True)
    doc, out = rss_probe(["--device", "cuda", "--genomes", ""],
                         work / "probe.json")
    for line in out.splitlines():
        if line.startswith("rss_probe "):
            say(f"phase 13a {line}")
    steps = [s["step"] for s in doc["steps"]]
    up = [s["cuda_initialized"] for s in doc["steps"]]
    first = steps.index("first tensor on the device")
    check(not any(up[:first]) and all(up[first:]),
          f"phase 13a: CUDA came up at the wrong step: "
          f"{list(zip(steps, up))}")
    last = doc["steps"][-1]
    say(f"phase 13a floor (a process with its CUDA context, the kernel "
        f"library and K1-K4 launched once): VmRSS {last['rss_gb']} GB, "
        f"RssAnon {last['anon_gb']} GB, RssFile {last['file_gb']} GB; "
        f"host {json.dumps(doc['host'])}")
    doc, _ = rss_probe(
        ["--cli", "--device", "cuda", "bqsr", "-r", str(wgs / "ref.fa"),
         "-i", str(wgs / "dedup.bam"), "-o", str(work / "bqsr.bam"), "-f",
         "-O", f"log_dir={work / 'log'}", "-O", f"temp_dir={work / 'tmp'}"],
        work / "cli.json")
    c = doc["cli"]
    say(f"phase 13b bqsr --device cuda: exit {c['rc']} in {c['wall_s']} s, "
        f"CUDA context {c['cuda_initialized']}, VmRSS after imports "
        f"{c['imported']['rss_gb']} GB, peak {c['peak_rss_gb']} GB "
        f"(RssAnon {c['peak_rss_anon_gb']} GB)")
    check(c["rc"] == 0 and not c["cuda_initialized"],
          "phase 13b: bqsr --device cuda failed or opened a CUDA context")

    def watch(cmd: list[str]) -> tuple[int, dict]:
        out = work / "watch.json"
        r = subprocess.run(
            [sys.executable, "-m",
             "falcon_genome_tpu_torch.benchmarks.rss_probe", "--watch",
             "--period", "0.5", "--out", str(out), "--", *cmd],
            capture_output=True, text=True, cwd=REPO, timeout=900)
        return r.returncode, json.loads(out.read_text())["runs"][-1]

    rc, w = watch([sys.executable, "-m", "falcon_genome_tpu_torch.cli",
                   "--device", "cuda", "bqsr", "-r", str(wgs / "ref.fa"),
                   "-i", str(wgs / "dedup.bam"), "-o",
                   str(work / "bqsr_watch.bam"), "-f",
                   "-O", f"log_dir={work / 'log'}",
                   "-O", f"temp_dir={work / 'tmp'}"])
    p = w["split_at_peak"] or {}
    say(f"phase 13c rss_probe --watch -- cli bqsr --device cuda: exit "
        f"{rc} (child {w['rc']}) in {w['wall_s']} s, {w['samples']} "
        f"samples; peak VmRSS {w['peak_rss_gb']} GB, at the peak RssAnon "
        f"{p.get('anon_gb')} / RssFile {p.get('file_gb')} GB (from "
        f"{p.get('split_from')}), {p.get('threads')} threads; base_anon "
        f"{w['base_anon_gb']} GB at {w['base_at_s']} s, added_anon "
        f"{w['added_anon_gb']} GB")
    check(rc == w["rc"] == 0,
          f"phase 13c: --watch exited {rc}, its child {w['rc']}")
    check((w["peak_rss_gb"] or 0) > 0, "phase 13c: --watch saw no memory")
    check(p.get("anon_gb") is not None and p.get("file_gb") is not None,
          f"phase 13c: no RssAnon / RssFile split at the peak: {p}")
    rc, w = watch([sys.executable, "-c", "import sys; sys.exit(3)"])
    say(f"phase 13c rss_probe --watch -- a child that exits 3: exit {rc}")
    check(rc == w["rc"] == 3,
          f"phase 13c: --watch exited {rc} for a child that exited 3")


# ---------------------------------------------------------------------------
# phase 12: the somatic, mesh, long-read, indel and joint-cohort rehearsals
# ---------------------------------------------------------------------------

# phase 8's somatic gate, and the long-read rehearsal's mapped fraction
SOMATIC_GATE, MAPPED_GATE = 0.9, 0.95
# phase 12's sizes: the mutect2 rehearsal's genome (Mb), the long reads
# over phase 11's reference (Mbp), the cohort's samples, bench_longread's
# reads and their length, bench_sw_parts' lanes
REHEARSAL_M2_MB, REHEARSAL_LONG_MBP, REHEARSAL_SAMPLES = 1, 6.0, 5
BENCH_LONG_READS, BENCH_SW_LANES = ("16", "10000"), "2240"


def phase_rehearsals(torch, S, P, results, wgs: Path, work: Path) -> None:
    """Each of the port's somatic, mesh, long-read, indel and joint-cohort
    rehearsals and its two Smith-Waterman bench scripts through its
    ``main`` on the card, at a small size, on phase 11's dataset
    (``wgs``: ``ref.fa``, ``dedup.bam``); every new bucket held against
    the plain versions on that run's inputs."""
    from falcon_genome_tpu_torch.benchmarks import (
        bench_longread, bench_sw_parts, indel_rehearsal, joint_cohort,
        longread_rehearsal, mesh_rehearsal, mutect2_rehearsal as M2,
        wgs_rehearsal as W)
    work.mkdir(parents=True, exist_ok=True)
    out = work / "rows.json"
    held: set = set()
    rows, buckets, paths = {}, [], {}
    card = ["--device", "cuda"]

    def drive(label, main, argv, bucket=lambda R, W: (R, W)):
        """``main(argv)`` on the card, every count at 0 just before it and
        read just after it, the Smith-Waterman and PairHMM wrappers
        recorded and its output kept; then each bucket it launched that
        this phase has not held yet held against the plain versions.
        Returns its launches and the lines it printed."""
        for d in (S.LAUNCHES, P.LAUNCHES):
            for k in d:
                d[k] = 0
        torch.cuda.synchronize()
        printed = io.StringIO()
        t0 = time.time()
        with ShapeRecorder(S, P, bucket) as rec, \
                contextlib.redirect_stdout(printed):
            rc = main(argv)
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: n for k, n in {**S.LAUNCHES, **P.LAUNCHES}.items()
                    if n}
        check(rc == 0, f"phase 12: {label} exited {rc}")
        rec.sw = {k: v for k, v in rec.sw.items() if ("sw", k) not in held}
        rec.hmm = {k: v for k, v in rec.hmm.items()
                   if ("hmm", k) not in held}
        held.update([("sw", k) for k in rec.sw]
                    + [("hmm", k) for k in rec.hmm])
        say(f"phase 12 {label}: exit 0 in {wall:.1f} s, kernel launches "
            f"{launches}; buckets not yet held in this phase: SW (R, W) "
            f"{sorted(rec.sw)}, PairHMM (R, H) {sorted(rec.hmm)}")
        buckets.extend(hold_buckets(torch, S, P, rec, f"phase 12 {label}"))
        paths[label] = launches
        return launches, printed.getvalue().strip().splitlines()

    def need(label, launches, kernels):
        for k in kernels:
            check(launches.get(k, 0) > 0,
                  f"phase 12: {label} did not launch {k}")

    # mutect2 at 1 Mb: the rehearsal's own dataset (25x tumor and normal)
    M2.G, M2.N_SOMATIC, M2.N_GERMLINE = (int(REHEARSAL_M2_MB * 1e6),
                                         int(100 * REHEARSAL_M2_MB),
                                         int(200 * REHEARSAL_M2_MB))
    launches, _ = drive("mutect2_rehearsal", M2.main,
                        [str(work / "m2"), *card, "--out", str(out)],
                        mutect2_bucket)
    shutil.rmtree(work / "m2", ignore_errors=True)
    need("mutect2_rehearsal", launches,
         ("fgt_sw_full", "fgt_sw_traceback", "fgt_pairhmm"))
    r = rows["mutect2"] = json.loads(out.read_text())[M2.result_key()]
    say(f"phase 12 mutect2_rehearsal at {r['genome_mb']:g} Mb: "
        f"{r['wall_s']} s, somatic sensitivity {r['somatic_sensitivity']}, "
        f"precision {r['precision']}, {r['extra_calls']} extra calls")
    check(r["somatic_sensitivity"] >= SOMATIC_GATE
          and r["precision"] >= SOMATIC_GATE,
          f"phase 12: mutect2_rehearsal's somatic sensitivity or precision "
          f"below {SOMATIC_GATE}")

    # htc under an 8-shard mesh against none, on phase 11's whole contig
    launches, _ = drive("mesh_rehearsal", mesh_rehearsal.main,
                        [str(wgs), str(W.SMOKE_MB), *card, "--out",
                         str(work / "mesh.json")], mutect2_bucket)
    need("mesh_rehearsal", launches,
         ("fgt_sw_full", "fgt_sw_traceback", "fgt_pairhmm"))
    r = rows["mesh"] = json.loads((work / "mesh.json").read_text())
    say(f"phase 12 mesh_rehearsal: equal {r['equal']}, "
        f"{r['single']['n_calls']} calls; single {r['single']['wall_s']} s, "
        f"mesh {r['mesh8']['wall_s']} s on {r['mesh8']['pairhmm_cards']}")
    check(r["equal"], "phase 12: htc under the mesh differs from no mesh")

    launches, _ = drive("longread_rehearsal", longread_rehearsal.main,
                        [str(wgs), str(REHEARSAL_LONG_MBP), *card, "--out",
                         str(out)])
    need("longread_rehearsal", launches, ("fgt_sw_full", "fgt_sw_traceback"))
    check(set(launches) == {"fgt_sw_full", "fgt_sw_traceback"},
          f"phase 12: longread_rehearsal launched kernels other than "
          f"K2/K3: {launches}")
    r = rows["longread"] = json.loads(out.read_text())[
        longread_rehearsal.result_key(REHEARSAL_LONG_MBP)]
    say(f"phase 12 longread_rehearsal: {r['reads']} reads, "
        f"{r['total_mbp']} Mbp in {r['wall_s']} s ({r['mbp_per_s']} Mbp/s), "
        f"mapped {r['mapped_frac']}")
    check(r["mapped_frac"] >= MAPPED_GATE,
          f"phase 12: long reads mapped below {MAPPED_GATE}")

    launches, _ = drive("indel_rehearsal", indel_rehearsal.main,
                        [str(wgs), *card, "--out", str(out)])
    r = rows["indel"] = json.loads(out.read_text())[
        indel_rehearsal.result_key(W.SMOKE_MB)]
    say(f"phase 12 indel_rehearsal: {r['genome_mb']:g} Mb, {r['reads']} "
        f"reads in {r['wall_s']} s, {r['realigned_reads']} reads realigned, "
        f"launches {launches}")

    launches, _ = drive("joint_cohort", joint_cohort.main,
                        [str(wgs), str(REHEARSAL_SAMPLES), *card, "--out",
                         str(out)])
    r = rows["joint_cohort"] = json.loads(out.read_text())[
        joint_cohort.result_key(REHEARSAL_SAMPLES)]
    say(f"phase 12 joint_cohort: {json.dumps(r)}")
    check(r["pass"], "phase 12: joint_cohort's gate failed")

    launches, lines = drive("bench_longread", bench_longread.main,
                            [*BENCH_LONG_READS, *card])
    need("bench_longread", launches, ("fgt_sw_full", "fgt_sw_traceback"))
    say(f"phase 12 bench_longread: {lines[0]}")
    rows["bench_longread"] = json.loads(lines[-1])

    launches, lines = drive("bench_sw_parts", bench_sw_parts.main,
                            [BENCH_SW_LANES, *card])
    need("bench_sw_parts", launches, ("fgt_sw_full", "fgt_sw_traceback"))
    r = rows["bench_sw_parts"] = json.loads(lines[-1])
    check(r["parts_equal_sw_extend_batch"],
          "phase 12: bench_sw_parts' parts differ from sw_extend_batch")
    say(f"phase 12 bench_sw_parts ({r['lanes']} lanes, {r['bucket']}): "
        f"the parts equal sw_extend_batch; ms {json.dumps(r['ms'])}")

    for k in ("fgt_sw_full", "fgt_sw_traceback", "fgt_pairhmm"):
        results[k]["launches_by_path"] = {
            "germline": results[k]["launches"],
            **results[k].get("launches_by_path", {}),
            **{label: n[k] for label, n in paths.items() if n.get(k)}}
    say(json.dumps({"rehearsals_smoke": {**rows, "launches": paths,
                                         "buckets": buckets}}))


# ---------------------------------------------------------------------------
# phase 10: the aligner's record API and the golden models
# ---------------------------------------------------------------------------

def sam_records_of(params, b1, b2, a1, a2) -> list:
    """``make_sam_records`` over a batch of pairs, in the columns' order
    (read 1 then read 2 of each pair)."""
    from falcon_genome_tpu_torch.aligner import make_sam_records
    from falcon_genome_tpu_torch.io.dna import decode_seq

    def seq_qual(b, i):
        n = b.lengths[i]
        return (decode_seq(b.codes[i, :n]),
                (b.quals[i, :n] + 33).tobytes().decode())
    out = []
    for i in range(len(b1.lengths)):
        out += make_sam_records(b1.names[i], *seq_qual(b1, i), a1[i],
                                *seq_qual(b2, i), a2[i], params=params,
                                read_group="smoke")
    return out


def golden_models(S, golden) -> None:
    """Phase 3's kernel outputs against the float64/int64 NumPy golden
    models (``ops/sw_ref.py``, ``ops/pairhmm_ref.py``), run in a pool of
    spawned processes: K2/K3 on GOLDEN_LANES aligner lanes (160/256),
    equal scores and CIGARs of the read's length; K4 on GOLDEN_LANES pairs
    (160/384) within GOLDEN_PAIRHMM_TOL log10 wherever K4 is finite.  K4
    may give -inf only to the batch's unrelated pairs (random reads,
    log10 near -145 in float64), as the reference's own float32 path does
    (``tests/test_torch_golden_models.py``); every pair sampled from its
    haplotype must be finite."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from falcon_genome_tpu_torch.io.sam import cigar_query_len
    from falcon_genome_tpu_torch.ops.pairhmm_ref import pairhmm_logp_single
    from falcon_genome_tpu_torch.ops.sw_ref import sw_align_ref
    sw, hmm = golden["sw"], golden["hmm"]
    read, rl, win, wl = sw["lanes"]
    reads, quals, rlen, haps, hl = hmm["lanes"]
    n = GOLDEN_LANES
    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        sw_f = [pool.submit(sw_align_ref, read[b, :rl[b]], win[b, :wl[b]],
                            sw["params"]) for b in range(n)]
        hmm_f = [pool.submit(
            pairhmm_logp_single, reads[b, :rlen[b]], quals[b, :rlen[b]],
            *(np.full(rlen[b], q, np.uint8) for q in hmm["trans"]),
            haps[b, :hl[b]]) for b in range(n)]
        want_sw = [f.result() for f in sw_f]
        want_hmm = np.array([f.result() for f in hmm_f])
    got_sw = S._results_from_packed(sw["packed"], sw["steps"], sw["coords"],
                                    sw["best"], rl)
    err_sw = max(abs(g.score - w.score) for g, w in zip(got_sw, want_sw))
    bad_len = [b for b, g in enumerate(got_sw)
               if g.score > 0 and cigar_query_len(g.cigar) != rl[b]]
    same = sum(vars(g) == vars(w) for g, w in zip(got_sw, want_sw))
    mapped = sum(g.score > 0 for g in got_sw)
    say(f"golden sw_align_ref vs K2/K3 (phase 3, aligner winners R=160 "
        f"W=256, {n} lanes, {mapped} with a positive score): max |score "
        f"difference| {err_sw}, CIGARs not of the read's length "
        f"{len(bad_len)}, spans and CIGAR identical on {same}/{n}")
    check(err_sw == 0, f"K2 scores differ from sw_align_ref by {err_sw}")
    check(not bad_len, f"K3 CIGARs of lanes {bad_len} do not cover the read")
    got = hmm["logp"].astype(np.float64)
    fin = np.isfinite(got)
    floored = np.flatnonzero(~fin)
    check(np.isfinite(want_hmm).all(), "pairhmm_logp_ref gave -inf")
    check(bool(hmm["unrelated"][floored].all()),
          f"K4 gave -inf to pairs sampled from their haplotype: "
          f"{floored[~hmm['unrelated'][floored]].tolist()}")
    err_hmm = float(np.abs(got[fin] - want_hmm[fin]).max())
    low = (f"{want_hmm[floored].min():.1f}..{want_hmm[floored].max():.1f}"
           if len(floored) else "none")
    say(f"golden pairhmm_logp_ref vs K4 (phase 3, R=160 H=384, "
        f"{hmm['trans']}, {n} pairs, {int(hmm['unrelated'].sum())} of "
        f"them unrelated): max |dlog10| {err_hmm:.3g} on {int(fin.sum())} "
        f"finite pairs (tolerance {GOLDEN_PAIRHMM_TOL}); -inf in K4 on "
        f"{len(floored)} unrelated pairs, float64 log10 {low}; both "
        f"models {time.time() - t0:.1f} s")
    check(err_hmm <= GOLDEN_PAIRHMM_TOL,
          f"K4 differs from pairhmm_logp_ref by {err_hmm}")


def phase_record_api(torch, S, sample, golden, results) -> None:
    """``AlignerEngine.align_pair_batch`` (K1 → K2 → K3) on the card over
    phase 5's 50 kb read pairs in production batches, with every count at
    0 just before it: pairs/s and launches; its ``make_sam_records``
    output record-equal to the columns path (``align_pair_dispatch`` /
    ``align_pair_collect`` → ``alignments_to_columns``, as the align
    stage emits) and its alignments equal to the same call on the CPU.
    Then the golden models on phase 3's kernel outputs."""
    from falcon_genome_tpu_torch.aligner import (
        AlignerEngine, AlignerParams, alignments_to_columns)
    from falcon_genome_tpu_torch.io.fastq import FastqReader
    from falcon_genome_tpu_torch.stages.common import load_index
    idx = load_index(sample.ref)
    params = AlignerParams()
    batches = list(FastqReader(sample.fastq1, sample.fastq2,
                               batch_size=4096))
    npairs = sum(len(b1.lengths) for b1, _ in batches)
    cuda = AlignerEngine(idx, params, device=torch.device("cuda"))
    cuda.genome_dev                  # the genome on the card before the clock
    for k in S.LAUNCHES:
        S.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.time()
    alns = [cuda.align_pair_batch(b1.codes, b1.lengths, b2.codes,
                                  b2.lengths) for b1, b2 in batches]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(S.LAUNCHES)
    say(f"align_pair_batch on the card: {npairs} pairs of the 50 kb sample "
        f"in {len(batches)} batches, {wall:.3f} s, {npairs / wall:.0f} "
        f"pairs/s, kernel launches {launches}")
    for k in ("fgt_sw_score", "fgt_sw_full", "fgt_sw_traceback"):
        check(launches[k] > 0, f"align_pair_batch did not launch {k}")
        results[k]["launches_by_path"] = {
            "germline": results[k]["launches"],
            **results[k].get("launches_by_path", {}),
            "align_pair_batch": launches[k]}
    recs, cols = [], []
    for (b1, b2), (a1, a2) in zip(batches, alns):
        recs += sam_records_of(params, b1, b2, a1, a2)
        ab1, ab2 = cuda.align_pair_collect(cuda.align_pair_dispatch(
            b1.codes, b1.lengths, b2.codes, b2.lengths))
        cols += alignments_to_columns(b1, ab1, b2, ab2, params=params,
                                      read_group="smoke").to_records()
    n_mapped = sum(not r.is_unmapped for r in recs)
    check(recs == cols and len(recs) == 2 * npairs,
          "align_pair_batch's make_sam_records differ from the columns path")
    t1 = time.time()
    cpu = AlignerEngine(idx, params, device=torch.device("cpu"))
    cpu_alns = [cpu.align_pair_batch(b1.codes, b1.lengths, b2.codes,
                                     b2.lengths) for b1, b2 in batches]
    t_cpu = time.time() - t1
    same = all([vars(a) for a in x] == [vars(a) for a in y]
               for pair, cpu_pair in zip(alns, cpu_alns)
               for x, y in zip(pair, cpu_pair))
    say(f"align_pair_batch: {len(recs)} make_sam_records records equal to "
        f"the columns path ({n_mapped} mapped); alignments equal to "
        f"device=cpu: {same} (cpu {t_cpu:.2f} s)")
    check(same, "align_pair_batch differs between the card and the CPU")
    golden_models(S, golden)


# ---------------------------------------------------------------------------
# phase 8: the somatic path (mutect2) and the host commands
# ---------------------------------------------------------------------------

def mutect2_bucket(R: int, W: int) -> tuple[int, int]:
    """``_hap_to_ref_events_multi``'s SW bucket of a call: the rows R and
    the window W rounded up to 128 (R at least W)."""
    return -(-max(R, W, 128) // 128) * 128, -(-max(W, 128) // 128) * 128


class ShapeRecorder:
    """Wraps the Smith-Waterman (``sw_full``: K2 then K3) and scalar
    PairHMM (``pairhmm_sc``: K4) wrappers while a run is driven, and
    keeps, per bucket, the inputs of its widest call.  SW buckets are
    ``bucket(R, W)`` of a call's read rows and window columns (by default
    the shape itself); PairHMM buckets are the (R, H) the lanes are padded
    to.  It also sums, on the device, the lanes whose wlen exceeds the
    window's W.  It launches nothing itself."""

    def __init__(self, S, P, bucket=lambda R, W: (R, W)):
        self.S, self.P = S, P
        self.bucket = bucket
        self.sw: dict[tuple[int, int], tuple] = {}
        self.hmm: dict[tuple[int, int], tuple] = {}
        self.sw_shapes: set[tuple[int, int]] = set()
        self.calls = {"sw": 0, "hmm": 0}
        self.over_w = 0

    def __enter__(self):
        S, P = self.S, self.P
        self.real = S.sw_full, P.pairhmm_sc

        def sw_full(read, rlen, win, wlen, params, max_steps):
            R, W = read.shape[1], win.shape[1]
            key = self.bucket(R, W)
            self.calls["sw"] += 1
            self.sw_shapes.add((R, W))
            self.over_w = self.over_w + (wlen > W).sum()
            have = self.sw.get(key)
            if have is None or have[0].shape[0] < read.shape[0]:
                self.sw[key] = (read, rlen, win, wlen, params, max_steps)
            return self.real[0](read, rlen, win, wlen, params, max_steps)

        def pairhmm_sc(read, base_q, rlen, hap, hlen, ins_q, del_q, gcp):
            key = (read.shape[1], hap.shape[1])
            self.calls["hmm"] += 1
            have = self.hmm.get(key)
            if have is None or have[0].shape[0] < read.shape[0]:
                self.hmm[key] = (read, base_q, rlen, hap, hlen, ins_q,
                                 del_q, gcp)
            return self.real[1](read, base_q, rlen, hap, hlen, ins_q,
                                del_q, gcp)
        S.sw_full, P.pairhmm_sc = sw_full, pairhmm_sc
        return self

    def __exit__(self, *exc):
        self.S.sw_full, self.P.pairhmm_sc = self.real


def hold_buckets(torch, S, P, rec: ShapeRecorder, label: str) -> list[dict]:
    """K2/K3 and K4 against their plain versions at every bucket the
    recorded run launched, on that run's own inputs: SW bit-equal
    (scores, best positions, op streams, coordinates), PairHMM bit-equal
    with the same -inf lanes.  Times and bounds as phase 3."""
    rows = []
    for (rb, wb), (read, rl, win, wl, p, steps) in sorted(rec.sw.items()):
        B, R, W = read.shape[0], read.shape[1], win.shape[1]
        kptr, kbest, kpos = S.sw_pointers(read, rl, win, wl, p)
        kout = S.sw_traceback(kptr, kbest, kpos, steps)
        pptr, pbest, ppos = S._plain_scan(read, rl, win, wl, p)
        pout = S._traceback_core(pptr, pbest[0], ppos[0], max_steps=steps)
        torch.cuda.synchronize()
        e2 = max(int((kbest - pbest[0]).abs().max()),
                 int((kpos - ppos[0]).abs().max()))
        e3 = max(int((a.int() - b.int()).abs().max())
                 for a, b in zip(kout, pout))
        check(e2 == 0 and e3 == 0,
              f"K2/K3 differ from the plain versions at {label}'s bucket "
              f"{rb}/{wb} (R={R} W={W} B={B})")
        t2 = cuda_ms(torch, lambda: S.sw_pointers(read, rl, win, wl, p), 3)
        t3 = cuda_ms(torch, lambda: S.sw_traceback(kptr, kbest, kpos,
                                                   steps), 3)
        t2p = cuda_ms(torch, lambda: S._plain_scan(read, rl, win, wl, p), 1)
        t3p = cuda_ms(torch, lambda: S._traceback_core(
            pptr, pbest[0], ppos[0], max_steps=steps), 1)
        packed = kout[0].cpu().numpy()
        walked = int(sum(((packed >> s) & 3) != 0
                         for s in (0, 2, 4, 6)).sum())
        b2 = bound(read.numel() + win.numel() + 16 * B
                   + kptr.numel() * kptr.element_size(),
                   SW_OPS_PER_CELL * sw_cells(rl, wl, R, W), PEAK_INT32)
        b3 = bound(walked / 2 + packed.size + 24 * B, 0, PEAK_INT32)
        say(f"{label} bucket K2+K3 {rb}/{wb} (R={R} W={W} B={B}, "
            f"{-(-R // 384)} stripe(s), max_steps {steps}): bit-equal; K2 "
            f"kernel {t2:.3f} ms plain {t2p:.3f} ms bound "
            f"{b2['bound_ms']:.4f} ms ({b2['bound_by']}); K3 kernel "
            f"{t3:.3f} ms plain {t3p:.3f} ms byte bound "
            f"{b3['bound_ms']:.4f} ms")
        rows.append(dict(kernel="K2", bucket=[rb, wb], R=R, W=W, B=B,
                         ms=t2, plain_ms=t2p, **b2))
        rows.append(dict(kernel="K3", bucket=[rb, wb], R=R, W=W, B=B,
                         ms=t3, plain_ms=t3p, **b3))
        del kptr, pptr
    for (R, H), args in sorted(rec.hmm.items()):
        read, bq, rl, hap, hl, ins_q, del_q, gcp = args
        B = read.shape[0]

        def plain():
            return P._pairhmm_plain(read.T, bq.T, ins_q, del_q, gcp,
                                    rl[None], hl[None], hap.T, R=R, H=H)
        got = P.pairhmm_sc(*args)
        e4, n4 = hold_pairhmm(torch, f"K4 at {label}'s bucket {R}/{H}", got,
                              plain())
        t4 = cuda_ms(torch, lambda: P.pairhmm_sc(*args), 3)
        t4p = cuda_ms(torch, plain, 1)
        cells = int((rl.cpu().numpy().astype(np.int64)
                     * hl.cpu().numpy()).sum())
        b4 = bound(2 * B * R + B * H + 12 * B,
                   PAIRHMM_FLOPS_PER_CELL * cells, PEAK_F32)
        say(f"{label} bucket K4 {R}/{H} (B={B}, {ins_q}/{del_q}/{gcp}): "
            f"max |dlog10| {e4:.3g}, {n4} finite pairs not bit-equal, "
            f"-inf lanes equal ({int((~torch.isfinite(got)).sum())}); "
            f"kernel {t4:.3f} ms plain {t4p:.3f} ms bound "
            f"{b4['bound_ms']:.4f} ms ({b4['bound_by']})")
        rows.append(dict(kernel="K4", bucket=[R, H], B=B, ms=t4,
                         plain_ms=t4p, max_abs_err=e4, **b4))
    return rows


def run_cli(cli, argv: list[str]) -> float:
    """One command through the port's CLI; its wall in seconds."""
    t0 = time.time()
    rc = cli.main(argv)
    check(rc == 0, f"{' '.join(argv[:3])} exited {rc}")
    return time.time() - t0


def tumor_normal_bams(cli, tn, out: Path) -> tuple[dict, dict]:
    """``align`` then ``markdup`` of each sample on the card: the BAMs
    and the wall of each step."""
    bams, walls = {}, {}
    for name, reads in (("tumor", tn.tumor), ("normal", tn.normal)):
        aligned = out / f"{name}.aligned.bam"
        walls[f"align {name}"] = run_cli(cli, [
            "--device", "cuda", "align", "-r", tn.ref, "-1", reads.fastq1,
            "-2", reads.fastq2, "-o", str(aligned), "-S", name, "-R", name,
            "-f"])
        bams[name] = str(out / f"{name}.bam")
        walls[f"markdup {name}"] = run_cli(cli, [
            "--device", "cuda", "markdup", "-i", str(aligned),
            "-o", bams[name], "-f"])
    return bams, walls


def mutect2_argv(tn, bams: dict, out: Path, device: str) -> list[str]:
    return ["--device", device, "mutect2", "-r", tn.ref, "-t", bams["tumor"],
            "-n", bams["normal"], "-o", str(out), "-f"]


def phase_somatic(torch, cli, S, P, validate, work: Path) -> list[dict]:
    from falcon_genome_tpu_torch.benchmarks.call_sizes import (
        PairHMMCalls, summary as call_summary)
    t0 = time.time()
    tn = validate.simulate_tumor_normal(work / "tn1mb", 1_000_000, seed=5)
    say(f"somatic sample: one 1 Mb contig (genome length cut from a 3.1 Gb "
        f"human genome to fit the smoke's time; widths as in production), "
        f"normal {tn.normal.n_pairs} pairs (30x), tumor {tn.tumor.n_pairs} "
        f"pairs (60x) x 2 x 150 bp; in both {len(tn.snps)} germline het "
        f"SNPs and {len(tn.indels)} indels; in the tumor only "
        f"{len(tn.somatic)} somatic SNVs at allele fraction 0.3; simulated "
        f"in {time.time() - t0:.1f} s")
    bams, walls = tumor_normal_bams(cli, tn, work / "tn1mb")
    vcf = work / "tn1mb" / "somatic.vcf.gz"
    for d in (S.LAUNCHES, P.LAUNCHES):
        for k in d:
            d[k] = 0
    torch.cuda.synchronize()
    with ShapeRecorder(S, P, mutect2_bucket) as rec, PairHMMCalls() as calls:
        walls["mutect2"] = run_cli(cli, mutect2_argv(tn, bams, vcf, "cuda"))
        torch.cuda.synchronize()
    CALL_SIZES["mutect2"] = call_summary(calls.sizes)
    launches = {k: n for k, n in {**S.LAUNCHES, **P.LAUNCHES}.items() if n}
    say(f"mutect2 steps on the card (s): "
        f"{json.dumps({k: round(v, 2) for k, v in walls.items()})}; "
        f"mutect2 kernel launches {launches}")
    for k in ("fgt_sw_full", "fgt_sw_traceback", "fgt_pairhmm"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched by "
              f"mutect2")
    check(set(launches) == {"fgt_sw_full", "fgt_sw_traceback",
                            "fgt_pairhmm"},
          f"mutect2 launched kernels other than K2-K4: {launches}")
    say(f"mutect2 buckets: SW (R, W) {sorted(rec.sw)} ({rec.calls['sw']} "
        f"calls, {len(rec.sw_shapes)} distinct unpadded shapes, R up to "
        f"{max(r for r, _ in rec.sw_shapes)}); PairHMM (R, H) "
        f"{sorted(rec.hmm)} ({rec.calls['hmm']} calls)")
    rows = hold_buckets(torch, S, P, rec, "mutect2")
    del rec
    acc = validate.score_somatic(str(vcf), tn)
    say(f"somatic accuracy vs planted truth: {json.dumps(acc)}")
    check(acc["somatic_sensitivity"] >= 0.9
          and acc["somatic_precision"] >= 0.9,
          "somatic SNV sensitivity or precision below 0.9")
    check(acc["germline_sites_pass"] == 0,
          "a germline het site passed the somatic filters")

    # plain versions on the CPU vs kernels on the card, on the same BAMs
    # over windows of 301 bp around six somatic sites: the plain
    # PairHMM's time on the host sets the cut (tens of seconds a kb)
    windows = work / "tn1mb" / "windows.list"
    windows.write_text("".join(f"chr1:{p - 149}-{p + 151}\n"
                               for p in sorted(tn.somatic)[:6]))
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = work / "tn1mb" / f"{dev}.vcf.gz"
        wall = run_cli(cli, mutect2_argv(tn, bams, out[dev], dev)
                       + ["-L", str(windows), "-O", "gatk.nprocs=1"])
        say(f"mutect2 over six 301 bp windows --device {dev}: {wall:.2f} s")
    recs = {d: validate.vcf_records(str(v)) for d, v in out.items()}
    c = validate.compare_vcf(str(out["cpu"]), str(out["cuda"]))
    say(f"mutect2 windows cpu vs cuda: {len(recs['cuda'])} records, "
        f"record-equal {recs['cpu'] == recs['cuda']}, concordant "
        f"{c.concordant}, non-concordant "
        f"{c.only_a + c.only_b + c.discordant_gt}")
    check(recs["cpu"] == recs["cuda"] and len(recs["cuda"]) > 0
          and c.equivalent,
          "mutect2 VCFs differ between --device cpu and cuda")
    shutil.rmtree(work / "tn1mb", ignore_errors=True)
    return rows


def phase_host(cli, sample, run_dir: Path, vcf: Path, work: Path) -> None:
    """The host commands once each on phase 4's outputs (recalibrated
    reads, calls and their shard parts): ``ug`` and ``htc`` gVCFs for
    ``joint`` over a 200 kb interval, ``depth`` over the contig,
    ``vcf_filter`` and ``concat``.  Each must exit 0 and write a
    non-empty output."""
    work.mkdir(parents=True, exist_ok=True)
    iv = work / "200kb.list"
    iv.write_text("chr1:400001-600000\n")
    recal = str(run_dir / "recal")
    gvcfs = work / "gvcfs"
    gvcfs.mkdir()
    steps = [
        ("ug", ["ug", "-r", sample.ref, "-i", recal, "-L", str(iv),
                "-o", str(work / "ug.vcf")], work / "ug.vcf"),
        ("depth", ["depth", "-r", sample.ref, "-i", recal, "-b",
                   "-o", str(work / "depth")],
         work / "depth.sample_summary"),
        ("vcf_filter", ["vcf_filter", "-r", sample.ref, "-i", str(vcf),
                        "--filter-expression", "QUAL < 50",
                        "--filter-name", "LowQual",
                        "-o", str(work / "filtered.vcf")],
         work / "filtered.vcf"),
        ("concat", ["concat", "-i", str(vcf) + ".parts",
                    "-o", str(work / "concat.vcf.gz")],
         work / "concat.vcf.gz"),
    ] + [
        (f"htc gVCF {s}", ["htc", "-r", sample.ref, "-i", recal, "-L",
                           str(iv), "-S", s,
                           "-o", str(gvcfs / f"{s}.g.vcf.gz")],
         gvcfs / f"{s}.g.vcf.gz") for s in ("s1", "s2")
    ] + [
        ("joint", ["joint", "-r", sample.ref, "-i", str(gvcfs),
                   "-o", str(work / "joint.vcf.gz")],
         work / "joint.vcf.gz")]
    walls = {}
    for name, argv, out in steps:
        walls[name] = run_cli(cli, ["--device", "cuda", *argv, "-f"])
        check(out.exists() and out.stat().st_size > 0,
              f"{name} wrote no output")
    walls = {k: round(v, 2) for k, v in walls.items()}
    say(f"host commands on the 1 Mb germline outputs, exit 0 and non-empty "
        f"outputs (s): {json.dumps(walls)}")


# ---------------------------------------------------------------------------
# phase 9: long reads, indel realignment and the gatk passthrough
# ---------------------------------------------------------------------------

class Realigned(logging.Handler):
    """The read count of ``indel``'s closing log line."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.n = None

    def emit(self, record):
        m = re.match(r"indel: (\d+) reads realigned", record.getMessage())
        if m:
            self.n = int(m.group(1))


def drive_sw_path(torch, cli, S, P, label: str, argv: list[str]):
    """One command on the card with every count at 0 just before it and
    the Smith-Waterman wrapper recorded: it must launch K2 and K3 and no
    other kernel.  Prints its buckets and the widest call, then holds K2/K3
    against their plain versions at each bucket on the run's own inputs.
    Returns (wall, launches, hold rows, lanes with wlen > W)."""
    for d in (S.LAUNCHES, P.LAUNCHES):
        for k in d:
            d[k] = 0
    torch.cuda.synchronize()
    with ShapeRecorder(S, P) as rec:
        wall = run_cli(cli, argv)
        torch.cuda.synchronize()
    launches = {k: n for k, n in {**S.LAUNCHES, **P.LAUNCHES}.items() if n}
    check(set(launches) == {"fgt_sw_full", "fgt_sw_traceback"},
          f"{label} launched kernels other than K2/K3: {launches}")
    over_w = int(rec.over_w)
    say(f"{label} SW buckets (R, W): {sorted(rec.sw)}, {rec.calls['sw']} "
        f"calls, widest call {max(a[0].shape[0] for a in rec.sw.values())} "
        f"lanes, lanes with wlen > W {over_w}; kernel launches {launches}")
    rows = hold_buckets(torch, S, P, rec, label)
    return wall, launches, rows, over_w


def same_bams(validate, a: str, b: str, what: str) -> int:
    d = validate.compare_bam(a, b, compare_tags=True)
    check(d.equivalent and d.matching > 0,
          f"{what}: BAMs differ between --device cpu and --device cuda")
    return d.matching


def phase_long_indel(torch, cli, S, P, validate, germline_1mb, sample_50kb,
                     run_dir_50kb: Path, work: Path, results) -> list[dict]:
    """Phase 9 (a)-(e).  Returns the hold rows of (a)-(c)."""
    work.mkdir(parents=True, exist_ok=True)
    paths = {}
    rows = []

    # (a) long reads at full width: only the genome is cut
    t0 = time.time()
    lr = validate.simulate_long_reads(work / "lr1mb", 1_000_000, 10, seed=9)
    say(f"long-read sample: one 1 Mb contig (genome length cut from a "
        f"3.1 Gb human genome to fit the smoke's time; widths as in "
        f"production: 512 reads a batch, sub-batches of 256, chunks of "
        f"144/240 in the 160/256 bucket), {lr.n_reads} ONT-class reads, "
        f"{lr.n_bases / 1e6:.2f} Mbp (10x; log-normal lengths, median "
        f"10 kb, 3-30 kb; 5% errors, 60% substitutions and 40% deletions; "
        f"both strands), simulated in {time.time() - t0:.1f} s")
    bam = work / "lr1mb" / "long.bam"
    wall, launches, got, _ = drive_sw_path(
        torch, cli, S, P, "align --long-reads",
        ["--device", "cuda", "align", "-r", lr.ref, "-1", lr.fastq,
         "-o", str(bam), "--long-reads", "-f"])
    rows += got
    paths["align --long-reads"] = launches
    acc = validate.score_long_alignments(str(bam), lr)
    say(f"align --long-reads on the card: wall {wall:.2f} s, "
        f"{lr.n_bases / wall / 1e6:.3f} Mbp/s, {lr.n_reads / wall:.1f} "
        f"reads/s; {json.dumps(acc)}")
    check(acc["mapped"] >= 0.95 and acc["placed"] >= 0.95,
          "long reads mapped or placed below 0.95")

    # (b) germline --long-reads: planted het SNVs, at the coverage and
    # with the error profile of the reference's own gate
    # (tests/test_longread.py: 30x, insertions, deletions and
    # substitutions a third each of 5%)
    g = validate.simulate_long_reads(work / "lr200kb", 200_000, 30, seed=10,
                                     sigma=0.0, n_snps=40, insertions=True)
    vcf = work / "lr200kb" / "calls.vcf.gz"
    with ShapeRecorder(S, P) as rec:
        wall = run_cli(cli, ["--device", "cuda", "germline", "-r", g.ref,
                             "-1", g.fastq, "-o", str(vcf), "--long-reads",
                             "-S", "lr", "-v", "-f"])
        torch.cuda.synchronize()
    say(f"germline --long-reads buckets: SW (R, W) {sorted(rec.sw)}, "
        f"PairHMM (R, H) {sorted(rec.hmm)} ({rec.calls['hmm']} calls)")
    # reads clipped to active regions pass 256 bases: K4 there (9-12
    # rows a thread) is held on this run's inputs; the SW buckets are
    # (a)'s and phase 8's
    rec.sw = {}
    rec.hmm = {k: v for k, v in rec.hmm.items() if k[0] > 256}
    rows += hold_buckets(torch, S, P, rec, "germline --long-reads")
    acc = validate.score_calls(str(vcf), g)
    say(f"germline --long-reads on the card: 200 kb, {len(g.snps)} het "
        f"SNVs, {g.n_reads} reads of 10 kb (30x, 5% errors, a third each "
        f"insertions, deletions, substitutions): wall "
        f"{wall:.2f} s; calls {acc['n_calls']}, SNV sensitivity "
        f"{acc['snp_sensitivity']:.3f}, precision {acc['precision']:.3f}")
    check(acc["snp_sensitivity"] >= 0.7,
          "germline --long-reads SNV sensitivity below 0.7")

    # (c) indel on phase 4's 1 Mb / 30x deduplicated BAM
    sample, run_dir, _ = germline_1mb
    log = logging.getLogger("falcon_genome_tpu")
    counter = Realigned()
    log.addHandler(counter)
    try:
        wall, launches, got, over_w = drive_sw_path(
            torch, cli, S, P, "indel",
            ["--device", "cuda", "indel", "-r", sample.ref,
             "-i", str(run_dir / "dedup.bam"),
             "-o", str(work / "realigned.bam"), "-f"])
    finally:
        log.removeHandler(counter)
    rows += got
    paths["indel"] = launches
    check(counter.n is not None, "indel logged no count of realigned reads")
    say(f"indel on the card: 1 Mb / 30x deduplicated BAM, wall {wall:.2f} "
        f"s, {counter.n} reads realigned, {over_w} lanes with a window "
        f"longer than W")

    # (d) plain versions on the CPU against the kernels on the card
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = str(work / f"indel50kb.{dev}.bam")
        w = run_cli(cli, ["--device", dev, "indel", "-r", sample_50kb.ref,
                          "-i", str(run_dir_50kb / "dedup.bam"),
                          "-o", out[dev], "-f", "-O", "gatk.nprocs=1"])
        say(f"indel 50 kb --device {dev}: {w:.2f} s")
    n = same_bams(validate, out["cpu"], out["cuda"], "indel 50 kb")
    say(f"indel 50 kb cpu vs cuda: record-equal, {n} records")
    lr = validate.simulate_long_reads(work / "lr100kb", 100_000, 1.0,
                                      seed=11, median=5000, sigma=0.0)
    for dev in ("cpu", "cuda"):
        out[dev] = str(work / f"lr100kb.{dev}.bam")
        w = run_cli(cli, ["--device", dev, "align", "-r", lr.ref,
                          "-1", lr.fastq, "-o", out[dev], "--long-reads",
                          "-f"])
        say(f"align --long-reads 100 kb ({lr.n_reads} reads of 5 kb) "
            f"--device {dev}: {w:.2f} s")
    n = same_bams(validate, out["cpu"], out["cuda"], "align --long-reads")
    say(f"align --long-reads cpu vs cuda: record-equal, {n} records")

    # (e) the gatk passthrough against the command it translates to
    dedup = str(run_dir_50kb / "dedup.bam")
    a, b = str(work / "gatk.vcf.gz"), str(work / "htc.vcf.gz")
    wa = run_cli(cli, ["--device", "cuda", "gatk", "HaplotypeCaller",
                       "-R", sample_50kb.ref, "-I", dedup, "-O", a, "-f"])
    wb = run_cli(cli, ["--device", "cuda", "htc", "-r", sample_50kb.ref,
                       "-i", dedup, "-o", b, "--produce-vcf", "-f"])
    va, vb = validate.vcf_records(a), validate.vcf_records(b)
    check(va == vb and len(va) > 0,
          "gatk HaplotypeCaller differs from htc --produce-vcf")
    say(f"gatk HaplotypeCaller -R -I -O on the 50 kb BAM ({wa:.2f} s) "
        f"record-equal to htc --produce-vcf ({wb:.2f} s): {len(va)} "
        f"records")
    for k in ("fgt_sw_full", "fgt_sw_traceback"):
        results[k]["launches_by_path"] = {
            "germline": results[k]["launches"],
            **results[k].get("launches_by_path", {}),
            **{path: n[k] for path, n in paths.items()}}
    return rows


# ---------------------------------------------------------------------------
# phase 6: the multi-device path
# ---------------------------------------------------------------------------

def phase_mesh(torch, P, validate, sample, run_dir: Path, k5_args, results,
               devs) -> None:
    """(a): a 4-shard mesh over ``devs`` against one device."""
    from falcon_genome_tpu_torch import parallel as TP
    from falcon_genome_tpu_torch.benchmarks import mesh_trace
    from falcon_genome_tpu_torch.bqsr import (
        MAX_CYCLE, N_CONTEXT, accumulate_table)

    mesh = TP.make_mesh(TP.MeshSpec(data=4, region=1), devs)
    R, H = k5_args[0].shape[1], k5_args[6].shape[1]
    read, bq, iq, dq, gq, rl, hp, hl = k5_args
    B = read.shape[0]
    rng = np.random.default_rng(11)
    n_cov = 1 << 20
    cov = [torch.from_numpy(x).to(devs[0]) for x in (
        np.zeros(n_cov, np.int32),
        rng.integers(0, 41, n_cov).astype(np.int32),
        rng.integers(0, MAX_CYCLE, n_cov).astype(np.int32),
        rng.integers(0, N_CONTEXT, n_cov).astype(np.int32),
        (rng.random(n_cov) < 0.01).astype(np.float32))]
    host = [t.cpu().numpy() for t in k5_args]
    params = P.PairHMMParams(max_read_len=R, max_hap_len=H, device=devs[0])

    def logp_planes():
        return P.pairhmm_logp(host[0], host[1], host[2], host[3], host[4],
                              host[5], host[6], host[7], params)

    # HaplotypeCaller's pair-indexed batch: 128 reads x 64 haplotypes
    pr, ph = np.repeat(np.arange(128), 64), np.tile(np.arange(64), 128)

    def logp_pairs():
        return P.pairhmm_logp_pairs(host[0][:128], host[1][:128],
                                    host[5][:128], host[6][:64],
                                    host[7][:64], pr, ph, 45, 45, 10, params)

    cols, covs, rgs = validate.bam_covariates(str(run_dir / "dedup.bam"),
                                              sample.ref)

    # single-device results (comparisons: their launches do not count)
    want = P.pairhmm_pb(read, bq, iq, dq, gq, rl, hp, hl)
    with TP.use_mesh(None):
        want_logp = logp_planes()
        want_pairs = logp_pairs()
        want_order = TP.coordinate_order(cols)
        want_table = accumulate_table(covs, rgs)
    torch.cuda.synchronize()

    for k in P.LAUNCHES:
        P.LAUNCHES[k] = 0
    t0 = time.time()
    step = TP.sharded_pairhmm_step(mesh, R, H)
    got = step(read, bq, iq, dq, gq, rl, hl, hp)
    logp, hist = TP.germline_train_step(mesh, R, H)(
        read, bq, iq, dq, gq, rl, hl, hp, *cov)
    with TP.use_mesh(mesh):
        got_logp = logp_planes()
        got_pairs = logp_pairs()
        got_order = TP.coordinate_order(cols)
        got_table = accumulate_table(covs, rgs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = P.LAUNCHES["fgt_pairhmm_pb"]
    check(torch.equal(got, want) and torch.equal(logp, want),
          "sharded K5 steps differ from the single-device K5 call")
    check(float(hist.sum()) == n_cov,
          "germline_train_step histogram sum differs from the count")
    check(np.array_equal(got_logp, want_logp),
          "pairhmm_logp with planes differs under the mesh")
    check(np.array_equal(got_pairs, want_pairs),
          "pairhmm_logp_pairs differs under the mesh")
    check(np.array_equal(got_order, want_order),
          "coordinate_order differs under the mesh")
    same_table = all(np.array_equal(getattr(got_table, f),
                                    getattr(want_table, f))
                     for f in ("qual_obs", "qual_err", "cycle_obs",
                               "cycle_err", "ctx_obs", "ctx_err"))
    check(same_table, "accumulate_table differs under the mesh")
    check(launches > 0, "K5 was not launched by the mesh path")
    t_mesh = cuda_ms(torch, lambda: step(read, bq, iq, dq, gq, rl, hl, hp),
                     3)
    t_one = cuda_ms(torch, lambda: P.pairhmm_pb(read, bq, iq, dq, gq, rl,
                                                hp, hl), 3)
    say(f"mesh 4 shards over {[str(d) for d in devs]}: sharded_pairhmm_step"
        f" and germline_train_step R={R} H={H} B={B} bit-equal to one K5 "
        f"call ({int(torch.isfinite(want).sum())} finite); histogram "
        f"{n_cov} covariates summed exactly; pairhmm_logp with planes "
        f"and pairhmm_logp_pairs (128 reads x 64 haplotypes) bit-equal; "
        f"coordinate_order of {len(cols)} records and "
        f"accumulate_table of {len(covs['rg'])} bases equal; K5 launches "
        f"{launches}; {wall:.2f} s; sharded_pairhmm_step {t_mesh:.3f} ms "
        f"vs one K5 call {t_one:.3f} ms: {t_mesh / t_one:.3f}x")
    trace = mesh_trace.trace_summary(
        lambda: step(read, bq, iq, dq, gq, rl, hl, hp))
    say(json.dumps({"mesh_step_trace": trace}))
    results["fgt_pairhmm_pb"]["launches"] = launches
    # the mesh cases against one card at 8192 pairs and at the callers'
    # median call (printed, not gated: a timing ratio is no check)
    cards = len(set(devs))
    for n, nh in mesh_trace.SIZES.items():
        m = mesh_trace.measure(P, TP, mesh, devs[0], n, nh, trace=False)
        check(all(m[k]["bit_equal"] for k in ("step", "logp_mesh",
                                              "pairs_mesh")),
              f"a mesh case at {n} pairs differs from one device")
        say(f"mesh of 4 shards over {cards} card(s), {n} pairs: bit-equal "
            f"to one device; " + "; ".join(
                f"{k} {r:.3f}x ({m[k.split('/')[0]]['ms']:.3f} / "
                f"{m[k.split('/')[1]]['ms']:.3f} ms)"
                for k, r in m["ratios"].items()))


def run_processes(argvs, log_dir: Path, timeout: float) -> list[str]:
    """Run the commands together; every process is ended before this
    returns.  Returns their combined output."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env,
                              cwd=str(log_dir))
             for a in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        (log_dir / f"process{i}.log").write_text(out)
        check(p.returncode == 0,
              f"process {i} exited {p.returncode}: {out[-2000:]}")
    return outs


def phase_dist(torch, cli, validate, sample, run_dir: Path, work: Path,
               device: str = "cuda") -> None:
    """(b): bqsr and htc through the CLI in two gloo processes vs one."""
    from falcon_genome_tpu_torch.bqsr import RecalTable

    work.mkdir(parents=True, exist_ok=True)
    common = ["-r", sample.ref, "-f", "-O", "gatk.ncontigs=8",
              "-O", "gatk.nprocs=1"]
    dedup = str(run_dir / "dedup.bam")

    def argv(cmd, inp, out, extra=()):
        return [cmd, "-i", inp, "-o", str(out), *common, *extra]

    t0 = time.time()
    one = work / "one"
    one.mkdir(exist_ok=True)
    for cmd, inp, out, extra in (
            ("bqsr", dedup, one / "recal.bam", ()),
            ("htc", str(one / "recal.bam"), one / "calls.vcf", ("-v",))):
        rc = cli.main(["--device", device, *argv(cmd, inp, out, extra),
                       "-O", f"log_dir={one / 'log'}"])
        check(rc == 0, f"single-process {cmd} exited {rc}")
    t1 = time.time()
    two = work / "two"
    two.mkdir(exist_ok=True)
    logs = []
    for cmd, inp, out, extra in (
            ("bqsr", dedup, two / "recal.bam", ()),
            ("htc", str(one / "recal.bam"), two / "calls.vcf", ("-v",))):
        # the processes meet through a file: process 0 binds a free port
        # and writes its number there
        coord = f"file://{two / f'rendezvous-{cmd}'}"
        logs.append(run_processes([
            [sys.executable, "-m", "falcon_genome_tpu_torch.cli",
             "--device", device, *argv(cmd, inp, out, extra),
             "-O", f"log_dir={two / f'log{i}'}",
             "-O", "tpu.dist.num_processes=2",
             "-O", f"tpu.dist.process_id={i}",
             "-O", f"tpu.dist.coordinator={coord}"]
            for i in range(2)], two, 600))
    t2 = time.time()
    for outs in logs:
        for i, out in enumerate(outs):
            check(f"local to process {i}/2" in out,
                  f"process {i} logged no task split")
    ta = RecalTable.load(str(one / "recal.recal.npz"))
    tb = RecalTable.load(str(two / "recal.recal.npz"))
    check(all(np.array_equal(getattr(ta, f), getattr(tb, f))
              for f in ("qual_obs", "qual_err", "cycle_obs", "cycle_err",
                        "ctx_obs", "ctx_err")),
          "two-process recal table differs from one process")
    d = validate.compare_bam(str(one / "recal.bam"), str(two / "recal.bam"),
                             compare_tags=True)
    check(d.equivalent, "two-process recalibrated BAM differs")
    va = validate.vcf_records(str(one / "calls.vcf"))
    vb = validate.vcf_records(str(two / "calls.vcf"))
    check(va == vb and len(va) > 0,
          "two-process VCF records differ from one process")
    n = max(1, torch.cuda.device_count())
    say(f"two gloo processes on {device}:{0 % n} and {device}:{1 % n}: "
        f"bqsr + htc "
        f"of the 50 kb sample, 8 shards split 4/4 per process; recal table "
        f"equal ({int(ta.qual_obs.sum())} bases), recalibrated BAM equal "
        f"({d.matching} records), VCF record-equal ({len(va)} records); "
        f"one process {t1 - t0:.2f} s, two processes {t2 - t1:.2f} s "
        f"(process start-up included)")


def phase_cards(cli, validate, sample, work: Path, count: int,
                device: str = "cuda") -> None:
    """(c), with more than one card: ``germline`` on the 50 kb sample with
    the CLI's default mesh (every card) against ``-O tpu.mesh.data=1``,
    run in the order one, mesh, mesh, one after the kernels are built;
    the outputs are record-equal and both walls are printed."""
    if count < 2:
        say("germline mesh over several cards vs one card: skipped, "
            "1 card visible")
        return
    work.mkdir(parents=True, exist_ok=True)
    out, walls = {}, {"one": [], "mesh": []}
    for i, tag in enumerate(("one", "mesh", "mesh", "one")):
        out[tag] = work / f"{tag}{i}.vcf.gz"
        single = ("-O", "tpu.mesh.data=1") if tag == "one" else ()
        r = run_germline(cli, sample, out[tag], device,
                         ("-O", "gatk.nprocs=1", *single))
        walls[tag].append(r)
        say(f"50 kb germline, {tag} ({count} cards visible): wall "
            f"{r['wall']:.3f} s, htc {r['stages']['htc']:.3f} s "
            f"(stages {json.dumps(r['stages'])})")
    cmp_ = validate.compare_runs(
        str(out["one"]) + ".work", str(out["mesh"]) + ".work",
        str(out["one"]), str(out["mesh"]))
    check(all(same for same, _ in cmp_["bam"].values())
          and cmp_["vcf_equivalent"] and cmp_["vcf_non_concordant"] == 0,
          "germline over the multi-card mesh differs from one card")
    med = {t: (statistics.median(r["wall"] for r in rs),
               statistics.median(r["stages"]["htc"] for r in rs))
           for t, rs in walls.items()}
    say(f"germline mesh over {count} cards vs one card: record-equal "
        f"({json.dumps(cmp_)}); median wall {med['mesh'][0]:.3f} s vs "
        f"{med['one'][0]:.3f} s, htc {med['mesh'][1]:.3f} s vs "
        f"{med['one'][1]:.3f} s")


# ---------------------------------------------------------------------------
# phase 7: the benchmark path (kernels K6, K7)
# ---------------------------------------------------------------------------

def phase_bench(torch, S, BK, results, so: Path, work: Path) -> None:
    from falcon_genome_tpu_torch import bench
    from falcon_genome_tpu_torch.benchmarks import ablate_sw, sass
    from falcon_genome_tpu_torch.ops import pairhmm as P
    dev = torch.device("cuda")

    # K6 at the bench's shape: K4's (160 rows, 2048 pairs) tile, 272
    # trips; random x, so a wrong row, lane or chain update shows
    R, B, trips = bench.BUCKET_R, bench.B, bench.fma_trips()
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0.5, 2.0, (R, B)).astype(np.float32)).to(dev)
    got = BK.fma_ceiling(x, trips)
    want = BK._fma_ceiling_plain(x, trips)
    torch.cuda.synchronize()
    e6 = float((got - want).abs().max())
    check(torch.equal(got, want),
          f"K6 differs from its plain version by {e6}")
    body, per_trip = sass.sass_ffma_per_trip(so, "fma_ceiling_kernel",
                                        BK.FMA_UNROLL)
    check(per_trip >= BK.FMA_CHAINS,
          f"K6's loop issues {per_trip} FFMAs per trip, not "
          f"{BK.FMA_CHAINS}: the chains were folded")
    t6 = cuda_ms(torch, lambda: BK.fma_ceiling(x, trips), 20)
    t6p = cuda_ms(torch, lambda: BK._fma_ceiling_plain(x, trips), 2)
    flops = BK.fma_ceiling_flops(R, B, trips)
    rate = flops / (t6 / 1e3)
    check(rate <= 1.05 * PEAK_F32,
          f"K6 measured {rate / 1e12:.1f} TFLOP/s, above 105% of the "
          f"{PEAK_F32 / 1e12:.0f} TFLOP/s float32 peak")
    say(f"K6 fgt_fma_ceiling R={R} B={B} trips={trips}, x uniform in "
        f"[0.5, 2): bit-equal to the plain version; {body} FFMAs in the "
        f"loop body, {per_trip} per trip; "
        f"kernel {t6:.4f} ms = {rate / 1e12:.2f} TFLOP/s "
        f"({rate / PEAK_F32:.1%} of {PEAK_F32 / 1e12:.0f}), plain "
        f"{t6p:.3f} ms")
    results["fgt_fma_ceiling"] = dict(
        max_abs_err=e6, ms=t6, plain_ms=t6p,
        **bound(4 * R * B + 4 * B, flops, PEAK_F32))

    # K7 at the ablation's shape, every variant, against the plain sweep
    # on the same card
    args = ablate_sw.inputs(np.random.default_rng(0), dev)
    read, rlen, win, wlen = args
    p = S.SWParams()
    k1 = S.sw_score(*args, p)
    flags = dict(no_best=False, no_mask=False, no_window=False)

    def plain7(kw):
        return BK._sw_ablate_plain(read.T.int(), rlen[None], win.T.int(),
                                   wlen[None], p, **{**flags, **kw})

    cells = (ablate_sw.R + ablate_sw.W) * ablate_sw.R * ablate_sw.B
    for name, kw in ablate_sw.VARIANTS:
        ks, kp = BK.sw_score_ablate(*args, p, **kw)
        ps, pp = plain7(kw)
        torch.cuda.synchronize()
        check(torch.equal(ks, ps) and torch.equal(kp, pp),
              f"K7 {name} differs from its plain version")
        if name == "base":
            check(torch.equal(ks, k1[0]) and torch.equal(kp, k1[1]),
                  "K7 base differs from K1")
        t7 = cuda_ms(torch, lambda kw=kw: BK.sw_score_ablate(*args, p, **kw),
                     10)
        t7p = cuda_ms(torch, lambda kw=kw: plain7(kw), 1)
        say(f"K7 fgt_sw_score_ablate {name} R={ablate_sw.R} W={ablate_sw.W}"
            f" B={ablate_sw.B}: bit-equal to the plain sweep"
            f"{' and to K1' if name == 'base' else ''}; kernel {t7:.3f} ms,"
            f" plain {t7p:.3f} ms")
        if name == "base":
            results["fgt_sw_score_ablate"] = dict(
                max_abs_err=0, ms=t7, plain_ms=t7p,
                **bound(read.numel() + win.numel() + 16 * ablate_sw.B,
                        SW_OPS_PER_CELL * cells, PEAK_INT32))

    # the entry points, each through its main, with the counts at 0
    for d in (S.LAUNCHES, P.LAUNCHES, BK.LAUNCHES):
        for k in d:
            d[k] = 0
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--work", str(work)])
    torch.cuda.synchronize()
    check(rc == 0, f"python -m falcon_genome_tpu_torch.bench exited {rc}")
    line = out.getvalue().strip().splitlines()[-1]
    res = json.loads(line)
    ex = res["extras"]
    check(res["metric"] == "pairhmm_forward_gcups" and res["value"] > 0
          and res["backend"] == "cuda"
          and res["device"] == torch.cuda.get_device_name(0)
          and all(ex[k] > 0 for k in ("sw_score_gcups",
                                      "align_pair_reads_per_s",
                                      "longread_mbp_per_s",
                                      "fma_ceiling_gflops", "pairhmm_mfu")),
          f"the bench's JSON line lacks a metric: {line}")
    check(ex["germline_e2e_sensitivity"] >= 0.98
          and ex["align_pair_mapped_frac"] >= 0.98,
          f"the bench's runs lost accuracy: {line}")
    launches = {k: n for d in (S.LAUNCHES, P.LAUNCHES, BK.LAUNCHES)
                for k, n in d.items() if n}
    check(BK.LAUNCHES["fgt_fma_ceiling"] > 0
          and BK.LAUNCHES["fgt_sw_score_ablate"] == 0,
          f"the bench did not launch K6 alone of the bench kernels: "
          f"{launches}")
    results["fgt_fma_ceiling"]["launches"] = BK.LAUNCHES["fgt_fma_ceiling"]
    say(f"bench ({time.time() - t0:.1f} s, kernel launches {launches}):")
    say(line)

    for k in BK.LAUNCHES:
        BK.LAUNCHES[k] = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ablate_sw.main()
    torch.cuda.synchronize()
    check(rc == 0, f"the ablation script exited {rc}")
    n7 = BK.LAUNCHES["fgt_sw_score_ablate"]
    check(n7 > 0, "the ablation script did not launch K7")
    results["fgt_sw_score_ablate"]["launches"] = n7
    say(f"ablation (K7 launches {n7}):")
    for ln in out.getvalue().strip().splitlines():
        say(f"  {ln}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        from falcon_genome_tpu_torch import cli, validate
        from falcon_genome_tpu_torch.ops import _build
        from falcon_genome_tpu_torch.ops import bench_kernels as BK
        from falcon_genome_tpu_torch.ops import pairhmm as P
        from falcon_genome_tpu_torch.ops import smith_waterman as S
        from falcon_genome_tpu_torch.benchmarks import sass
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    t_start = time.time()
    try:
        # phase 1: card
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, "nvidia-smi failed")
        say(smi.stdout.strip().splitlines()[0])
        say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
            f"{torch.cuda.get_device_name(0)} count "
            f"{torch.cuda.device_count()}; host C++ extension available: "
            f"{validate.host_extension_available()}")

        # phase 2: build
        t0 = time.time()
        so = _build.build()
        _build.load()
        report = so.with_name(so.stem + ".ptxas.txt").read_text()
        say(f"kernels built in {time.time() - t0:.1f} s → {so.name} "
            f"(one nvcc per source, in parallel); ptxas -v:")
        for row in sass.ptxas_summary(report):
            say(f"  {row}")
        # the PairHMM instantiations of the main path (five rows per
        # thread at R = 160; one instantiation a row count, every bucket)
        for name, per_base in (("K4 fgt_pairhmm", 0),
                               ("K5 fgt_pairhmm_pb", 1)):
            c = sass.sass_sweep_counts(
                so, f"pairhmm_kernelILi5ELb{per_base}ELb1EEEv")
            say(f"{name} pairhmm_kernel<5, {str(bool(per_base)).lower()}, "
                f"true>: {c['per_step']:.1f} instructions per "
                f"anti-diagonal step, {c['counted_per_step']:.1f} of them "
                f"FFMA/FMUL/FADD ({c['trip']} in a trip of "
                f"{c['steps_per_trip']:.0f} steps; the rescale block of "
                f"{c['cold_block']}, run once in 64 steps, left out)")
        sw_sweep_counts(so)
        ablate_sweep_counts(so)
        results: dict[str, dict] = {}
        k5_args, golden = phase_kernels(torch, S, P, results)
        work = REPO / "build" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        sample, run_dir, germline_1mb = phase_germline(
            torch, cli, S, P, validate, work, results)
        t11 = time.time()
        phase_wgs(torch, S, P, validate, work / "wgs")
        say(f"phase 11 (out-of-core germline rehearsal) "
            f"{time.time() - t11:.1f} s")
        t12 = time.time()
        phase_rehearsals(torch, S, P, results, work / "wgs" / "ooc",
                         work / "rehearsals")
        shutil.rmtree(work / "rehearsals", ignore_errors=True)
        say(f"phase 12 (somatic, mesh, long-read, indel and joint-cohort "
            f"rehearsals) {time.time() - t12:.1f} s")
        t13 = time.time()
        phase_rss(work / "wgs" / "ooc", work / "rss")
        shutil.rmtree(work / "wgs", ignore_errors=True)
        shutil.rmtree(work / "rss", ignore_errors=True)
        say(f"phase 13 (host memory) {time.time() - t13:.1f} s")
        t10 = time.time()
        phase_record_api(torch, S, sample, golden, results)
        say(f"phase 10 (align_pair_batch, golden models) "
            f"{time.time() - t10:.1f} s")
        t8 = time.time()
        buckets = phase_somatic(torch, cli, S, P, validate, work)
        phase_host(cli, *germline_1mb, work / "host")
        shutil.rmtree(work / "host", ignore_errors=True)
        say(json.dumps({"mutect2_buckets": buckets}))
        say(f"phase 8 (somatic path, host commands) "
            f"{time.time() - t8:.1f} s")
        t9 = time.time()
        buckets = phase_long_indel(torch, cli, S, P, validate, germline_1mb,
                                   sample, run_dir, work / "long_indel",
                                   results)
        shutil.rmtree(work / "1mb", ignore_errors=True)
        shutil.rmtree(work / "long_indel", ignore_errors=True)
        say(json.dumps({"long_read_indel_buckets": buckets}))
        say(f"phase 9 (long reads, indel, gatk) {time.time() - t9:.1f} s")
        t6 = time.time()
        count = torch.cuda.device_count()
        phase_mesh(torch, P, validate, sample, run_dir, k5_args, results,
                   [torch.device("cuda", i % count) for i in range(4)])
        phase_dist(torch, cli, validate, sample, run_dir, work / "dist")
        phase_cards(cli, validate, sample, work / "cards", count)
        say(f"phase 6 (multi-device) {time.time() - t6:.1f} s")
        shutil.rmtree(work, ignore_errors=True)
        t7 = time.time()
        work.mkdir(parents=True)
        phase_bench(torch, S, BK, results, so, work)
        shutil.rmtree(work, ignore_errors=True)
        say(f"phase 7 (benchmark path) {time.time() - t7:.1f} s")
    except (SmokeFailure, sass.SassError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(f"chip_smoke total {time.time() - t_start:.1f} s")
    # pairs a PairHMM call, of phase 4's germline and phase 8's mutect2
    say(json.dumps({"pairhmm_call_sizes": CALL_SIZES}))
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")
    # no single PyTorch call computes any of these functions
    rows = []
    for k, (src, rep) in KERNELS.items():
        rows.append(dict(name=k, route="cuda", source=src, replaces=rep,
                         **{f: results[k][f] for f in keys},
                         library_ms=None))
        if "launches_by_path" in results[k]:
            rows[-1]["launches_by_path"] = results[k]["launches_by_path"]
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
