#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``falcon_genome_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its numbers; any failure exits non-zero):

1. card: device name, ``nvidia-smi`` name and power limit, whether the
   host C++ extension built;
2. build: compiles the CUDA kernels from ``falcon_genome_tpu_torch/csrc``
   (nvcc, sm_90a) and reports build time, registers and spills;
3. kernels vs their plain PyTorch versions on the card at the main
   path's shapes: Smith-Waterman K1-K3 bit-equal, PairHMM K4 (scalar
   transitions) and K5 (per-base transition planes) within 1e-4 log10
   with the same -inf lanes; median times of both;
4. ``germline`` end to end through the CLI (``--device cuda``) on a
   simulated 1 Mb contig at 30x (150 bp pairs), with per-stage wall time,
   reads/s, kernel launch counts (each must be > 0) and call accuracy
   against the planted truth (SNP sensitivity and precision >= 0.98);
5. the same slice on a 50 kb cut with ``--device cpu`` and ``--device
   cuda``: BAMs record-equivalent, VCF with 0 non-concordant records;
6. the multi-device path: (a) on a 4-shard mesh over the visible cards
   (``cuda:(i % count)``) the sharded steps (K5 on every shard plus the
   summed BQSR histogram) and ``pairhmm_logp`` with planes equal the
   single-device K5 call, and ``accumulate_table`` / ``coordinate_order``
   equal their single-device results on the 50 kb sample's records;
   (b) ``bqsr`` and ``htc`` through the CLI in two ``gloo`` processes
   (``tpu.dist.*``) equal a single-process run: recal table and BAM,
   VCF records; (c) only where more than one card is visible (``chiprun
   --chips 4``), ``germline`` on 50 kb with the CLI's default mesh over
   every card against one card (``-O tpu.mesh.data=1``): record-equal,
   with both walls.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import socket
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
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def ptxas_summary(report: str) -> list[str]:
    """``name: N registers, S B spill stores, L B spill loads`` for every
    kernel in an ``nvcc -Xptxas -v`` report (names demangled with
    c++filt where it exists)."""
    rows, name, spill = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append([name, f"{m.group(1)} registers, {spill}"])
            name, spill = None, ""
    if rows and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True)
        if res.returncode == 0:
            for r, d in zip(rows, res.stdout.splitlines()):
                r[0] = re.sub(r"\(.*\)$", "", d.replace(
                    "(anonymous namespace)::", ""))
    return [f"{n}: {v}" for n, v in rows]


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
    results["fgt_sw_score"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p)

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
        say(f"K2+K3 {label} R={R} W={W} B={B} params={tuple(vars(p).values())}"
            f": bit-equal best, bestpos, op streams, coords; "
            f"K2 kernel {t2:.3f} ms plain {t2p:.3f} ms; "
            f"K3 kernel {t3:.3f} ms plain {t3p:.3f} ms "
            f"(max_steps {steps}, mapped {int((kbest > 0).sum())}/{B})")
        k2.append((e2, t2, t2p))
        k3.append((e3, t3, t3p))
        del kptr, pptr
    # the aligner-winner shape is the main path's; the others are printed
    results["fgt_sw_full"] = dict(max_abs_err=max(e for e, _, _ in k2),
                                  ms=k2[0][1], plain_ms=k2[0][2])
    results["fgt_sw_traceback"] = dict(max_abs_err=max(e for e, _, _ in k3),
                                       ms=k3[0][1], plain_ms=k3[0][2])

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
    kl = P.pairhmm_sc(*args, 45, 45, 10)
    pl = P._pairhmm_plain(args[0].T, args[1].T, 45, 45, 10, args[2][None],
                          args[4][None], args[3].T, R=R, H=H)
    torch.cuda.synchronize()
    fin = torch.isfinite(pl)
    check(torch.equal(fin, torch.isfinite(kl)),
          "K4 -inf lanes differ from the plain version")
    e4 = float((kl[fin] - pl[fin]).abs().max())
    check(e4 <= 1e-4, f"K4 differs from the plain version by {e4}")
    n_resc = int(fin.cpu().numpy()[resc].sum())
    check(n_resc == len(resc), "K4 rescaling pairs floored to -inf")
    t4 = cuda_ms(torch, lambda: P.pairhmm_sc(*args, 45, 45, 10), 5)
    t4p = cuda_ms(torch, lambda: P._pairhmm_plain(
        args[0].T, args[1].T, 45, 45, 10, args[2][None], args[4][None],
        args[3].T, R=R, H=H), 2)
    inf_related = int((~fin).cpu().numpy()[~unrelated].sum())
    say(f"K4 fgt_pairhmm R={R} H={H} B={B} 45/45/10, quals 10-40: "
        f"max |dlog10| {e4:.3g} on {int(fin.sum())} finite pairs; -inf "
        f"lanes equal: {int((~fin).sum())} ({int(unrelated.sum())} pairs "
        f"unrelated, {inf_related} -inf among related); {n_resc} pairs "
        f"finite only through rescaling; kernel {t4:.3f} ms,"
        f" plain {t4p:.3f} ms")
    results["fgt_pairhmm"] = dict(max_abs_err=e4, ms=t4, plain_ms=t4p)

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
    torch.cuda.synchronize()
    fin = torch.isfinite(pl)
    check(torch.equal(fin, torch.isfinite(kl)),
          "K5 -inf lanes differ from the plain version")
    e5 = float((kl[fin] - pl[fin]).abs().max())
    check(e5 <= 1e-4, f"K5 differs from the plain version by {e5}")
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
        f"{int(fin.sum())} finite pairs; -inf lanes equal: "
        f"{int((~fin).sum())}; {n_craft} crafted pad-row pairs finite, "
        f"-inf without the rescale; kernel {t5:.3f} ms, plain {t5p:.3f} ms")
    results["fgt_pairhmm_pb"] = dict(max_abs_err=e5, ms=t5, plain_ms=t5p)
    return k5_args


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
    r = run_germline(cli, sample, work / "1mb" / "calls.vcf.gz", "cuda")
    torch.cuda.synchronize()
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
    shutil.rmtree(work / "1mb", ignore_errors=True)

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
    return sample, Path(str(out["cuda"]) + ".work")


# ---------------------------------------------------------------------------
# phase 6: the multi-device path
# ---------------------------------------------------------------------------

def phase_mesh(torch, P, validate, sample, run_dir: Path, k5_args, results,
               devs) -> None:
    """(a): a 4-shard mesh over ``devs`` against one device."""
    from falcon_genome_tpu_torch import parallel as TP
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

    cols, covs, rgs = validate.bam_covariates(str(run_dir / "dedup.bam"),
                                              sample.ref)

    # single-device results (comparisons: their launches do not count)
    want = P.pairhmm_pb(read, bq, iq, dq, gq, rl, hp, hl)
    with TP.use_mesh(None):
        want_logp = logp_planes()
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
        f"bit-equal; coordinate_order of {len(cols)} records and "
        f"accumulate_table of {len(covs['rg'])} bases equal; K5 launches "
        f"{launches}; {wall:.2f} s; sharded_pairhmm_step {t_mesh:.3f} ms "
        f"vs one K5 call {t_one:.3f} ms")
    results["fgt_pairhmm_pb"]["launches"] = launches


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


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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
        port = free_port()
        logs.append(run_processes([
            [sys.executable, "-m", "falcon_genome_tpu_torch.cli",
             "--device", device, *argv(cmd, inp, out, extra),
             "-O", f"log_dir={two / f'log{i}'}",
             "-O", "tpu.dist.num_processes=2",
             "-O", f"tpu.dist.process_id={i}",
             "-O", f"tpu.dist.coordinator=localhost:{port}"]
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        from falcon_genome_tpu_torch import cli, validate
        from falcon_genome_tpu_torch.ops import _build
        from falcon_genome_tpu_torch.ops import pairhmm as P
        from falcon_genome_tpu_torch.ops import smith_waterman as S
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
        for row in ptxas_summary(report):
            say(f"  {row}")

        results: dict[str, dict] = {}
        k5_args = phase_kernels(torch, S, P, results)
        work = REPO / "build" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        sample, run_dir = phase_germline(torch, cli, S, P, validate, work,
                                         results)
        t6 = time.time()
        count = torch.cuda.device_count()
        phase_mesh(torch, P, validate, sample, run_dir, k5_args, results,
                   [torch.device("cuda", i % count) for i in range(4)])
        phase_dist(torch, cli, validate, sample, run_dir, work / "dist")
        phase_cards(cli, validate, sample, work / "cards", count)
        say(f"phase 6 (multi-device) {time.time() - t6:.1f} s")
        shutil.rmtree(work, ignore_errors=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(f"chip_smoke total {time.time() - t_start:.1f} s")
    say(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep,
             launches=results[k]["launches"],
             max_abs_err=results[k]["max_abs_err"], ms=results[k]["ms"],
             plain_ms=results[k]["plain_ms"])
        for k, (src, rep) in KERNELS.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
