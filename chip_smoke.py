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
   path's shapes: Smith-Waterman K1-K3 bit-equal, PairHMM K4 within 1e-4
   log10 with the same -inf lanes; median times of both;
4. ``germline`` end to end through the CLI (``--device cuda``) on a
   simulated 1 Mb contig at 30x (150 bp pairs), with per-stage wall time,
   reads/s, kernel launch counts (each must be > 0) and call accuracy
   against the planted truth (SNP sensitivity and precision >= 0.98);
5. the same slice on a 50 kb cut with ``--device cpu`` and ``--device
   cuda``: BAMs record-equivalent, VCF with 0 non-concordant records.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import logging
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
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


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
    launches = {**S.LAUNCHES, **P.LAUNCHES}
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
        regs = [ln.split("ptxas info    : ")[-1] for ln in report.splitlines()
                if "registers" in ln]
        say(f"kernels built in {time.time() - t0:.1f} s → {so.name}; "
            f"ptxas: {'; '.join(regs)}")

        results: dict[str, dict] = {}
        phase_kernels(torch, S, P, results)
        work = REPO / "build" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        phase_germline(torch, cli, S, P, validate, work, results)
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
