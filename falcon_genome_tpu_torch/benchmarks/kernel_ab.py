"""Kernel times of several checkouts of the port, interleaved on one NVIDIA
GPU: Smith-Waterman K1-K3, PairHMM K4/K5 and the ablation kernel K7.

    python -m falcon_genome_tpu_torch.benchmarks.kernel_ab [--pairhmm]
        ROOT [ROOT ...]

Each ROOT is a checkout of the repository (an unpacked ``git archive`` of
another commit, say).  In the order given, each runs in a process of its
own with ROOT first on ``sys.path``: it builds that checkout's kernels,
then times, each through its wrapper:

* K1 (``sw_score``), K2 (``sw_pointers``) and K3 (``sw_traceback`` of K2's
  pointers) at the aligner's shape (R=160, W=256, 8192 lanes; the inputs
  of ``chip_smoke.py``'s ``sw_lanes``: 150-base reads with 1%
  substitutions, a quarter of them against a window elsewhere); K2 and K3
  also at the mate-rescue shape (160/1024, 2048 lanes) and at
  HaplotypeCaller's haplotype-to-reference shape (384/384, 1024 lanes,
  parameters 2/6/12/1), keys ``k2_rescue_*``, ``k2_htc_*`` and the same
  for k3;
* K4 (``pairhmm_sc``, 45/45/10) and K5 (``pairhmm_pb``, per-base planes)
  at HaplotypeCaller's shape (R=160, H=384, 8192 pairs, the inputs of
  ``chip_smoke.py``'s phase 3 without its crafted pairs: reads of 100-152
  bases), each also on reads that fill the bucket (160 bases, keys
  ``k4_full``, ``k5_full``: the same pairs, K5 with their planes) and on
  the main pairs with a quality-0 first base, whose rescale can fire past
  their end (``k4_late``, ``k5_late``);

each three ways; and K7 (``sw_score_ablate``) in the ablation's four
variants at its bucket (R=160, W=416, 2048 lanes; ``ablate_sw.inputs``),
keys ``k7_base_*``, ``k7_no_best_tracking_*`` and so on, waited for and
kernel-only.  ``*_ms``: CUDA events around each of 20 calls after a
warm-up, each call waited for, the median (what a caller that reads every
result back sees, the wrapper's host work included).  ``*_queued_ms``:
events around 20 calls queued back to back, per call, the median of 5
such runs (the device's time per call once the host runs ahead).
``*_kernel_ms``: the kernel's own device time per launch from
``torch.profiler`` over 5 calls (profiled again, up to three times,
where it records no device time; null if it never does).  It also reads
the checkout's build: registers of the K1 and K2 instantiations at R=160
(``ptxas -v``) and their instructions per sweep step and integer max/min
per step (``cuobjdump -sass``, null where the toolkit's ``cuobjdump`` is
missing); K3's registers and the instructions of one trip of its walk
loop (``k3_per_trip``); K7's registers and instructions per sweep step
of each variant's instantiation at R = 160 (``k7_<variant>_registers``,
``k7_<variant>_per_step``).  With ``--pairhmm`` it times K4 and K5
alone (``k4_*``, ``k4_full_*``, ``k4_late_*`` and the same for k5).  Give the roots as parent, change, change, parent,
so that drift of the card between runs shows.
Prints one JSON line per run; without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

B, R, H = 8192, 160, 384
N_TIMED = 20
# (label, lanes, R, W, SW parameters or None for the defaults)
SW_SHAPES = (("", 8192, 160, 256, None), ("rescue", 2048, 160, 1024, None),
             ("htc", 1024, 384, 384, (2, 6, 12, 1)))
# the mangled K1 / K2 kernel at R = 160: the one-stripe design's
# sw_kernel<bool FULL> or the rows-per-thread design's sw_kernel<5, FULL, ...>
SW_MAIN = r"9sw_kernelI(?:Li5E)?Lb{}E(?:Lb0E)?E"
# K7 at R = 160 for the flags (no_best, no_mask, no_window): the earlier
# design's sw_ablate_kernel<flags...> or sw_ablate_kernel<5, false, ...>
K7_MAIN = r"16sw_ablate_kernelI(?:Li5ELb0E)?Lb{:d}ELb{:d}ELb{:d}EE"
K7_VARIANTS = (("base", (0, 0, 0)), ("no_best_tracking", (1, 0, 0)),
               ("no_valid_mask", (0, 1, 0)), ("no_window_shift", (0, 0, 1)))


def inputs(rng):
    """Lane-major K5 arguments (read, q, ins, del, gcp, rlen, hap, hlen):
    reads cut from their haplotypes with 1% substitutions, an eighth of
    them unrelated, base qualities 10-40, indel phreds 25-45, gcp 10."""
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
    return (reads, quals, *gap_planes(rng, rlen), rlen, haps, hl)


def gap_planes(rng, rlen):
    """K5's (ins, del, gcp) planes: indel phreds 25-45, gcp 10, phred 0
    past each read."""
    pad = np.arange(R)[None, :] >= rlen[:, None]
    ins = rng.integers(25, 46, (B, R)).astype(np.uint8)
    dele = rng.integers(25, 46, (B, R)).astype(np.uint8)
    gcp = np.full((B, R), 10, np.uint8)
    for x in (ins, dele, gcp):
        x[pad] = 0
    return ins, dele, gcp


def full_reads(rng):
    """Lane-major K4 arguments (read, q, rlen, hap, hlen) whose reads fill
    the bucket: 160 bases cut from haplotypes of 250-384 with 1%
    substitutions, base qualities 10-40."""
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    hl = rng.integers(250, H + 1, B).astype(np.int32)
    rlen = np.full(B, R, np.int32)
    reads = np.empty((B, R), np.uint8)
    for b in range(B):
        s = int(rng.integers(0, hl[b] - R))
        seg = haps[b, s:s + R].copy()
        m = rng.random(R) < 0.01
        seg[m] = (seg[m] + 1) % 4
        reads[b] = seg
    quals = rng.integers(10, 41, (B, R)).astype(np.uint8)
    return reads, quals, rlen, haps, hl


def sw_lanes(rng, genome, n, r, w, rl_range, sub=0.01, decoys=0.25):
    """Reads sampled from ``genome`` with ``sub`` substitutions, against
    windows that hold them (a ``decoys`` share of windows are elsewhere);
    ``chip_smoke.py``'s generator."""
    rl = rng.integers(rl_range[0], rl_range[1] + 1, n).astype(np.int32)
    wl = np.full(n, w - 8, np.int32)
    read = np.full((n, r), 4, np.int8)
    win = np.empty((n, w), np.int8)
    for b in range(n):
        w0 = int(rng.integers(0, len(genome) - w))
        win[b] = genome[w0:w0 + w]
        s = w0 + int(rng.integers(0, w - 8 - rl[b]))
        if rng.random() < decoys:
            s = int(rng.integers(0, len(genome) - rl[b]))
        seg = genome[s:s + rl[b]].copy()
        m = rng.random(rl[b]) < sub
        seg[m] = (seg[m] + 1) % 4
        read[b, :rl[b]] = seg
    return read, rl, win, wl


def hap_lanes(rng, n, r, w):
    """HaplotypeCaller hap -> region-reference lanes (a SNP and an indel
    per haplotype); ``chip_smoke.py``'s generator."""
    read = np.full((n, r), 4, np.int8)
    win = rng.integers(0, 4, (n, w)).astype(np.int8)
    rl = np.zeros(n, np.int32)
    wl = rng.integers(w - 80, w + 1, n).astype(np.int32)
    for b in range(n):
        ref = win[b, :wl[b]].copy()
        p = int(rng.integers(20, len(ref) - 20))
        ref[p] = (ref[p] + 1) % 4
        q = int(rng.integers(20, len(ref) - 20))
        L = int(rng.integers(1, 8))
        hap = (np.concatenate([ref[:q], ref[q + L:]]) if b % 2 else
               np.concatenate([ref[:q], rng.integers(0, 4, L), ref[q:]]))
        hap = hap[:r].astype(np.int8)
        read[b, :len(hap)] = hap
        rl[b] = len(hap)
    return read, rl, win, wl


def event_ms(fn, calls: int) -> float:
    """Milliseconds between CUDA events around ``calls`` calls of ``fn``
    queued back to back; the last one is waited for."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def median_ms(fn) -> float:
    """One call at a time, each waited for: the median of N_TIMED."""
    fn()
    return statistics.median(event_ms(fn, 1) for _ in range(N_TIMED))


def queued_ms(fn) -> float:
    """N_TIMED calls back to back, per call: the median of 5 such runs."""
    fn()
    return statistics.median(event_ms(fn, N_TIMED) / N_TIMED
                             for _ in range(5))


def kernel_ms(fn, name: str, tries: int = 3) -> float | None:
    """Device time per launch of the kernels whose name holds ``name``;
    a profile that recorded no device time for them is taken again, up
    to ``tries`` profiles."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = (getattr(e, "device_time_total", None) or
                  getattr(e, "cuda_time_total", 0))
            if name in e.key and e.count and us:
                return us / e.count / 1e3
    return None


def three_ways(key: str, fn, name: str, queued: bool = True) -> dict:
    out = {f"{key}_ms": median_ms(fn)}
    if queued:
        out[f"{key}_queued_ms"] = queued_ms(fn)
    out[f"{key}_kernel_ms"] = kernel_ms(fn, name)
    return out


def build_counts(so: Path) -> dict:
    """Registers and SASS counts of the K1, K2 and K7 kernels at R = 160,
    and of K3 (registers, instructions in its walk loop)."""
    # this file's own sass.py: an older root's package may have none
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import sass
    out = {}
    report = so.with_name(so.stem + ".ptxas.txt")
    text = report.read_text() if report.exists() else ""
    for key, full in (("k1", 0), ("k2", 1)):
        pat = SW_MAIN.format(full)
        out[f"{key}_registers"] = sass.kernel_registers(text, pat)
        try:
            c = sass.sass_sweep_counts(so, pat, loop_by=sass.SHFL_UP,
                                       count=sass.MNMX, shfl_per_step=2)
            out[f"{key}_per_step"] = c["per_step"]
            out[f"{key}_mnmx_per_step"] = c["counted_per_step"]
        except (sass.SassError, OSError) as e:
            print(f"kernel_ab: no SASS count for {key}: {e}",
                  file=sys.stderr)
            out[f"{key}_per_step"] = out[f"{key}_mnmx_per_step"] = None
    for name, flags in K7_VARIANTS:
        pat = K7_MAIN.format(*flags)
        out[f"k7_{name}_registers"] = sass.kernel_registers(text, pat)
        try:
            out[f"k7_{name}_per_step"] = sass.sass_sweep_counts(
                so, pat, loop_by=sass.SHFL_UP, shfl_per_step=2)["per_step"]
        except (sass.SassError, OSError) as e:
            print(f"kernel_ab: no SASS count for k7 {name}: {e}",
                  file=sys.stderr)
            out[f"k7_{name}_per_step"] = None
    out["k3_registers"] = sass.kernel_registers(text, "sw_traceback_kernel")
    try:
        out["k3_per_trip"] = sass.sass_loop_size(so, "sw_traceback_kernel")
    except (sass.SassError, OSError) as e:
        print(f"kernel_ab: no SASS count for k3: {e}", file=sys.stderr)
        out["k3_per_trip"] = None
    return out


def time_root(root: Path, pairhmm_only: bool = False) -> dict:
    """Build ``root``'s kernels and time its K1-K5 and K7, or K4 and K5
    alone (this process imports only ``root``'s package)."""
    sys.path.insert(0, str(root))
    from falcon_genome_tpu_torch.benchmarks import ablate_sw as A
    from falcon_genome_tpu_torch.ops import _build
    from falcon_genome_tpu_torch.ops import bench_kernels as BK
    from falcon_genome_tpu_torch.ops import pairhmm as P
    from falcon_genome_tpu_torch.ops import smith_waterman as S
    if not Path(P.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {P.__file__}, not {root}'s package")
    so = _build.build()
    dev = torch.device("cuda", 0)
    res = {"root": str(root)}

    def to(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in xs]

    # K5's arguments; K4's are the same less the indel planes
    hmm = to(*inputs(np.random.default_rng(7)))
    k4_args = [hmm[i] for i in (0, 1, 5, 6, 7)]
    res.update(three_ways(
        "k4", lambda: P.pairhmm_sc(*k4_args, 45, 45, 10), "pairhmm_kernel"))
    full = to(*full_reads(np.random.default_rng(8)))
    res.update(three_ways(
        "k4_full", lambda: P.pairhmm_sc(*full, 45, 45, 10),
        "pairhmm_kernel"))
    late = list(k4_args)
    late[1] = late[1].clone()
    late[1][:, 0] = 0      # a quality-0 first base: every pair is late
    res.update(three_ways(
        "k4_late", lambda: P.pairhmm_sc(*late, 45, 45, 10),
        "pairhmm_kernel"))
    res.update(three_ways(
        "k5", lambda: P.pairhmm_pb(*hmm), "pairhmm_kernel"))
    full5 = [*full[:2], *to(*gap_planes(np.random.default_rng(9),
                                        np.full(B, R))), *full[2:]]
    res.update(three_ways(
        "k5_full", lambda: P.pairhmm_pb(*full5), "pairhmm_kernel"))
    late5 = [hmm[0], late[1], *hmm[2:]]
    res.update(three_ways(
        "k5_late", lambda: P.pairhmm_pb(*late5), "pairhmm_kernel"))
    if pairhmm_only:
        return res
    res.update(build_counts(so))

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 1_000_000).astype(np.int8)
    for label, n, r, w, params in SW_SHAPES:
        p = S.SWParams(*params) if params else S.SWParams()
        if label == "htc":
            read, rl, win, wl = to(*hap_lanes(rng, n, r, w))
            steps = r + w
        else:
            read, rl, win, wl = to(*sw_lanes(rng, genome, n, r, w,
                                             (150, 150)))
            # the bucket only sizes the step bound
            steps = S._traceback_steps_bound(
                150, w - 8, p, S.SWBucket(r, w, torch.device("cpu")))
        ptr, best, pos = S.sw_pointers(read, rl, win, wl, p)
        suffix = f"_{label}" if label else ""
        if not label:
            res.update(three_ways(
                "k1", lambda: S.sw_score(read, rl, win, wl, p), "sw_kernel"))
        res.update(three_ways(
            f"k2{suffix}", lambda: S.sw_pointers(read, rl, win, wl, p),
            "sw_kernel", queued=not label))
        res.update(three_ways(
            f"k3{suffix}", lambda: S.sw_traceback(ptr, best, pos, steps),
            "sw_traceback_kernel", queued=not label))
        del ptr

    args = A.inputs(np.random.default_rng(0), dev)
    p = S.SWParams()
    for name, kw in A.VARIANTS:
        res.update(three_ways(
            f"k7_{name}", lambda kw=kw: BK.sw_score_ablate(*args, p, **kw),
            "sw_ablate_kernel", queued=False))
    return res


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; it times the card's kernels and "
              "has no CPU mode", file=sys.stderr)
        return 1
    pairhmm = argv[:1] == ["--pairhmm"]
    argv = argv[pairhmm:]
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_root(Path(argv[1]).resolve(), pairhmm)),
              flush=True)
        return 0
    if not argv:
        print("usage: kernel_ab [--pairhmm] ROOT [ROOT ...]",
              file=sys.stderr)
        return 2
    rc = 0
    for root in argv:   # a root that fails is reported, the others still run
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             *(["--pairhmm"] if pairhmm else []), "--one", root],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            print(json.dumps({"root": root, "error": res.returncode}),
                  flush=True)
            rc = 1
            continue
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
