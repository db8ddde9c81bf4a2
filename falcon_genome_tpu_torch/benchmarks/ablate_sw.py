"""Smith-Waterman score-kernel ablations on one NVIDIA GPU.

    python -m falcon_genome_tpu_torch.benchmarks.ablate_sw

The counterpart of ``benchmarks/ablate_sw.py``: kernel K7
(``fgt_sw_score_ablate``) runs the score-only sweep as it is (``base``)
and with one group of work removed -- the best-cell tracking, the
validity mask, or the window shift -- on the reference's inputs (2048
lanes of 150-base reads cut from 400-base windows, bucket 160 x 416).  It
prints each variant's time per call and GCUPS and the share of the base
time that removing the group saved, and beside it the card's prediction
of that share: the variant's instructions per sweep step in the SASS of
its instantiation (``sass.sass_step_loops``; null where the toolkit's
``cuobjdump`` is missing) against the base's, weighted over the steps of
each of the sweep's loops (the guarded steps before and after the band
included), all instructions and those other than IMAD.  The ablated
variants compute other scores on purpose; only their time is the point.
Times are CUDA events around 20 launches after a warm-up, best of 3.  The
last line is one JSON object with every number printed.  Without a CUDA
device it exits non-zero.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

R, W, B = 160, 416, 2048
READ_LEN, WIN_LEN = 150, 400
N_INNER = 20
VARIANTS = (("base", {}),
            ("no_best_tracking", {"no_best": True}),
            ("no_valid_mask", {"no_mask": True}),
            ("no_window_shift", {"no_window": True}))
# K7's instantiation at R = 160 (5 rows a thread, one stripe) for the
# flags (no_best, no_mask, no_window), as mangled in the library
K7_KERNEL = r"16sw_ablate_kernelILi5ELb0ELb{:d}ELb{:d}ELb{:d}EE"


def inputs(rng, device: torch.device):
    """Lane-major (read, rlen, win, wlen) as the reference's ablation:
    reads copied from their windows without substitutions."""
    win = np.full((B, W), 4, np.int8)
    win[:, :WIN_LEN] = rng.integers(0, 4, (B, WIN_LEN))
    read = np.full((B, R), 4, np.int8)
    for b in range(B):
        s = rng.integers(0, WIN_LEN - READ_LEN + 1)
        read[b, :READ_LEN] = win[b, s:s + READ_LEN]
    return tuple(torch.from_numpy(a).to(device) for a in (
        read, np.full(B, READ_LEN, np.int32), win,
        np.full(B, WIN_LEN, np.int32)))


def run(device: torch.device) -> dict[str, float]:
    """Seconds per call of each variant, in ``VARIANTS`` order."""
    from ..bench import timed
    from ..ops.bench_kernels import sw_score_ablate
    from ..ops.sw_ref import SWParams
    args = inputs(np.random.default_rng(0), device)
    params = SWParams()
    return {name: timed(lambda kw=kw: sw_score_ablate(*args, params, **kw),
                        device, N_INNER)
            for name, kw in VARIANTS}


def sweep_steps(R: int, W: int) -> dict[str, int]:
    """Steps of a stripe of K7 (``csrc/bench_kernels.cu``) in each of its
    loops: the guarded loop before the band runs steps [0, lag), the
    unguarded loop whole trips of 8 from lag on, the guarded loop after
    the band the rest, up to R + W + lag (lag = 32 (NR - 1) < R)."""
    lag = 32 * (min((R + 31) // 32, 12) - 1)
    clean = (R + W - lag) // 8 * 8
    return dict(pre=lag, clean=clean, post=R + W - clean)


def sass_counts(so: Path) -> dict[str, dict | None]:
    """Per variant: instructions per step of each loop of its sweep (the
    unguarded loop and the guarded loops before and after the band) in
    the SASS of the built library, and per stripe of the sweep at the
    ablation's bucket, all of them and those other than IMAD; None where
    the SASS cannot be read."""
    from . import sass
    steps = sweep_steps(R, W)
    out = {}
    for name, kw in VARIANTS:
        flags = (kw.get("no_best", False), kw.get("no_mask", False),
                 kw.get("no_window", False))
        try:
            loops = sass.sass_step_loops(so, K7_KERNEL.format(*flags),
                                         count=sass.IMAD)
            if len(loops) != 3:
                raise sass.SassError(f"{len(loops)} sweep loops, not 3")
        except (sass.SassError, OSError) as e:
            print(f"ablate_sw: no SASS count for {name}: {e}",
                  file=sys.stderr)
            out[name] = None
            continue
        per = dict(zip(("clean", "pre", "post"), loops))
        out[name] = dict(
            per_step={k: v[1] for k, v in per.items()},
            per_sweep=sum(v[1] * steps[k] for k, v in per.items()),
            imad_per_sweep=sum(v[2] * steps[k] for k, v in per.items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_sw: no CUDA device; the ablation times the card's "
              "kernel and has no CPU mode", file=sys.stderr)
        return 1
    from ..ops import _build
    per = run(torch.device("cuda", 0))
    counts = sass_counts(_build.build())
    base, cb = per["base"], counts["base"]
    rows = {}
    for name, sec in per.items():
        c = counts[name]
        row = dict(ms=sec * 1e3, gcups=B * READ_LEN * WIN_LEN / sec / 1e9,
                   **(c or dict(per_step=None, per_sweep=None,
                                imad_per_sweep=None)))
        line = (f"{name:<22} {row['ms']:7.3f} ms/call  {row['gcups']:7.2f} "
                f"GCUPS  instructions/step ")
        line += ("null" if c is None else
                 "{clean:.2f} (guarded {pre:.1f} / {post:.1f})".format(
                     **c["per_step"]))
        if name != "base":
            row["saved"] = (base - sec) / base
            row["predicted"] = row["predicted_non_imad"] = None
            if c and cb:
                row["predicted"] = 1 - c["per_sweep"] / cb["per_sweep"]
                row["predicted_non_imad"] = 1 - (
                    c["per_sweep"] - c["imad_per_sweep"]) / (
                    cb["per_sweep"] - cb["imad_per_sweep"])
            pred = ("null" if row["predicted"] is None else
                    f"{row['predicted']:.1%} (other than IMAD "
                    f"{row['predicted_non_imad']:.1%})")
            line += f"  predicted {pred}, measured {row['saved']:.1%}"
        rows[name] = row
        print(line, flush=True)
    print(json.dumps({"bucket": [R, W, B], "steps": sweep_steps(R, W),
                      "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
