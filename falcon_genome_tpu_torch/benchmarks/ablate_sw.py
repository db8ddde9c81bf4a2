"""Smith-Waterman score-kernel ablations on one NVIDIA GPU.

    python -m falcon_genome_tpu_torch.benchmarks.ablate_sw

The counterpart of ``benchmarks/ablate_sw.py``: kernel K7
(``fgt_sw_score_ablate``) runs the score-only sweep as it is (``base``)
and with one group of work removed -- the best-cell tracking, the
validity mask, or the window shift -- on the reference's inputs (2048
lanes of 150-base reads cut from 400-base windows, bucket 160 x 416).  It
prints each variant's time per call and GCUPS and the share of the base
time that removing the group saved.  The ablated variants compute other
scores on purpose; only their time is the point.  Times are CUDA events
around 20 launches after a warm-up, best of 3.  Without a CUDA device it
exits non-zero.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

R, W, B = 160, 416, 2048
READ_LEN, WIN_LEN = 150, 400
N_INNER = 20
VARIANTS = (("base", {}),
            ("no_best_tracking", {"no_best": True}),
            ("no_valid_mask", {"no_mask": True}),
            ("no_window_shift", {"no_window": True}))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_sw: no CUDA device; the ablation times the card's "
              "kernel and has no CPU mode", file=sys.stderr)
        return 1
    per = run(torch.device("cuda", 0))
    base = per["base"]
    for name, sec in per.items():
        gcups = B * READ_LEN * WIN_LEN / sec / 1e9
        line = f"{name:<22} {sec * 1e3:7.3f} ms/call  {gcups:7.2f} GCUPS"
        if name != "base":
            line += f"  saved {(base - sec) / base:.1%} of base"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
