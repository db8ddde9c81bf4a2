"""The H100's published peaks, and the operations and bytes that the
port's kernels need for given inputs.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit):

* ``PEAK_F32_FLOPS``: 67 TFLOP/s of float32 outside the tensor cores
  (132 SMs x 128 FP32 lanes x 2 flops per fused multiply-add x 1.98 GHz).
* ``PEAK_HBM_BYTES``: 3.35 TB/s of HBM3.

Counts follow the algorithm at each pair's real lengths, the
same whatever implements it; each input byte is counted once, each
output byte once.

PairHMM (kernel K4, ``csrc/pairhmm.cu``): a cell of the read x haplotype
matrix costs the recurrence of the source's header,

    M = prior * fma(M', a_mm, (I' + D') * a_im)    add, mul, fma, mul: 5
    I = fma(M'', p_ins, I'' * p_cont)               mul, fma: 3
    D = fma(M''', p_del, D''' * p_cont)             mul, fma: 3

that is 11 flops (8 instructions, a fused multiply-add counting 2), and
each cell of the last read row adds M + I to the sum, 2 more.  The
rescale test every 64 diagonals is left out (under 1%).  Bytes: the read
codes and qualities (r each), the haplotype (h), the two lengths and the
float32 result, 12, and the 1 KB phred table once a launch.  (The
port's ``chip_smoke.py`` counts the same 11; its ``bench.py`` counts 15,
adding the select of the prior and the masks, which are no arithmetic.)
"""
from __future__ import annotations

import numpy as np

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# K4's instance in the device trace: ``pairhmm_kernel<NR, false, ...>``,
# the scalar-transition one
K4_KERNEL = r"pairhmm_kernel<\s*\d+\s*,\s*(false|0)\b"

PAIRHMM_FLOPS_PER_CELL = 11
PAIRHMM_FLOPS_PER_LAST_ROW_CELL = 2


def pairhmm_work(rlen, hlen) -> tuple[float, float]:
    """(flops, bytes) of one K4 launch over pairs of these lengths."""
    r = np.asarray(rlen, np.float64)
    h = np.asarray(hlen, np.float64)
    flops = (PAIRHMM_FLOPS_PER_CELL * r * h
             + PAIRHMM_FLOPS_PER_LAST_ROW_CELL * h).sum()
    nbytes = (2 * r + h + 12).sum() + 256 * 4
    return float(flops), float(nbytes)


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of the operations
    at their peak and the bytes at HBM's."""
    return max(ops / peak_ops, nbytes / PEAK_HBM_BYTES)
