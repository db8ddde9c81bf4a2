"""The operations and bytes of the per-base PairHMM kernel K5
(``pairhmm_kernel<NR, true, ...>`` of ``csrc/pairhmm.cu``), against the
peaks of ``roofline.py``.

The operations are K4's (``roofline.pairhmm_work``): 11 flops a cell of
the read x haplotype matrix and 2 a last-row cell.  The per-row
transitions (a_mm = 1 - min(1, p_ins + p_del), a_im = 1 - p_cont, once a
read row) are about 0.1% of them and are left out.  Bytes: the read
codes, the base, insertion and deletion phreds (4 a read base), the
haplotype (1 a base), the two lengths and the float32 result (12), and
the 1 KB phred table once a launch.  The gap continuation is one number
for every row, whatever implements it.
"""
from __future__ import annotations

import numpy as np

from roofline import (PAIRHMM_FLOPS_PER_CELL,
                      PAIRHMM_FLOPS_PER_LAST_ROW_CELL)

# K5's instance in the device trace: ``pairhmm_kernel<NR, true, ...>``,
# the per-base one
K5_KERNEL = r"pairhmm_kernel<\s*\d+\s*,\s*(true|1)\b"


def pairhmm_pb_work(rlen, hlen) -> tuple[float, float]:
    """(flops, bytes) of one K5 launch over pairs of these lengths."""
    r = np.asarray(rlen, np.float64)
    h = np.asarray(hlen, np.float64)
    flops = (PAIRHMM_FLOPS_PER_CELL * r * h
             + PAIRHMM_FLOPS_PER_LAST_ROW_CELL * h).sum()
    nbytes = (4 * r + h + 12).sum() + 256 * 4
    return float(flops), float(nbytes)
