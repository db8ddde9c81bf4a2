"""NumPy float64 golden model of the PairHMM forward likelihood.

Semantics follow GATK's LoglessPairHMM (the model the reference accelerates
through the Blaze NAM FPGA service behind HaplotypeCaller — SURVEY.md §2
row 25, src/workers/BlazeWorker.cpp):

* states M/I/D with read-position-indexed transitions derived from the
  per-base insertion/deletion gap-open qualities and the gap-continuation
  penalty;
* emission prior: ``1 - err`` on base match (or either base N), ``err/3``
  on mismatch;
* free start anywhere in the haplotype: row 0 of D carries
  ``INITIAL_CONDITION / hap_len``;
* result: ``log10(sum_j M[R][j] + I[R][j]) - log10(INITIAL_CONDITION)``.

Copied from ``falcon_genome_tpu/ops/pairhmm_ref.py``.  This is the
correctness oracle for the CUDA kernels; float64 with a huge initial
condition never underflows at read scale.
"""
from __future__ import annotations

import numpy as np

BASE_N = 4
LOG10_INITIAL = 300.0  # 10^300 initial condition: far from f64 limits


def _phred_to_prob(q: np.ndarray) -> np.ndarray:
    return np.power(10.0, -q.astype(np.float64) / 10.0)


def pairhmm_logp_single(read_codes: np.ndarray, base_q: np.ndarray,
                        ins_q: np.ndarray, del_q: np.ndarray,
                        gcp: np.ndarray, hap_codes: np.ndarray) -> float:
    """log10 P(read | haplotype) for one pair (unpadded 1-D arrays)."""
    R = len(read_codes)
    H = len(hap_codes)
    ic = 10.0 ** LOG10_INITIAL

    p_err = _phred_to_prob(base_q)
    p_ins = _phred_to_prob(ins_q)
    p_del = _phred_to_prob(del_q)
    p_cont = _phred_to_prob(gcp)

    a_mm = 1.0 - np.minimum(1.0, p_ins + p_del)   # matchToMatch
    a_mi = p_ins                                   # matchToInsertion
    a_md = p_del                                   # matchToDeletion
    a_im = 1.0 - p_cont                            # indelToMatch
    a_ii = p_cont                                  # ins/del continuation

    M = np.zeros((R + 1, H + 1))
    I = np.zeros((R + 1, H + 1))
    D = np.zeros((R + 1, H + 1))
    D[0, :] = ic / H  # free start across the haplotype

    for i in range(1, R + 1):
        rb = read_codes[i - 1]
        err = p_err[i - 1]
        for j in range(1, H + 1):
            hb = hap_codes[j - 1]
            match = (rb == hb) or rb == BASE_N or hb == BASE_N
            prior = (1.0 - err) if match else (err / 3.0)
            M[i, j] = prior * (M[i - 1, j - 1] * a_mm[i - 1]
                               + I[i - 1, j - 1] * a_im[i - 1]
                               + D[i - 1, j - 1] * a_im[i - 1])
            I[i, j] = M[i - 1, j] * a_mi[i - 1] + I[i - 1, j] * a_ii[i - 1]
            D[i, j] = M[i, j - 1] * a_md[i - 1] + D[i, j - 1] * a_ii[i - 1]

    total = M[R, 1:].sum() + I[R, 1:].sum()
    if total <= 0.0:
        return float("-inf")
    return float(np.log10(total) - LOG10_INITIAL)


def pairhmm_logp_ref(read_codes: np.ndarray, base_q: np.ndarray,
                     ins_q: np.ndarray, del_q: np.ndarray, gcp: np.ndarray,
                     read_lens: np.ndarray, hap_codes: np.ndarray,
                     hap_lens: np.ndarray) -> np.ndarray:
    """Batched golden model over padded (B, R) reads × (B, H) haplotypes."""
    B = read_codes.shape[0]
    out = np.zeros(B)
    for b in range(B):
        rl, hl = int(read_lens[b]), int(hap_lens[b])
        out[b] = pairhmm_logp_single(
            read_codes[b, :rl], base_q[b, :rl], ins_q[b, :rl],
            del_q[b, :rl], gcp[b, :rl], hap_codes[b, :hl])
    return out
