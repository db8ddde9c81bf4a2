"""Device ops: Smith-Waterman and PairHMM, each a hand-written CUDA kernel
(``csrc/``) with its plain PyTorch version beside it, and a NumPy
float64/int64 golden model of each (``*_ref.py``) that defines numerical
ground truth for tests and the card's smoke run."""
from .pairhmm import PairHMMParams, pairhmm_logp
from .pairhmm_ref import pairhmm_logp_ref

__all__ = ["pairhmm_logp", "PairHMMParams", "pairhmm_logp_ref"]
