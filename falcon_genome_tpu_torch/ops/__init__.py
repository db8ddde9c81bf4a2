"""Device ops: Smith-Waterman and PairHMM, each a hand-written CUDA kernel
(``csrc/``) with its plain PyTorch version beside it."""
