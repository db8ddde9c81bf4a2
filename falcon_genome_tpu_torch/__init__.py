"""falcon_genome_tpu_torch — the germline pipeline on PyTorch and CUDA.

A port of ``falcon_genome_tpu`` (the JAX/Pallas package beside it, which
stays the reference) to PyTorch with hand-written CUDA kernels for NVIDIA
Hopper (``sm_90a``).  Module names and layout follow the reference, so
``falcon_genome_tpu_torch/ops/pairhmm.py`` is the counterpart of
``falcon_genome_tpu/ops/pairhmm.py``.

What runs where:

* the dynamic-programming inner loops (Smith-Waterman scoring, full
  Smith-Waterman with traceback pointers, the pointer walk, the PairHMM
  forward) are CUDA kernels under ``csrc/``, built with ``nvcc`` at first
  use (``ops/_build.py``); each has a plain PyTorch version beside it,
  which runs for tensors that lie on the CPU;
* seeding, chaining, pairing, duplicate marking, BQSR, assembly and
  genotyping are host code (numpy, plus the reference's ``fgio`` C++
  extension through ``falcon_genome_tpu.io.native_ext``);
* a ``torch.device`` chosen at the entry point (``cli --device``) is
  threaded down to every op; nothing probes for a default backend.

The package imports ``torch`` and never ``jax``.  Of the reference it
imports only its jax-free host modules: ``io``, ``config``, ``utils``,
``samples``, ``bamops`` and ``cli.build_parser``.
"""

__version__ = "0.1.0"
