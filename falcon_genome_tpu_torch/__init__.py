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
  genotyping are host code (numpy, plus the ``fgio`` C++ extension of
  ``native/`` through ``io.native_ext``);
* a ``torch.device`` chosen at the entry point (``cli --device``) is
  threaded down to every op; nothing probes for a default backend.

The package imports ``torch`` and never ``jax``, and nothing of
``falcon_genome_tpu``: the host modules it shares with the reference
(``io``, ``config``, ``utils``, ``samples``, ``bamops`` and the CLI's
``build_parser``) are copies under the same relative paths, cut to what
the port reaches.
"""

__version__ = "0.1.0"
