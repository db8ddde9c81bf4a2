"""Benchmarks of the port's kernels beyond ``falcon_genome_tpu_torch.bench``."""
