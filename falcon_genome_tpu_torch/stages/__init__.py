"""Pipeline stages of the port: every command of the reference (``gatk``
is the CLI's translation onto these).

Each ``run_<cmd>`` mirrors the reference's stage driver of the same name
in ``falcon_genome_tpu/stages`` (same inputs, outputs and artifact
naming); the ones that launch kernels (align, htc, mutect2, indel,
germline) take a ``device``, the card unless the caller names another.
"""
from .align import run_align
from .bamstages import run_markdup
from .bqsr import run_baserecal, run_bqsr, run_printreads
from .calling import run_htc, run_mutect2, run_ug
from .depth import run_depth
from .vcfstages import run_concat, run_joint, run_vcf_filter
from .germline import run_germline
from .indel import run_indel

__all__ = [
    "run_align", "run_markdup",
    "run_baserecal", "run_printreads", "run_bqsr",
    "run_htc", "run_mutect2", "run_ug", "run_depth",
    "run_concat", "run_joint", "run_vcf_filter",
    "run_germline", "run_indel",
]
