"""Pipeline stages of the ported slice: align → markdup → bqsr → htc.

Each ``run_<cmd>`` mirrors the reference's stage driver of the same name
in ``falcon_genome_tpu/stages`` (same inputs, outputs and artifact
naming); the ones that launch kernels take a ``device``.
"""
from .align import run_align
from .bamstages import run_markdup
from .bqsr import run_baserecal, run_bqsr, run_printreads
from .calling import run_htc
from .germline import run_germline

__all__ = [
    "run_align", "run_markdup",
    "run_baserecal", "run_printreads", "run_bqsr",
    "run_htc", "run_germline",
]
