"""Carry the reference's state over to the port.

The system has no model weights; its state is parameter dataclasses and
the arrays the device holds.  These functions turn instances of the
reference's (``falcon_genome_tpu``) classes into the port's, so that both
packages compute from identical state:

* parameter dataclasses (``SWParams``, ``SWBucket``, ``PairPolicy``,
  ``PairHMMParams``, ``AlignerParams``, ``HTCParams``) field by field,
  nested ones included; a reference ``backend`` field becomes the given
  ``torch.device``;
* the genome (int8 codes), padded read tables and the BQSR
  recalibration table as tensors on a given device.

The reference objects are read by attribute only; nothing here imports
the reference's JAX modules.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .aligner import AlignerParams, IndexParams
from .bqsr import RecalTable
from .models.activeregion import ActiveRegionParams
from .models.assembly import AssemblyParams
from .models.haplotypecaller import HTCParams
from .ops.pairhmm import PairHMMParams
from .ops.smith_waterman import PairPolicy, SWBucket, device_genome, \
    device_reads
from .ops.sw_ref import SWParams

# port class of each nested dataclass field, by field name
_NESTED = {"index": IndexParams, "sw": SWParams, "active": ActiveRegionParams,
           "assembly": AssemblyParams}


def _convert(ref, cls, device: torch.device | None = None):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "device":
            kw["device"] = device
        elif f.name in _NESTED:
            kw[f.name] = _convert(getattr(ref, f.name), _NESTED[f.name])
        else:
            kw[f.name] = getattr(ref, f.name)
    return cls(**kw)


def sw_params(ref) -> SWParams:
    return _convert(ref, SWParams)


def sw_bucket(ref, device: torch.device) -> SWBucket:
    return _convert(ref, SWBucket, device)


def pair_policy(ref) -> PairPolicy:
    return _convert(ref, PairPolicy)


def pairhmm_params(ref, device: torch.device) -> PairHMMParams:
    return _convert(ref, PairHMMParams, device)


def aligner_params(ref) -> AlignerParams:
    return _convert(ref, AlignerParams)


def htc_params(ref, device: torch.device) -> HTCParams:
    """The reference's unused ``pairhmm`` field has no counterpart; the
    HaplotypeCaller's PairHMM bucket is sized per batch."""
    return _convert(ref, HTCParams, device)


def genome_tensor(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """Genome codes (uint8 0-4) → int8 tensor on ``device``."""
    return device_genome(codes, device)


def read_table(reads: np.ndarray, device: torch.device) -> torch.Tensor:
    """Padded (N, R) read codes → int8 tensor on ``device``."""
    return device_reads(reads, device)


def recal_table(ref) -> RecalTable:
    """A reference RecalTable as the port's (same arrays, copied)."""
    return RecalTable(list(ref.read_groups),
                      *(np.array(getattr(ref, f)) for f in (
                          "qual_obs", "qual_err", "cycle_obs", "cycle_err",
                          "ctx_obs", "ctx_err")))


def recal_tensors(table, device: torch.device) -> dict[str, torch.Tensor]:
    """The recalibration histograms as float64 tensors on ``device``."""
    return {f: torch.from_numpy(np.asarray(getattr(table, f),
                                           np.float64)).to(device)
            for f in ("qual_obs", "qual_err", "cycle_obs", "cycle_err",
                      "ctx_obs", "ctx_err")}
