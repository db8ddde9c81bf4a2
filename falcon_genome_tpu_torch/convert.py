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
  recalibration table as tensors on a given device;
* the reference's time-major example batch of its sharded steps
  (``parallel.sharded.make_example_batch``) as the port's lane-major
  tensors, and a ``jax.sharding.Mesh``'s shape as a ``MeshSpec``;
* host objects of the modules the port keeps its own copies of: a
  ``Config`` (its machine and every value set on it), ``SamRecord``s
  and ``RecordColumns``.

The reference objects are read by attribute only; nothing here imports
the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .aligner import AlignerParams, IndexParams
from .bqsr import RecalTable
from .config import Config, Machine
from .io.columns import RecordColumns
from .io.sam import SamRecord
from .models.activeregion import ActiveRegionParams
from .models.assembly import AssemblyParams
from .models.haplotypecaller import HTCParams
from .ops.pairhmm import PairHMMParams
from .ops.smith_waterman import PairPolicy, SWBucket, device_genome, \
    device_reads
from .ops.sw_ref import SWParams
from .parallel.mesh import MeshSpec

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


def example_batch(ref_batch, device: torch.device
                  ) -> tuple[torch.Tensor, ...]:
    """The reference's sharded-step batch → the port's.

    In: (read (R, B), base_q, ins_q, del_q, gcp (R, B) phreds, rlen
    (1, B), hlen (1, B), hap (H, B), then the flat covariates rg, qual,
    cycle, context, is_error).  Out: read (B, R) uint8, phred planes
    (B, R) uint8, rlen/hlen (B,) int32, hap (B, H) uint8, and the
    covariates unchanged, all on ``device``."""
    read, bq, iq, dq, gq, rlen, hlen, hap, *cov = (np.asarray(a)
                                                   for a in ref_batch)
    lanes = [x.T.astype(np.uint8) for x in (read, bq, iq, dq, gq)]
    lanes += [rlen[0].astype(np.int32), hlen[0].astype(np.int32),
              hap.T.astype(np.uint8)]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (*lanes, *cov))


def mesh_spec(ref_mesh) -> MeshSpec:
    """The (data, region) shape of a reference mesh."""
    return MeshSpec(data=int(ref_mesh.shape["data"]),
                    region=int(ref_mesh.shape["region"]))


def config(ref) -> Config:
    """A reference ``Config`` as the port's: the same machine, root and
    temp directories, hosts, and every value it holds (from the
    environment and conf files, and set explicitly), as they stand."""
    c = Config(root_dir=ref.root_dir,
               machine=Machine(ref.machine.cpu_num, ref.machine.memory_gb),
               environ={}, load_files=False)
    c._values = dict(ref._values)
    c._explicit = dict(ref._explicit)
    c.temp_dir = ref.temp_dir
    c.host_list = list(ref.host_list)
    return c


def sam_records(refs) -> list[SamRecord]:
    """Reference ``SamRecord``s as the port's, field by field (tags
    decoded)."""
    return [SamRecord(r.qname, r.flag, r.tid, r.pos, r.mapq,
                      list(r.cigar), r.mtid, r.mpos, r.tlen, r.seq, r.qual,
                      dict(r.tags))
            for r in refs]


def record_columns(ref) -> RecordColumns:
    """A reference ``RecordColumns`` as the port's (arrays copied)."""
    return RecordColumns(**{
        f.name: (np.array(getattr(ref, f.name))
                 if isinstance(getattr(ref, f.name), np.ndarray)
                 else getattr(ref, f.name))
        for f in dataclasses.fields(RecordColumns)})
