"""Sharded device steps over a :class:`~.mesh.Mesh` in one process.

Port of ``falcon_genome_tpu/parallel/sharded.py``.  The reference jits
its steps under ``shard_map``; here each step is a plain function that
runs one piece per mesh device and combines the pieces explicitly:

* a PairHMM batch runs whole on one of the mesh's devices, the inputs'
  own where the mesh holds it (``mesh.call_device``: split over four
  cards, a batch of up to 8192 pairs lost to one card), with kernel K5
  (:func:`..ops.pairhmm.pairhmm_pb`), or K4
  (:func:`..ops.pairhmm.pairhmm_sc`) for scalar transitions, and its
  per-pair results come back to the inputs' device;
* a ``psum`` of histograms is the sum of the per-device tables;
* the sample-sort's ``all_gather`` of samples is a gather, and its
  ``all_to_all`` is one copy per (source, destination) bucket.

The steps take the port's lane-major batch (see :func:`make_example_batch`;
``convert.example_batch`` turns the reference's time-major one into it).
Histogram tables are float64 (integer counts and 0/1 error sums, exact).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bqsr import MAX_CYCLE, MAX_QUAL, N_CONTEXT
from ..ops.pairhmm import pairhmm_pb, pairhmm_sc
from .mesh import Mesh, call_device, lane_splits


def _pairhmm_shards(mesh: Mesh, read, base_q, ins_q, del_q, gcp, rlen,
                    hlen, hap, scalar_trans=None) -> torch.Tensor:
    """K5 (K4 with ``scalar_trans``) on every lane in one launch, on the
    mesh device :func:`~.mesh.call_device` gives the batch; (B,) on the
    inputs' device."""
    dev = call_device(mesh.flat, home=read.device)
    if scalar_trans is not None:
        args = [read, base_q, rlen, hap, hlen]
    else:
        args = [read, base_q, ins_q, del_q, gcp, rlen, hap, hlen]
    args = [t.to(dev, non_blocking=True) for t in args]
    if scalar_trans is not None:
        out = pairhmm_sc(*args, *scalar_trans)
    else:
        out = pairhmm_pb(*args)
    return out.to(read.device)


def sharded_pairhmm_step(mesh: Mesh, R: int, H: int,
                         scalar_trans: tuple[int, int, int] | None = None):
    """The production kernel K5 on the batch, on one device of the fused
    (data, region) mesh (the reference splits the lanes over it).  With
    ``scalar_trans`` = (ins, del, gcp) phreds, the scalar-transition
    kernel K4 instead, and the step's ins_q/del_q/gcp planes are not
    read (the reference's
    ``_pairhmm_sharded(..., scalar_trans=...)``).

    The step takes (read, base_q, ins_q, del_q, gcp, rlen, hlen, hap):
    (B, R) uint8 codes and phred planes, (B,) int32 lengths, (B, H) uint8
    haplotypes, all on one device; it returns (B,) float32 log10 on that
    device."""
    def step(read, base_q, ins_q, del_q, gcp, rlen, hlen, hap):
        _check_bucket(read, hap, R, H)
        return _pairhmm_shards(mesh, read, base_q, ins_q, del_q, gcp, rlen,
                               hlen, hap, scalar_trans)
    return step


def _check_bucket(read, hap, R: int, H: int) -> None:
    if read.shape[1] != R or hap.shape[1] != H:
        raise ValueError(f"batch ({read.shape[1]}, {hap.shape[1]}) is not "
                         f"the step's bucket ({R}, {H})")


def _histogram(flat: torch.Tensor, weight: torch.Tensor, size: int
               ) -> torch.Tensor:
    out = torch.zeros(size, dtype=torch.float64, device=flat.device)
    return out.index_add_(0, flat, weight)


def _histogram_local(rg, qual, cycle, context, is_error, nrg):
    """Covariate histograms of one device's slice: (obs, err) at cycle
    level and at context level."""
    rg, qual, cycle, context = (t.to(torch.int64)
                                for t in (rg, qual, cycle, context))
    w = torch.ones(len(rg), dtype=torch.float64, device=rg.device)
    we = is_error.to(torch.float64)
    flat = (rg * MAX_QUAL + qual) * MAX_CYCLE + cycle
    ctx_flat = (rg * MAX_QUAL + qual) * N_CONTEXT + context
    n_cyc = nrg * MAX_QUAL * MAX_CYCLE
    n_ctx = nrg * MAX_QUAL * N_CONTEXT
    return (_histogram(flat, w, n_cyc).reshape(nrg, MAX_QUAL, MAX_CYCLE),
            _histogram(flat, we, n_cyc).reshape(nrg, MAX_QUAL, MAX_CYCLE),
            _histogram(ctx_flat, w, n_ctx).reshape(nrg, MAX_QUAL, N_CONTEXT),
            _histogram(ctx_flat, we, n_ctx).reshape(nrg, MAX_QUAL,
                                                    N_CONTEXT))


def _psum(tables: list[tuple[torch.Tensor, ...]], device: torch.device
          ) -> tuple[torch.Tensor, ...]:
    """Sum of the per-device tables, on ``device``."""
    out = None
    for tabs in tables:
        tabs = tuple(t.to(device) for t in tabs)
        out = tabs if out is None else tuple(a + b for a, b in zip(out,
                                                                    tabs))
    return out


def sharded_bqsr_histogram(mesh: Mesh, nrg: int = 1):
    """BQSR covariate histogram split over the mesh, summed to one table.

    The step takes flat covariate tensors (rg, qual, cycle, context,
    is_error) on one device, one entry per base (the reference's padding
    weight has no counterpart: nothing is padded here), and returns
    (obs, err) cycle tables (nrg, MAX_QUAL, MAX_CYCLE) and (ctx_obs,
    ctx_err) context tables (nrg, MAX_QUAL, N_CONTEXT), float64 on that
    device."""
    def step(rg, qual, cycle, context, is_error):
        parts = []
        for dev, (s, e) in zip(mesh.flat, lane_splits(len(rg), mesh.size)):
            parts.append(_histogram_local(
                *(t[s:e].to(dev, non_blocking=True)
                  for t in (rg, qual, cycle, context, is_error)),
                nrg))
        return _psum(parts, rg.device)
    return step


def germline_train_step(mesh: Mesh, R: int, H: int, nrg: int = 1):
    """The full multi-device step of the germline pipeline: sharded K5
    likelihoods plus the summed BQSR cycle histogram.

    Takes the 8 PairHMM tensors of :func:`sharded_pairhmm_step` and the
    flat covariates (rg, qual, cycle, context, is_error); returns
    ((B,) log10, (nrg, MAX_QUAL, MAX_CYCLE) observation counts)."""
    pairhmm = sharded_pairhmm_step(mesh, R, H)
    histogram = sharded_bqsr_histogram(mesh, nrg)

    def step(read, base_q, ins_q, del_q, gcp, rlen, hlen, hap,
             rg, qual, cycle, context, is_error):
        logp = pairhmm(read, base_q, ins_q, del_q, gcp, rlen, hlen, hap)
        return logp, histogram(rg, qual, cycle, context, is_error)[0]
    return step


def make_example_batch(B: int, R: int, H: int, n_cov: int, seed: int = 0):
    """Example inputs for the sharded steps, lane-major CPU tensors: the
    reference's ``make_example_batch`` draws (same seed, same values),
    transposed."""
    rng = np.random.default_rng(seed)
    read = rng.integers(0, 4, (R, B)).astype(np.int32)
    hap = rng.integers(0, 4, (H, B)).astype(np.int32)
    q = np.full((B, R), 30, np.uint8)
    gcp = np.full((B, R), 10, np.uint8)
    cov_q = rng.integers(0, MAX_QUAL, n_cov).astype(np.int32)
    cov_cyc = rng.integers(0, MAX_CYCLE, n_cov).astype(np.int32)
    cov_ctx = rng.integers(0, N_CONTEXT, n_cov).astype(np.int32)
    cov_err = (rng.random(n_cov).astype(np.float32) < 0.01).astype(
        np.float32)
    arrays = (read.T.astype(np.uint8), q, q, q, gcp,
              np.full(B, R, np.int32), np.full(B, H, np.int32),
              hap.T.astype(np.uint8), np.zeros(n_cov, np.int32), cov_q,
              cov_cyc, cov_ctx, cov_err)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ---------------------------------------------------------------------------
# distributed sample-sort (the reference's bucket-BAM sort/merge tree over
# the mesh's data axis)
# ---------------------------------------------------------------------------

# Padding value: sorts after (or ties with) every legitimate key, so the
# first n entries of the merged runs are exactly the sorted input even
# when legitimate keys equal it.  Validity is tracked by count.
SORT_PAD = np.uint64(0xFFFFFFFFFFFFFFFF)
_SIGN = np.uint64(1 << 63)
OVERSAMPLE = 8                       # samples per device


def _to_signed(keys: np.ndarray) -> np.ndarray:
    """uint64 → int64 with the top bit flipped: signed order equals the
    unsigned order (torch sorts int64; its uint64 support is partial)."""
    return (keys ^ _SIGN).view(np.int64)


def _to_unsigned(keys: np.ndarray) -> np.ndarray:
    return keys.view(np.uint64) ^ _SIGN


def distributed_sort(mesh: Mesh, keys: np.ndarray,
                     axis_name: str = "data") -> np.ndarray:
    """Globally sort uint64 keys with a sample-sort over one mesh axis.

    Pads to a multiple of the axis size with :data:`SORT_PAD`; each device
    sorts its run, regular samples are gathered and sorted into global
    splitters, every device sends bucket j of its run to device j (one
    copy per bucket, so no exchange capacity is needed), and each device
    sorts what it received.  The runs in device order, cut to the input's
    length, are the sorted input."""
    devices = mesh.axis_devices(axis_name)
    nd = len(devices)
    n = len(keys)
    n_local = max(1, -(-n // nd))
    padded = np.full(nd * n_local, SORT_PAD, np.uint64)
    padded[:n] = keys
    signed = torch.from_numpy(_to_signed(padded))
    runs = [torch.sort(signed[i * n_local:(i + 1) * n_local].to(dev))[0]
            for i, dev in enumerate(devices)]
    idxs = torch.from_numpy(np.linspace(0, n_local - 1, nd * OVERSAMPLE)
                            .astype(np.int64))
    samples = torch.sort(torch.cat([r[idxs.to(r.device)].cpu()
                                    for r in runs]))[0]
    splits = samples[torch.arange(1, nd) * (nd * OVERSAMPLE)]
    recv: list[list[torch.Tensor]] = [[] for _ in devices]
    for run in runs:
        cuts = torch.searchsorted(run, splits.to(run.device)).tolist()
        for j, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, n_local])):
            recv[j].append(run[lo:hi].to(devices[j], non_blocking=True))
    merged = [torch.sort(torch.cat(parts))[0].cpu() for parts in recv]
    out = torch.cat(merged).numpy()
    # host pads are SORT_PAD (the max value): they occupy the global tail
    return _to_unsigned(out[:n].copy())


def mesh_coordinate_order(tid: np.ndarray, pos: np.ndarray, mesh: Mesh,
                          axis_name: str = "data") -> np.ndarray | None:
    """Coordinate argsort over the mesh.  Packs ``tid:8 | pos:32 | row:24``
    into uint64 keys and sample-sorts them; the low 24 bits come back as
    the permutation.  None when the inputs don't fit the packing (>= 2^24
    rows or a tid >= 0xFF; the caller then sorts on the host).  Stable:
    the row index breaks ties in input order, as ``np.lexsort`` does."""
    n = len(pos)
    if n == 0:
        return np.zeros(0, np.int64)
    if n >= (1 << 24) or int(tid.max(initial=0)) >= 0xFF:
        return None
    keys = ((tid.astype(np.uint64) << np.uint64(56))
            | (pos.astype(np.uint64) << np.uint64(24))
            | np.arange(n, dtype=np.uint64))
    out = distributed_sort(mesh, keys, axis_name)
    return (out & np.uint64(0xFFFFFF)).astype(np.int64)
