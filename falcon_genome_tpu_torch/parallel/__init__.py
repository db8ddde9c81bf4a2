"""Multi-device parallelism: device mesh, process topology, sharded steps.

Port of ``falcon_genome_tpu/parallel``.  ``mesh`` builds the (data,
region) device grid and joins several processes into one ``gloo`` group
(``tpu.dist.*``); ``sharded`` runs the PairHMM (kernel K5), the BQSR
histogram and the coordinate sort split over a mesh.  The stage code
calls ``is_primary``/``sync_processes`` around its gathers, and the
runner splits a stage's tasks over the processes.
"""
from __future__ import annotations

import numpy as np

from falcon_genome_tpu.io.columns import F_FLAG, F_POS, F_TID
from falcon_genome_tpu.io.sam import FLAG_UNMAPPED

from .mesh import (
    Mesh, MeshSpec, distributed_initialize, get_active_mesh,
    initialize_from_conf, is_primary, make_mesh, mesh_from_conf,
    process_device, process_info, set_active_mesh, shutdown,
    sync_processes, use_mesh, visible_devices)
from .sharded import (
    distributed_sort, germline_train_step, make_example_batch,
    mesh_coordinate_order, sharded_bqsr_histogram, sharded_pairhmm_step)

__all__ = [
    "Mesh", "MeshSpec", "make_mesh", "mesh_from_conf", "visible_devices",
    "process_device", "set_active_mesh", "get_active_mesh", "use_mesh",
    "distributed_initialize", "initialize_from_conf", "shutdown",
    "process_info", "is_primary", "sync_processes",
    "sharded_pairhmm_step", "sharded_bqsr_histogram", "germline_train_step",
    "make_example_batch", "distributed_sort", "mesh_coordinate_order",
    "coordinate_order",
]


def coordinate_order(cols) -> np.ndarray:
    """Permutation for coordinate sort of RecordColumns: (tid, pos),
    unmapped last — ``falcon_genome_tpu.io.columns.RecordColumns.
    coordinate_order``.  Under an active multi-device mesh with a data
    axis the argsort is the sample-sort of :func:`mesh_coordinate_order`
    (unmapped reads keyed as tid 0xFE, positions clipped to uint32);
    the host lexsort is the single-device path and the fallback when the
    packed keys don't fit (a mapped tid >= 0xFE, >= 2^24 rows)."""
    unmapped = (cols.fixed[:, F_FLAG] & FLAG_UNMAPPED) != 0
    tid = np.where(unmapped, np.int64(1) << 30,
                   cols.fixed[:, F_TID].astype(np.int64))
    mesh = get_active_mesh()
    if (mesh is not None and mesh.size > 1
            and "data" in mesh.axis_names
            and (len(tid) == 0 or int(cols.fixed[:, F_TID].max(
                initial=0, where=~unmapped)) < 0xFE)):
        tid8 = np.where(unmapped, np.int64(0xFE), tid)
        pos = np.clip(cols.fixed[:, F_POS], 0, None).astype(np.uint32)
        order = mesh_coordinate_order(tid8.astype(np.uint64), pos, mesh)
        if order is not None:
            return order
    return np.lexsort((cols.fixed[:, F_POS], tid))
