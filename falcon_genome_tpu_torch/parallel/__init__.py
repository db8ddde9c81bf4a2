"""Process topology and host sort for the single-process port.

The reference's ``parallel`` package builds a ``jax.sharding.Mesh`` and
runs multi-process scatter under ``jax.distributed``.  The port runs one
process on one device; ``torch.distributed`` is later work.  The stage
code keeps the reference's calls (``is_primary``/``sync_processes``) so
that the multi-process port slots in here.
"""
from __future__ import annotations

import numpy as np

from falcon_genome_tpu.io.columns import F_FLAG, F_POS, F_TID
from falcon_genome_tpu.io.sam import FLAG_UNMAPPED


def process_info() -> tuple[int, int]:
    """(process_index, process_count): always (0, 1) here."""
    return 0, 1


def is_primary() -> bool:
    """True on the process that performs final gathers/merges."""
    return process_info()[0] == 0


def sync_processes(tag: str) -> None:
    """Cross-process barrier: a no-op with one process."""
    del tag


def coordinate_order(cols) -> np.ndarray:
    """Permutation for coordinate sort of RecordColumns: (tid, pos),
    unmapped last — the host lexsort of
    ``falcon_genome_tpu.io.columns.RecordColumns.coordinate_order``
    without its mesh branch."""
    unmapped = (cols.fixed[:, F_FLAG] & FLAG_UNMAPPED) != 0
    tid = np.where(unmapped, np.int64(1) << 30,
                   cols.fixed[:, F_TID].astype(np.int64))
    return np.lexsort((cols.fixed[:, F_POS], tid))
