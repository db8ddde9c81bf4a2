"""Device mesh and process topology on ``torch.distributed``.

Port of ``falcon_genome_tpu/parallel/mesh.py``.  The reference's host
topology maps to a 2-axis logical mesh:

* ``data``   — read-batch data parallelism;
* ``region`` — genome-region parallelism.

Here a :class:`Mesh` is a (data, region) grid of ``torch.device``s in one
process.  A mesh built explicitly may repeat a device (8 shards over the
CPU in the tests, 4 shards over one card in the smoke run); the compute
that shards over it (``bqsr.accumulate_table``,
``parallel.coordinate_order``, ``parallel.sharded``) runs one piece per
grid cell and combines the pieces as the reference's collectives do,
while a PairHMM call (``ops.pairhmm``, the sharded PairHMM step) runs
whole on one of the mesh's devices (:func:`call_device`).

Several processes (``tpu.dist.*``) join one ``gloo`` process group, at a
coordinator given as ``host:port`` or, for processes of one host, as
``file://<path>``: process 0 then binds a free port itself and hands its
number to the others in that file (:func:`distributed_initialize`).  The
reference's cross-process mode needs only barriers and the shared file
system: the runner splits a stage's tasks over the processes and every
task runs under ``use_mesh(None)``.  Each process has its own device, so
a process's mesh never spans processes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import logging
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("falcon_genome_tpu")

AXES = ("data", "region")
DIST_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1     # -1: all remaining devices
    region: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        region = max(1, self.region)
        data = self.data if self.data > 0 else n_devices // region
        if data * region != n_devices:
            raise ValueError(
                f"mesh {data}x{region} != device count {n_devices}")
        return data, region


class Mesh:
    """A (data, region) grid of devices; ``flat`` lists them row-major,
    the order in which sharded work splits its lanes."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError("a mesh is a 2-D (data, region) device grid")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list[torch.device]:
        return list(self.devices.flat)

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """One device per index of ``axis_name`` (index 0 of the other
        axis), where a collective over that axis runs."""
        if axis_name == "data":
            return list(self.devices[:, 0])
        if axis_name == "region":
            return list(self.devices[0, :])
        raise ValueError(f"no mesh axis {axis_name!r}")


def lane_splits(n: int, parts: int) -> list[tuple[int, int]]:
    """``parts`` contiguous, near-even [start, end) ranges of ``n`` lanes:
    how sharded work splits over ``Mesh.flat``."""
    b = np.linspace(0, n, parts + 1).astype(int)
    return list(zip(b[:-1].tolist(), b[1:].tolist()))


# A PairHMM call runs whole on one card of the mesh.  Split over four
# cards, a call lost to one card at every size a caller makes: a piece on
# another card than the inputs' cost 0.17-0.27 ms of host dispatch
# (ordering, copies in, launch, copies back) against ~0.1 ms of kernel a
# wave at HaplotypeCaller's bucket, 160 x 384 (2112 pairs of K5, 3168 of
# K4), so the split step took 2.15-2.70x one K5 call at 8192, 7604 and 4656
# pairs (NVIDIA H100 80GB HBM3 x 4, 700 W; benchmarks/mesh_trace.py).  The
# cards earn their keep through calls made from several threads at once.
_turn = itertools.count()   # the order in which threads first take a card


def _thread_turn() -> int:
    """This thread's place in the order of threads that have run a call.
    One thread's calls keep to one card (sent to the cards in turn, one
    caller thread's calls of 8192 pairs read 1.09-1.14x one card's on
    four H100s); calls from several threads spread over the cards."""
    turn = getattr(_state, "turn", None)
    if turn is None:
        turn = _state.turn = next(_turn)
    return turn


def call_device(devices: list[torch.device],
                home: torch.device | None = None) -> torch.device:
    """The device of the mesh ``devices`` (``Mesh.flat``) that a call of
    independent lanes runs on, whole: ``home`` where it is one of them
    (the inputs lie there), else the calling thread's own
    (:func:`_thread_turn`), so calls made from several threads run on
    several devices at once.  Outputs do not depend on the choice."""
    distinct = list(dict.fromkeys(torch.device(d) for d in devices))
    if home is not None and torch.device(home) in distinct:
        return torch.device(home)
    return distinct[_thread_turn() % len(distinct)]


def make_mesh(spec: MeshSpec, devices: list[torch.device]) -> Mesh:
    """The mesh of ``spec`` over ``devices`` (row-major)."""
    data, region = spec.resolve(len(devices))
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(data, region))


def visible_devices(device: torch.device) -> list[torch.device]:
    """The devices a process of ``device``'s type sees: every visible
    ``cuda:i``, or the one CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def process_device(device: torch.device) -> torch.device:
    """This process's device: ``cuda:(process_id % device_count)`` under
    several processes with ``--device cuda``, else ``device``."""
    pid, pcount = process_info()
    if device.type == "cuda" and pcount > 1:
        return torch.device("cuda", pid % torch.cuda.device_count())
    return device


def _file_store(path: Path, world: int, rank: int) -> dist.TCPStore:
    """The rendezvous store of ``file://<path>``: process 0 listens on a
    port of its own choosing on ``localhost`` and writes the number to
    ``path`` (whole, by rename); the others wait for the file and connect.
    ``path`` must name a file that does not exist yet."""
    if rank == 0:
        store = dist.TCPStore("localhost", 0, world, True,
                              timeout=DIST_TIMEOUT, wait_for_workers=False)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(str(store.port))
        os.replace(tmp, path)
        return store
    deadline = time.monotonic() + DIST_TIMEOUT.total_seconds()
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no rendezvous port in {path}")
        time.sleep(0.05)
    return dist.TCPStore("localhost", int(path.read_text()), world, False,
                         timeout=DIST_TIMEOUT)


def distributed_initialize(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join the ``gloo`` process group at ``tcp://<coordinator>``, or,
    for a ``file://<path>`` coordinator, at the port that process 0 binds
    and writes to ``<path>``.

    No-op for a single process.  A failed initialisation raises."""
    if not num_processes or num_processes <= 1:
        return
    if not coordinator:
        raise ValueError("tpu.dist.coordinator (host:port) is required "
                         "with tpu.dist.num_processes > 1")
    world, rank = int(num_processes), int(process_id or 0)
    if coordinator.startswith("file://"):
        store = _file_store(Path(coordinator[len("file://"):]), world, rank)
        dist.init_process_group("gloo", store=store, world_size=world,
                                rank=rank, timeout=DIST_TIMEOUT)
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=world,
        rank=rank, timeout=DIST_TIMEOUT)


# ---------------------------------------------------------------------------
# active mesh: the pipeline-wide device mesh the compute dispatches through
# ---------------------------------------------------------------------------

_state = threading.local()
_GLOBAL_MESH: Mesh | None = None    # set once by the CLI; threads inherit
_UNSET = object()


def set_active_mesh(mesh: Mesh | None) -> None:
    """Install ``mesh`` as the process-wide compute mesh (CLI bring-up)."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_active_mesh() -> Mesh | None:
    """The mesh compute should shard over (None = single device)."""
    mesh = getattr(_state, "mesh", _UNSET)
    return _GLOBAL_MESH if mesh is _UNSET else mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Scoped (thread-local) mesh override, for tests and nested stages;
    ``use_mesh(None)`` forces the single-device path."""
    prev = getattr(_state, "mesh", _UNSET)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        if prev is _UNSET:
            del _state.mesh
        else:
            _state.mesh = prev


def mesh_from_conf(conf, devices: list[torch.device]) -> Mesh | None:
    """Build the configured mesh (``tpu.mesh.data`` × ``tpu.mesh.region``)
    over ``devices``.

    Returns None when the resolved mesh is a single device; raises when
    it needs more devices than there are.  ``tpu.mesh.data = -1`` means
    "all devices not taken by region"."""
    region = max(1, int(conf.get("tpu.mesh.region")))
    data = int(conf.get("tpu.mesh.data"))
    if data <= 0:
        data = max(1, len(devices) // region)
    if data * region <= 1:
        return None
    if data * region > len(devices):
        raise ValueError(
            f"tpu.mesh {data}x{region} exceeds {len(devices)} device(s)")
    return make_mesh(MeshSpec(data=data, region=region),
                     devices[:data * region])


def process_info() -> tuple[int, int]:
    """(process_index, process_count) — (0, 1) when not distributed."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the process that performs final gathers/merges."""
    return process_info()[0] == 0


def sync_processes(tag: str) -> None:
    """Cross-process barrier (no-op single-process)."""
    if process_info()[1] <= 1:
        return
    log.debug("barrier %s", tag)
    dist.barrier()


def initialize_from_conf(conf, device: torch.device) -> Mesh | None:
    """Entry-point bring-up: join the process group (``tpu.dist.*``),
    then install the mesh over this process's devices.

    One process sees every visible device of ``device``'s type; each of
    several processes sees only :func:`process_device`, so its mesh is
    None unless ``tpu.mesh`` asks for more (which raises)."""
    nproc = int(conf.get("tpu.dist.num_processes") or 0)
    if nproc > 1:
        distributed_initialize(
            coordinator=conf.get("tpu.dist.coordinator") or None,
            num_processes=nproc,
            process_id=int(conf.get("tpu.dist.process_id") or 0))
        devices = [process_device(device)]
    else:
        devices = visible_devices(device)
    mesh = mesh_from_conf(conf, devices)
    set_active_mesh(mesh)
    if mesh is not None:
        log.info("device mesh: data=%d region=%d over %d %s device(s)",
                 mesh.shape["data"], mesh.shape["region"], mesh.size,
                 mesh.flat[0].type)
    return mesh


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
