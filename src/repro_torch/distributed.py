"""Multi-process start-up and the serving mesh (counterpart of the
multi-process half of ``repro.utils.compat`` — ``distributed_initialize``,
``is_distributed``, ``process_index``, ``process_count``,
``make_global_mesh``, ``process_allgather`` — and of
``repro.launch.mesh.make_serving_mesh``).

A fleet is ``torch.distributed``: :func:`init_distributed` opens a
``TCPStore`` at the coordinator (rank 0 hosts it) and runs
``init_process_group`` over that store.  The store outlives the group's
rendezvous: the multihost opcode channel (``serve.multihost``) rides it.

Layout.  One process is one rank and drives one device.  Ranks are
grouped into hosts of ``LOCAL_WORLD_SIZE`` ranks (as ``torchrun`` sets
it; default 1): host h holds ranks ``[h * n, (h + 1) * n)``.  A rank's
device is ``cuda:{local rank % device_count}``: the local rank is
``$LOCAL_RANK`` where a launcher set it, else the rank's place among the
ranks whose host name (published through the store) is its own, so the
ranks of a machine with several cards take one card each.  The JAX
package's (host, model) mesh becomes :class:`ServingMesh`: the host axis
is the hosts, the model axis the ranks of a host (times the shards a
rank holds), and vocab shards are host-contiguous, as the hierarchical
merge assumes.
Its intra-host and cross-host process groups come from ``new_group``.
The JAX mesh's axis names have no counterpart: torch has no named mesh
axes, and the groups are what a collective is given.

Training (:func:`make_training_mesh`, beside the serving mesh): a
``DeviceMesh`` of named dims (``data``, ``model``) over every rank of the
fleet, row-major as ``jax.make_mesh`` lays devices out, with its data and
model process groups; it reuses the group :func:`init_distributed`
started and its backend.

Backend.  NCCL where no two ranks of the fleet drive the same device
(each rank publishes its device's UUID through the store before the
group starts); gloo where ranks share a device — NCCL refuses two ranks
on one GPU — and on the CPU.  The choice is made from what the ranks
publish, before any collective: it is stated (``ServingMesh.backend``,
the serve launcher's ``multihost:`` line), not a retry after a failure.
On gloo the serving merge runs on host copies of the candidates.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["DIST_COORDINATOR_ENV", "DIST_NUM_PROCESSES_ENV",
           "DIST_PROCESS_ID_ENV", "ServingMesh", "TrainingMesh",
           "init_distributed", "is_distributed", "process_index",
           "process_count", "distributed_store", "make_serving_mesh",
           "make_training_mesh", "process_allgather",
           "shutdown_distributed"]

DIST_COORDINATOR_ENV = "REPRO_DIST_COORDINATOR"
DIST_NUM_PROCESSES_ENV = "REPRO_DIST_NUM_PROCESSES"
DIST_PROCESS_ID_ENV = "REPRO_DIST_PROCESS_ID"

#: how long start-up, a collective or the exit handshake may wait
TIMEOUT_S = 600.0
_KEY = "repro/dist"


@dataclasses.dataclass
class _State:
    store: Any
    backend: str
    device: torch.device
    ranks_per_host: int
    mesh: "ServingMesh | None" = None


_state: _State | None = None
_state_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """The (host, model) layout of the ranks serving one vocab-sharded
    head, and this rank's place in it.

    ``n_shards = n_hosts * ranks_per_host * shards_per_rank``: rank r
    holds shards ``[r * shards_per_rank, (r + 1) * shards_per_rank)``.  A
    mesh with no process group (``group is None``) is one process holding
    every shard (the in-process form; no collective runs).  ``group``
    spans every rank (the flat merge, the sample-size sum), ``host_group``
    this rank's host (the model axis), ``cross_group`` the ranks of the
    same local rank on every host (the host axis).  ``lock`` serialises
    one process's collectives, which every rank must issue in the same
    order."""

    n_hosts: int = 1
    ranks_per_host: int = 1
    shards_per_rank: int = 1
    rank: int = 0
    device: torch.device | None = None
    backend: str | None = None
    group: Any = None
    host_group: Any = None
    cross_group: Any = None
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @classmethod
    def local(cls, n_shards: int = 1, device=None) -> "ServingMesh":
        """One process holding all ``n_shards`` shards, no group."""
        return cls(shards_per_rank=n_shards,
                   device=None if device is None else torch.device(device))

    @property
    def world(self) -> int:
        return self.n_hosts * self.ranks_per_host

    @property
    def n_shards(self) -> int:
        return self.world * self.shards_per_rank

    @property
    def host_collectives(self) -> bool:
        """True where the merge's collectives take host tensors (gloo)."""
        return self.backend == "gloo"

    def shard_range(self) -> tuple[int, int]:
        """[lo, hi) shard ids this rank holds (host-contiguous)."""
        lo = self.rank * self.shards_per_rank
        return lo, lo + self.shards_per_rank

    def row_range(self, m: int) -> tuple[int, int]:
        """Global weight rows [r0, r1) this rank's shards cover for a
        vocabulary of ``m`` — the only rows it needs to hold."""
        lo, hi = self.shard_range()
        m_local = -(-m // self.n_shards)
        return min(lo * m_local, m), min(hi * m_local, m)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _exchange(store, what: str, rank: int, world: int, value: str,
              timeout: datetime.timedelta) -> list[str]:
    """Every rank's ``value`` of ``what``, in rank order, exchanged
    through the store before the group starts."""
    store.set(f"{_KEY}/{what}/{rank}", value)
    keys = [f"{_KEY}/{what}/{r}" for r in range(world)]
    store.wait(keys, timeout)
    return [store.get(k).decode() for k in keys]


def _local_rank(store, rank: int, world: int,
                timeout: datetime.timedelta, host: str | None = None) -> int:
    """This rank's place on its machine: ``$LOCAL_RANK`` where a launcher
    set it, else the number of lower ranks whose host name is this
    rank's.  Every rank publishes its name either way, so a fleet whose
    launcher set the variable on some ranks only cannot wedge here."""
    names = _exchange(store, "host", rank, world,
                      host or socket.gethostname(), timeout)
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else \
        names[:rank].count(names[rank])


def _backend(device_type: str, idents: list[str]) -> str:
    """NCCL where every rank drives a card of its own (the cards' UUIDs
    all differ), gloo where two ranks share one or on the CPU."""
    return ("nccl" if device_type == "cuda"
            and len(set(idents)) == len(idents) else "gloo")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: str | torch.device | None = None,
                     store=None, timeout_s: float = TIMEOUT_S) -> bool:
    """Start this process's rank of a fleet (idempotent).

    The arguments default to ``$REPRO_DIST_COORDINATOR`` (``host:port``),
    ``$REPRO_DIST_NUM_PROCESSES`` (1) and ``$REPRO_DIST_PROCESS_ID`` (0).
    Rank 0 hosts a ``TCPStore`` at the coordinator and every rank joins
    it; ``store`` passes a store instead (a ``FileStore``, where no port
    is to be claimed).  ``device`` is the fleet's device type (``cuda``
    by default; ``cpu``); a CUDA rank drives ``cuda:{local rank %
    device_count}`` (:func:`_local_rank`).  Returns True when a group is (now) up, False when
    there is nothing to join (no coordinator and no store).  A world of
    one is a group too (the one-card NCCL check runs on one);
    ``serve.multihost.init_multihost`` asks for more than one.
    """
    global _state
    with _state_lock:
        if _state is not None:
            return True
        if coordinator is None:
            coordinator = os.environ.get(DIST_COORDINATOR_ENV)
        if num_processes is None:
            num_processes = _env_int(DIST_NUM_PROCESSES_ENV, 1)
        if process_id is None:
            process_id = _env_int(DIST_PROCESS_ID_ENV, 0)
        if coordinator is None and store is None:
            return False
        world, rank = int(num_processes), int(process_id)
        if not 0 <= rank < world:
            raise ValueError(f"process id {rank} outside a fleet of {world}")
        per_host = _env_int("LOCAL_WORLD_SIZE", 1)
        if per_host < 1 or world % per_host:
            raise ValueError(f"LOCAL_WORLD_SIZE={per_host} does not divide "
                             f"the {world} processes into hosts")
        dev = resolve_device(device)
        timeout = datetime.timedelta(seconds=timeout_s)
        if store is None:
            host, port = coordinator.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), world,
                                  is_master=rank == 0, timeout=timeout)
        local_rank = _local_rank(store, rank, world, timeout)
        ident = "cpu"
        if dev.type == "cuda":
            dev = torch.device("cuda",
                               local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            ident = str(torch.cuda.get_device_properties(dev).uuid)
        backend = _backend(dev.type, _exchange(store, "device", rank, world,
                                               ident, timeout))
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
        _state = _State(store, backend, dev, per_host)
        return True


def is_distributed() -> bool:
    """True iff :func:`init_distributed` started a group."""
    return _state is not None


def process_index() -> int:
    return dist.get_rank() if _state is not None else 0


def process_count() -> int:
    return dist.get_world_size() if _state is not None else 1


def distributed_store():
    """The store the group started over (the opcode channel's)."""
    if _state is None:
        raise RuntimeError("no fleet: call init_distributed first")
    return _state.store


@dataclasses.dataclass(frozen=True)
class TrainingMesh:
    """A training mesh over the fleet: ``mesh`` (a ``DeviceMesh`` whose
    dims are named by ``axes``), this rank's ``device``, the fleet's
    ``backend``, and the process group of each axis (``groups["data"]``,
    ``groups["model"]``: the ranks that share this rank's place on every
    other axis)."""

    mesh: Any
    device: torch.device
    backend: str
    groups: dict


def make_training_mesh(shape: tuple[int, ...],
                       axes: tuple[str, ...] = ("data", "model")
                       ) -> TrainingMesh:
    """A ``DeviceMesh`` of ``shape`` over every rank of the fleet that
    :func:`init_distributed` started (their product must be its size),
    ranks laid out row-major: rank ``r`` of a ``(D, M)`` mesh is data
    shard ``r // M``, model shard ``r % M``.  Every rank must call it, in
    the same order as its other group-making calls."""
    from torch.distributed.device_mesh import DeviceMesh

    if _state is None:
        raise RuntimeError("no fleet: call init_distributed first")
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    world = dist.get_world_size()
    if len(shape) != len(axes) or int(np.prod(shape)) != world:
        raise ValueError(f"a {shape} mesh over axes {axes} needs "
                         f"{int(np.prod(shape))} ranks; the fleet has "
                         f"{world}")
    with _state_lock:
        mesh = DeviceMesh(_state.device.type,
                          torch.arange(world).reshape(shape),
                          mesh_dim_names=axes)
        return TrainingMesh(mesh, _state.device, _state.backend,
                            {a: mesh.get_group(a) for a in axes})


def make_serving_mesh() -> ServingMesh:
    """The serving mesh over every rank of the fleet (also the
    counterpart of ``compat.make_global_mesh``): hosts of
    ``LOCAL_WORLD_SIZE`` ranks, one shard a rank.  Without a fleet, one
    process with one shard on the default device.  The groups are made
    once (every rank makes them in the same order) and reused."""
    if _state is None:
        return ServingMesh.local(1)
    with _state_lock:
        if _state.mesh is None:
            world, per_host = dist.get_world_size(), _state.ranks_per_host
            rank = dist.get_rank()
            n_hosts = world // per_host
            host_group = cross_group = None
            for h in range(n_hosts):
                g = dist.new_group(list(range(h * per_host,
                                              (h + 1) * per_host)))
                if h == rank // per_host:
                    host_group = g
            for r in range(per_host):
                g = dist.new_group(list(range(r, world, per_host)))
                if r == rank % per_host:
                    cross_group = g
            _state.mesh = ServingMesh(
                n_hosts=n_hosts, ranks_per_host=per_host, rank=rank,
                device=_state.device, backend=_state.backend,
                group=dist.group.WORLD, host_group=host_group,
                cross_group=cross_group)
        return _state.mesh


def process_allgather(x) -> np.ndarray:
    """Each rank's array stacked along a new leading axis (``[1, ...]``
    without a fleet)."""
    x = np.asarray(x)
    if _state is None:
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x))
    if _state.backend == "nccl":
        t = t.to(_state.device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def shutdown_distributed(timeout_s: float = TIMEOUT_S) -> None:
    """Leave the fleet.  Rank 0 hosts the store, so it waits (up to
    ``timeout_s``) until every rank has said it is done with the store
    before the group and the store go."""
    global _state
    with _state_lock:
        state, _state = _state, None
    if state is None:
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    state.store.add(f"{_KEY}/exit", 1)
    if rank == 0:
        t_end = time.monotonic() + timeout_s
        while state.store.add(f"{_KEY}/exit", 0) < world:
            if time.monotonic() > t_end:
                raise TimeoutError(f"shutdown: not every rank of {world} "
                                   f"left within {timeout_s}s")
            time.sleep(0.01)
    dist.destroy_process_group()
