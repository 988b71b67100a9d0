"""Deterministic, checkpoint-resumable batch pipeline (counterpart of
``repro.data.pipeline``).

The iterator's state is one integer (the global step) and the shuffle
seed, so a restore resumes mid-epoch deterministically.  Each epoch's
order is ``np.random.default_rng((seed, epoch)).permutation(n)``, as in
the JAX package, so both iterators yield the same batches for the same
arrays and seed.  Batches are gathered on the host and arrive as tensors
on ``device`` (the GPU unless the caller asks for the CPU).

With a ``mesh``, every rank builds the same global batch from the seed
and keeps its own rows of it (split over ``data_axes``, replicated over
the other axes) as a ``DTensor`` (``DTensor.from_local``: no scatter from
rank 0).  The state stays ``{step, seed}``, so a restore onto another
mesh resumes at the same global batch.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device
from repro_torch.utils.sharding import P, place, spec_placements

__all__ = ["ShardedBatchIterator"]


class ShardedBatchIterator:
    """Yields dict batches of tensors on ``device`` (or sharded over
    ``data_axes`` of ``mesh``); the last partial batch of each epoch is
    dropped."""

    def __init__(self, arrays: dict[str, np.ndarray], batch_size: int,
                 *, seed: int = 0, device: str | torch.device | None = None,
                 start_step: int = 0, mesh: DeviceMesh | None = None,
                 data_axes: tuple[str, ...] = ("data",)):
        sizes = {k: v.shape[0] for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"arrays differ in length: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.device = (resolve_device(device) if mesh is None
                       else torch.device(mesh.device_type))
        self.step = start_step
        self.batches_per_epoch = self.n // batch_size
        if self.batches_per_epoch <= 0:
            raise ValueError(f"{self.n} rows make no batch of {batch_size}")

    # -- checkpointable state ------------------------------------------
    def state_dict(self) -> dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: dict[str, int]) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    # -- iteration ------------------------------------------------------
    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n)

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        epoch = self.step // self.batches_per_epoch
        i = self.step % self.batches_per_epoch
        perm = self._epoch_perm(epoch)
        idx = perm[i * self.batch_size:(i + 1) * self.batch_size]
        self.step += 1
        batch = {k: torch.from_numpy(v[idx]) for k, v in self.arrays.items()}
        if self.mesh is None:
            return {k: v.to(self.device) for k, v in batch.items()}
        return {k: place(v, self.mesh, spec_placements(
                    self.mesh, P(self.data_axes), v.ndim))
                for k, v in batch.items()}
