"""Training meshes (counterpart of ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model): ``pod`` is
a pure data-parallel axis over the slow links between pods, the axis the
gradient compressor (``repro_torch.optim.compression``) targets.

Functions, not module constants: a mesh is made over the ranks that
``repro_torch.distributed.init_distributed`` started, and importing this
module starts nothing.  ``make_serving_mesh`` is the serving (host,
model) layout of ``repro_torch.distributed``, re-exported.  The JAX
module's v5e roofline constants are TPU numbers and have no counterpart
here.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import make_serving_mesh, make_training_mesh

__all__ = ["make_production_mesh", "make_debug_mesh", "make_serving_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_training_mesh(shape, axes).mesh


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> DeviceMesh:
    """Small mesh for tests (a fleet of ``prod(shape)`` ranks)."""
    return make_training_mesh(shape, axes).mesh
