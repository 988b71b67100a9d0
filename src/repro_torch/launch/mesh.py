"""Training meshes (counterpart of ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model): ``pod`` is
a pure data-parallel axis over the slow links between pods, the axis the
gradient compressor (``repro_torch.optim.compression``) targets.

Functions, not module constants: a mesh is made over the ranks that
``repro_torch.distributed.init_distributed`` started, and importing this
module starts nothing.  ``make_serving_mesh`` is the serving (host,
model) layout of ``repro_torch.distributed``, re-exported.

Over a fleet that :func:`~repro_torch.distributed.init_distributed`
started, a mesh is :func:`~repro_torch.distributed.make_training_mesh`'s;
over a process group started some other way (the dry-run's fake fleet:
``init_process_group("fake", world_size=256 or 512, ...)``), it is a
``DeviceMesh`` over that group's ranks, row-major.

The roofline's hardware constants (the JAX module's are a TPU v5e's) are
the NVIDIA H100 SXM5 80GB's published datasheet figures at 700 W, not
measurements: dense BF16 tensor-core 989 TFLOP/s, FP32 67 TFLOP/s (the
port runs fp32 with TF32 off, so an fp32 product runs at this rate),
HBM3 3.35 TB/s, NVLink 4 450 GB/s a direction to each of the 7 other
GPUs of a node of 8 (900 GB/s both ways), and 50 GB/s a GPU between
nodes (one NDR InfiniBand port, 400 Gb/s).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import make_serving_mesh, make_training_mesh

__all__ = ["make_production_mesh", "make_debug_mesh", "make_serving_mesh",
           "make_mesh", "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32", "HBM_BW",
           "NVLINK_BW", "NETWORK_BW", "GPUS_PER_NODE"]

# NVIDIA H100 SXM5 80GB datasheet figures (700 W), per GPU
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense BF16 tensor core
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, FP32 (TF32 off)
HBM_BW = 3.35e12              # B/s, HBM3
NVLINK_BW = 450e9             # B/s a direction, inside a node
NETWORK_BW = 50e9             # B/s a GPU between nodes (NDR 400 Gb/s)
GPUS_PER_NODE = 8


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` (dims named ``axes``) over the ranks
    of the running process group, row-major: the fleet's training mesh
    where :func:`~repro_torch.distributed.init_distributed` started one,
    else a CPU mesh over the group's ranks (the dry-run's fake fleet,
    whose tensors are fake CPU tensors)."""
    from repro_torch import distributed

    if distributed.is_distributed():
        return make_training_mesh(shape, axes).mesh
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: start a fleet first")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> DeviceMesh:
    """Small mesh for tests (a fleet of ``prod(shape)`` ranks)."""
    return make_mesh(shape, axes)
