"""PyTorch/CUDA port of the WOL/LSS system (``src/repro`` is the JAX reference).

The package mirrors ``repro``'s module paths so that each module's
counterpart is easy to find, and imports neither ``jax`` nor ``repro``.
Entry points run on the GPU unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); functions on tensors follow
their inputs' device.

Kernels (``repro_torch.kernels``) are CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``.
Each has a plain PyTorch version that serves CPU tensors; a CUDA tensor
always goes through the kernel, or the call raises.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
