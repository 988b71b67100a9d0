"""Hand-written CUDA kernels for Hopper (``sm_90a``) behind a dispatch
registry.

Each op ships as ``<name>/{ops.py, ref.py}`` beside its CUDA source in
``repro_torch/csrc/``: the wrapper that launches the kernel for CUDA
tensors, and the plain PyTorch version that serves CPU tensors.  The
registry (``repro_torch.kernels.registry``) picks by device; an explicit
``impl=`` must agree with it.  Kernels are built by ``nvcc`` at first use
(``repro_torch.kernels._build``), never at import.
"""
from repro_torch.kernels import registry
from repro_torch.kernels.bucket_logits import bucket_logits
from repro_torch.kernels.lss_topk import lss_topk
from repro_torch.kernels.simhash_codes import simhash_codes

__all__ = ["registry", "simhash_codes", "lss_topk", "bucket_logits"]
