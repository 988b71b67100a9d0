"""Fused LSS retrieve -> score -> top-k: the serving hot path as one op.

Layout: ``ops.py`` (registry dispatch, shared-memory accounting and the
CUDA wrapper over ``csrc/lss_topk.cu``), ``ref.py`` (the plain version),
``dedup.py`` (the ``lss_topk.dedup`` strategy), ``slabs.py`` (the
``lss_topk.slab_dtype`` storage strategy).
"""

from repro_torch.kernels.lss_topk.dedup import (dedup_auto_threshold,
                                                set_dedup_auto_threshold)
from repro_torch.kernels.lss_topk.ops import lss_topk, lss_topk_smem_bytes
from repro_torch.kernels.lss_topk.slabs import (SLAB_DTYPE_CHOICES,
                                                dequantize_slabs,
                                                lss_topk_slab_dma_bytes,
                                                quantize_slabs,
                                                resolve_slab_dtype,
                                                slab_dtype_of)

__all__ = ["lss_topk", "lss_topk_smem_bytes", "dedup_auto_threshold",
           "set_dedup_auto_threshold", "SLAB_DTYPE_CHOICES",
           "lss_topk_slab_dma_bytes", "quantize_slabs", "dequantize_slabs",
           "resolve_slab_dtype", "slab_dtype_of"]
