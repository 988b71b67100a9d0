"""Optimizers: AdamW (IUL trains the hyperplanes with it) and the int8 row
quantization of slab storage."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm"]
