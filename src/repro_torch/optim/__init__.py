"""Optimizers: AdamW (the trainer and IUL use it), learning-rate schedules,
and int8 quantization (per row for slab storage, blockwise)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedules import (constant_schedule, cosine_schedule,
                                         linear_warmup_cosine)

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "constant_schedule", "cosine_schedule", "linear_warmup_cosine",
]
