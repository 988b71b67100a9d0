from repro_torch.kernels.prefill_attention.ops import prefill_attention
__all__ = ["prefill_attention"]
