from repro_torch.kernels.decode_attention.ops import decode_attention
__all__ = ["decode_attention"]
