from repro_torch.kernels.bucket_logits.ops import bucket_logits
__all__ = ["bucket_logits"]
