from repro_torch.kernels.bucket_logits.ref import bucket_logits_ref
__all__ = ["bucket_logits_ref"]
