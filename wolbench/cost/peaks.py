"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
FP32_FLOPS = 67e12         # float32 outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12  # 80 GB of HBM3


def bound_s(nbytes: float, flops: float, flops_peak: float = FP32_FLOPS
            ) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_peak)
