from repro_torch.kernels.simhash_codes.ops import simhash_codes
__all__ = ["simhash_codes"]
