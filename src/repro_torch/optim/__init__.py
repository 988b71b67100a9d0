"""Optimizer-side helpers (int8 row quantization for slab storage)."""
