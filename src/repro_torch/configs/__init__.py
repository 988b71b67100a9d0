"""Model settings: the paper's datasets and the LM configs the port
serves (``qwen2_0_5b``, ``qwen3_4b``, their ``reduced`` forms)."""
