"""--arch <id> registry (counterpart of ``repro.configs.registry``) over
the architectures the port holds: the dense LMs.  The JAX package's
other seven ids (the MoE LMs, the GNN and the recommenders) come with
the rest of the model zoo, ROADMAP Queue 1 item 8; asking for one
raises a ``KeyError`` that says so."""

import importlib

__all__ = ["ARCH_MODULES", "ALL_ARCHS", "NOT_PORTED", "get_config"]

ARCH_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
}

ALL_ARCHS = list(ARCH_MODULES)

#: the JAX registry's ids whose models the port does not have yet
NOT_PORTED = ("arctic-480b", "qwen2-moe-a2.7b", "gcn-cora", "bert4rec",
              "dien", "deepfm", "autoint")


def get_config(arch_id: str):
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: its model "
                       f"comes with the rest of the model zoo (ROADMAP "
                       f"Queue 1 item 8); the port holds {ALL_ARCHS}")
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCHS}")
    return importlib.import_module(ARCH_MODULES[arch_id]).CONFIG
