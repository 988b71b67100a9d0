"""--arch <id> registry over the ten architectures (counterpart of
``repro.configs.registry``): the five LMs (dense and MoE), the GCN and
the four recommenders, in the JAX package's order."""

import importlib

__all__ = ["ARCH_MODULES", "ALL_ARCHS", "get_config", "all_cells"]

ARCH_MODULES = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "bert4rec": "repro_torch.configs.bert4rec",
    "dien": "repro_torch.configs.dien",
    "deepfm": "repro_torch.configs.deepfm",
    "autoint": "repro_torch.configs.autoint",
}

ALL_ARCHS = list(ARCH_MODULES)


def get_config(arch_id: str):
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCHS}")
    return importlib.import_module(ARCH_MODULES[arch_id]).CONFIG


def all_cells() -> list[tuple[str, str]]:
    """All 40 (arch, shape) cells of the dry-run, in the JAX package's
    order: each architecture's shapes in its config's order."""
    return [(a, s) for a in ALL_ARCHS for s in get_config(a).shapes]
