"""Architecture config registry: get_config(arch_id) -> (config, smoke, family)."""
from importlib import import_module

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "qwen1.5-0.5b": "qwen15_05b",
    "tinyllama-1.1b": "tinyllama_11b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "arctic-480b": "arctic_480b",
    "pna": "pna",
    "nequip": "nequip",
    "mace": "mace",
    "dimenet": "dimenet",
    "mind": "mind",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str):
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG, mod.SMOKE, mod.FAMILY
