# Assigned architectures (public pool) + the paper's own ResNet-50.
# One module per architecture; all register into base._REGISTRY.
import importlib

from .base import ArchConfig, ShapeCfg, LM_SHAPES, all_configs, get_config

ARCH_MODULES = [
    "zamba2_7b",
    "h2o_danube3_4b",
    "starcoder2_15b",
    "qwen3_0_6b",
    "gemma3_4b",
    "grok1_314b",
    "dbrx_132b",
    "internvl2_76b",
    "musicgen_large",
    "rwkv6_7b",
]

_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


__all__ = ["ArchConfig", "ShapeCfg", "LM_SHAPES", "all_configs", "get_config", "ARCH_MODULES"]
