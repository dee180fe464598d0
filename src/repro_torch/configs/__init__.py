"""Architecture registry and shape cells of the port (port of
`repro.configs`).

Only the dense family is ported so far; the registry holds the paper's
dense model, qwen3-8b.
"""
from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ArchConfig,
    ShapeConfig,
)
from repro_torch.configs.qwen3_8b import CONFIG as qwen3_8b

REGISTRY = {qwen3_8b.name: qwen3_8b}


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[key]


def tiny_serving_config() -> ArchConfig:
    """The reduced qwen3-8b the reference's serving tests measure
    (`repro.configs.tiny_serving_config`), with the same overrides."""
    from repro_torch.data import tasks
    return get_config("qwen3-8b").reduced(
        n_layers=2, d_model=64, d_ff=128, vocab_size=tasks.VOCAB_SIZE,
        n_heads=4, n_kv_heads=2, d_head=16)


__all__ = ["ALL_SHAPES", "ArchConfig", "DECODE_32K", "LONG_500K",
           "PREFILL_32K", "REGISTRY", "ShapeConfig", "TRAIN_4K", "get_config",
           "qwen3_8b", "tiny_serving_config"]
