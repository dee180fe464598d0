"""Architecture registry and shape cells of the port (port of
`repro.configs`).

Only the dense family is ported so far; the registry holds the paper's
dense model, qwen3-8b, and the reference's dense assigned architectures:
llama3.2-3b (tied embeddings), stablelm-3b (D 80, no GQA), starcoder2-15b
(G 12, a classic gelu MLP) and mistral-large-123b (too large for one
card: meta specs and reduced runs only).
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
from repro_torch.configs.llama3_2_3b import CONFIG as llama3_2_3b
from repro_torch.configs.mistral_large_123b import CONFIG as mistral_large_123b
from repro_torch.configs.qwen3_8b import CONFIG as qwen3_8b
from repro_torch.configs.stablelm_3b import CONFIG as stablelm_3b
from repro_torch.configs.starcoder2_15b import CONFIG as starcoder2_15b

REGISTRY = {c.name: c for c in (qwen3_8b, llama3_2_3b, stablelm_3b,
                                starcoder2_15b, mistral_large_123b)}


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
           "llama3_2_3b", "mistral_large_123b", "qwen3_8b", "stablelm_3b",
           "starcoder2_15b", "tiny_serving_config"]
