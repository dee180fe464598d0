"""Architecture registry and shape cells of the port (port of
`repro.configs`).

The dense and MoE families are ported; the registry holds the paper's
two models, qwen3-8b (dense) and qwen3-30b-a3b (MoE, 128 experts top-8),
the reference's dense assigned architectures: llama3.2-3b (tied
embeddings), stablelm-3b (D 80, no GQA), starcoder2-15b (G 12, a classic
gelu MLP) and mistral-large-123b, and its MoE ones: granite-moe-3b-a800m
(40 experts top-8, D 64, tied embeddings) and grok-1-314b (8 experts
top-2).  mistral-large-123b and grok-1-314b are too large for one card:
meta specs and reduced runs only.
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
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from repro_torch.configs.grok_1_314b import CONFIG as grok_1_314b
from repro_torch.configs.llama3_2_3b import CONFIG as llama3_2_3b
from repro_torch.configs.mistral_large_123b import CONFIG as mistral_large_123b
from repro_torch.configs.qwen3_8b import CONFIG as qwen3_8b
from repro_torch.configs.qwen3_30b_a3b import CONFIG as qwen3_30b_a3b
from repro_torch.configs.stablelm_3b import CONFIG as stablelm_3b
from repro_torch.configs.starcoder2_15b import CONFIG as starcoder2_15b

REGISTRY = {c.name: c for c in (qwen3_8b, llama3_2_3b, stablelm_3b,
                                starcoder2_15b, mistral_large_123b,
                                qwen3_30b_a3b, granite_moe_3b_a800m,
                                grok_1_314b)}


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
           "granite_moe_3b_a800m", "grok_1_314b", "llama3_2_3b",
           "mistral_large_123b", "qwen3_30b_a3b", "qwen3_8b", "stablelm_3b",
           "starcoder2_15b", "tiny_serving_config"]
