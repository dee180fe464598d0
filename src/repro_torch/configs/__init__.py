"""Architecture registry and shape cells of the port (port of
`repro.configs`).

The dense and MoE families are ported; the registry holds the paper's
two models, qwen3-8b (dense) and qwen3-30b-a3b (MoE, 128 experts top-8),
the reference's dense assigned architectures: llama3.2-3b (tied
embeddings), stablelm-3b (D 80, no GQA), starcoder2-15b (G 12, a classic
gelu MLP) and mistral-large-123b, and its MoE ones: granite-moe-3b-a800m
(40 experts top-8, D 64, tied embeddings) and grok-1-314b (8 experts
top-2), the SSM model mamba2-780m (attention-free), the hybrid
jamba-1.5-large-398b (one attention per 8 layers, MoE every other
layer), the encoder-decoder seamless-m4t-medium (frames through an
encoder, cross attention in every decoder layer) and the VLM pixtral-12b
(projected patches as a prefix ahead of the text): all twelve of the
reference's.  mistral-large-123b, grok-1-314b and jamba-1.5-large-398b
are too large for one card: meta specs and reduced runs (jamba also one
full-width period).
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
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as jamba_1_5_large_398b
from repro_torch.configs.llama3_2_3b import CONFIG as llama3_2_3b
from repro_torch.configs.mamba2_780m import CONFIG as mamba2_780m
from repro_torch.configs.mistral_large_123b import CONFIG as mistral_large_123b
from repro_torch.configs.pixtral_12b import CONFIG as pixtral_12b
from repro_torch.configs.qwen3_8b import CONFIG as qwen3_8b
from repro_torch.configs.qwen3_30b_a3b import CONFIG as qwen3_30b_a3b
from repro_torch.configs.seamless_m4t_medium import CONFIG as seamless_m4t_medium
from repro_torch.configs.stablelm_3b import CONFIG as stablelm_3b
from repro_torch.configs.starcoder2_15b import CONFIG as starcoder2_15b

REGISTRY = {c.name: c for c in (qwen3_8b, llama3_2_3b, stablelm_3b,
                                starcoder2_15b, mistral_large_123b,
                                qwen3_30b_a3b, granite_moe_3b_a800m,
                                grok_1_314b, mamba2_780m,
                                jamba_1_5_large_398b, seamless_m4t_medium,
                                pixtral_12b)}


# the reference's two groups: its ten assigned architectures (the dry
# run's cells) and the paper's own two Qwen3 models
ASSIGNED = {c.name: c for c in (
    seamless_m4t_medium, stablelm_3b, llama3_2_3b, mistral_large_123b,
    starcoder2_15b, jamba_1_5_large_398b, granite_moe_3b_a800m,
    grok_1_314b, mamba2_780m, pixtral_12b)}
PAPER = {c.name: c for c in (qwen3_8b, qwen3_30b_a3b)}


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


def tiny_hybrid_serving_config() -> ArchConfig:
    """Jamba-style attention + SSM interleave (period 2: one attention
    layer, one Mamba2 layer) at serving-test scale
    (`repro.configs.tiny_hybrid_serving_config`, the same overrides)."""
    from repro_torch.data import tasks
    return get_config("jamba-1.5-large-398b").reduced(
        n_layers=2, attn_period=2, n_experts=0, top_k=0,
        moe_period=1, moe_offset=0,
        d_model=64, d_ff=128, vocab_size=tasks.VOCAB_SIZE,
        n_heads=4, n_kv_heads=2, d_head=16,
        ssm_state=8, ssm_head_dim=16)


def tiny_ssm_serving_config() -> ArchConfig:
    """Attention-free reduced mamba2-780m: no KV cache, serving bounded by
    the per-slot recurrent-state bytes
    (`repro.configs.tiny_ssm_serving_config`, the same overrides)."""
    from repro_torch.data import tasks
    return get_config("mamba2-780m").reduced(
        n_layers=2, d_model=64, vocab_size=tasks.VOCAB_SIZE,
        ssm_state=8, ssm_head_dim=16)


def tiny_encdec_serving_config() -> ArchConfig:
    """Reduced seamless-m4t-medium: enc-dec with per-request frames and
    cross-attention KV held beside the paged decoder self-KV
    (`repro.configs.tiny_encdec_serving_config`, the same overrides)."""
    from repro_torch.data import tasks
    return get_config("seamless-m4t-medium").reduced(
        n_layers=2, n_enc_layers=2, d_model=64, d_ff=128,
        vocab_size=tasks.VOCAB_SIZE, n_heads=4, n_kv_heads=2, d_head=16)


__all__ = ["ALL_SHAPES", "ASSIGNED", "ArchConfig", "DECODE_32K", "LONG_500K",
           "PAPER", "PREFILL_32K", "REGISTRY", "ShapeConfig", "TRAIN_4K", "get_config",
           "granite_moe_3b_a800m", "grok_1_314b", "jamba_1_5_large_398b",
           "llama3_2_3b", "mamba2_780m", "mistral_large_123b",
           "pixtral_12b", "qwen3_30b_a3b", "qwen3_8b", "seamless_m4t_medium",
           "stablelm_3b", "starcoder2_15b", "tiny_encdec_serving_config",
           "tiny_hybrid_serving_config", "tiny_serving_config",
           "tiny_ssm_serving_config"]
