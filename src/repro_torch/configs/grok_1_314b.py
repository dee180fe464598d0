"""Grok-1 314B [hf:xai-org/grok-1; unverified] — MoE 8 experts top-2 (port
of `repro.configs.grok_1_314b`; too large for one card: meta specs and
reduced runs only)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    source="[hf:xai-org/grok-1; unverified]",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    rope_theta=10000.0,
)
