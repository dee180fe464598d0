"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] — Mamba + attention 1:7
interleave, MoE 16 experts top-2 every other layer (port of
`repro.configs.jamba_1_5_large_398b`).  Pattern period 8 (one attention
and seven SSM layers), 9 repeats for 72 layers; at LONG_500K only 9
layers hold a dense KV cache.  Too large for one card: meta specs,
reduced runs and one full-width period."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="[arXiv:2403.19887; hf]",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=128,
    rope_theta=10000.0,
)
