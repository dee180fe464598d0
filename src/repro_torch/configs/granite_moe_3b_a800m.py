"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
— 40 experts top-8, narrow d_ff=512 experts (port of
`repro.configs.granite_moe_3b_a800m`)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    rope_theta=10000.0,
    tie_embeddings=True,
)
