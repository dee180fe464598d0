"""Qwen3-30B-A3B-Base — the paper's MoE experiment model (§2.2.3; port of
`repro.configs.qwen3_30b_a3b`)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-30b-a3b",
    family="moe",
    source="[paper §2.2.3; hf:Qwen/Qwen3-30B-A3B-Base]",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    rope_theta=1000000.0,
    qk_norm=True,
)
