"""Qwen3-8B-Base — the paper's dense experiment model (port of
`repro.configs.qwen3_8b`)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    source="[paper §2.2.2; hf:Qwen/Qwen3-8B-Base]",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    rope_theta=1000000.0,
    qk_norm=True,
)
