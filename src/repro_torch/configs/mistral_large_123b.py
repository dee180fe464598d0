"""Mistral-Large-2407 123B dense [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
(port of `repro.configs.mistral_large_123b`)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    source="[hf:mistralai/Mistral-Large-Instruct-2407; unverified]",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1000000.0,
)
