"""Llama-3.2-3B dense config [hf:meta-llama/Llama-3.2-1B; unverified]
(port of `repro.configs.llama3_2_3b`)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
)
