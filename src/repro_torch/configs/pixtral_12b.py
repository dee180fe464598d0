"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified] — mistral-nemo
backbone (port of `repro.configs.pixtral_12b`); the pixtral-ViT frontend
is a stub: inputs carry precomputed patch embeddings, projected by
`frontend/w_patch` into a prefix ahead of the text."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    source="[hf:mistralai/Pixtral-12B-2409; unverified]",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    frontend="vision_patches",
    frontend_len=1024,          # (32x32 patches) stub prefix
    rope_theta=1000000000.0,
)
