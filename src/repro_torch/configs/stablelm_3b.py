"""StableLM-2 family dense config [hf:stabilityai/stablelm-2-1_6b; unverified]
(port of `repro.configs.stablelm_3b`)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=6912,
    vocab_size=50304,
    rope_theta=10000.0,
)
