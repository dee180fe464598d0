"""StarCoder2-15B [arXiv:2402.19173; hf] — GQA, RoPE
(port of `repro.configs.starcoder2_15b`)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    source="[arXiv:2402.19173; hf]",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_head=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100000.0,
    act="gelu",
    mlp_gated=False,
)
