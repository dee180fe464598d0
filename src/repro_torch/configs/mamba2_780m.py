"""Mamba2-780m [arXiv:2405.21060; unverified] — SSD, attention-free (port
of `repro.configs.mamba2_780m`).  No KV cache exists: W8A8 linears, weight
sync and TIS/MIS apply; LONG_500K runs on the O(1) decode state."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
)
