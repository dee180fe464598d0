"""SeamlessM4T-medium backbone [arXiv:2308.11596; hf] — enc-dec, multimodal
(port of `repro.configs.seamless_m4t_medium`).  12 encoder + 12 decoder
layers; the speech frontend is a stub: requests carry precomputed frame
embeddings (B, S_src, d_model), projected by `frontend/w_patch`.  W8A8 on
the encoder's and the decoder's linears; FP8 KV on decoder self-attention;
cross-attention KV quantized once at prefill."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="[arXiv:2308.11596; hf]",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio_frames",
    frontend_len=0,
    rope_theta=10000.0,
    act="relu",
    mlp_gated=False,
)
