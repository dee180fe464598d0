"""Architecture and shape configuration (port of `repro.configs.base`).

The port keeps its own copy of `ArchConfig` and `reduced()` with the same
fields and defaults, so a reference config maps onto it field for field,
and of the four input-shape cells (`ShapeConfig`) that `launch.steps`
builds its steps and specs for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (seq_len, global_batch) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity -----------------------------------------------------------
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    source: str = ""

    # transformer dims -----------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0              # 0 => attention-free
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # hybrid (attention : SSM interleave) --------------------------------
    attn_period: int = 0

    # SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64

    # encoder-decoder ------------------------------------------------------
    n_enc_layers: int = 0

    # modality frontend stub ------------------------------------------------
    frontend: Optional[str] = None
    frontend_len: int = 0

    # misc ---------------------------------------------------------------
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    mlp_gated: bool = True
    qk_norm: bool = False

    # ------------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    def is_attn_layer(self, i: int) -> bool:
        if self.attention_free:
            return False
        if self.attn_period <= 1:
            return True
        return i % self.attn_period == 0

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i % self.moe_period == self.moe_offset

    def param_count(self) -> int:
        """Analytic parameter count of a dense or MoE decoder (the ported
        families; an MoE layer holds its experts' fc1/fc2 and the router)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_attn = d * (self.n_heads * self.d_head) * 2 \
            + d * (self.n_kv_heads * self.d_head) * 2
        per_mlp = (3 if self.mlp_gated else 2) * d * f
        per_moe = self.n_experts * 3 * d * f + d * self.n_experts
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            total += per_attn + (per_moe if self.is_moe_layer(i) else per_mlp)
        return total

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ArchConfig":
        """Small same-family variant for CPU tests (same rules as the
        reference's `ArchConfig.reduced`)."""
        changes = dict(
            n_layers=min(self.n_layers, 4),
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_enc_layers=min(self.n_enc_layers, 2),
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
        )
        if not self.attention_free:
            n_heads = min(self.n_heads, 4)
            ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
            changes.update(
                n_heads=n_heads,
                n_kv_heads=max(1, n_heads // min(ratio, n_heads)),
                d_head=min(self.d_head, 32),
            )
        if self.n_experts:
            # dropless at test scale: the incremental and teacher-forced
            # paths compute the same MoE function (drops depend on grouping)
            changes.update(n_experts=min(self.n_experts, 4),
                           top_k=min(self.top_k, 2),
                           capacity_factor=8.0)
        if self.ssm_state:
            changes.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=16)
        if self.attn_period > 1:
            changes.update(n_layers=max(changes["n_layers"], self.attn_period))
        changes.update(overrides)
        return dataclasses.replace(self, **changes)
