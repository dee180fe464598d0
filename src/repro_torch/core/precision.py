"""Precision configuration (port of `repro.core.precision`).

Same `PrecisionConfig` fields and presets as the reference; the fp8
dtypes are torch's.  Every quantizer clips to the format's max before it
casts: torch saturates an overflowing cast where JAX gives NaN, so only
clip-then-cast means the same thing in both frameworks.
"""
from __future__ import annotations

import dataclasses
import enum

import torch


class ScaleFormat(str, enum.Enum):
    """Scaling-factor representation (paper §2.4.3)."""

    FP32 = "fp32"
    UE8M0 = "ue8m0"  # power-of-2 scales


class Fp8Recipe(str, enum.Enum):
    HYBRID = "hybrid"
    E4M3 = "e4m3"


class RouterDtype(str, enum.Enum):
    FP8 = "fp8"
    BF16 = "bf16"
    FP32 = "fp32"


class RolloutCorrection(str, enum.Enum):
    NONE = "none"
    TIS = "tis"
    MIS = "mis"


E4M3_MAX = 448.0
E5M2_MAX = 57344.0
E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
FP8_MAX = {E4M3: E4M3_MAX, E5M2: E5M2_MAX}

WEIGHT_BLOCK = 128
ACT_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Full precision recipe for one run (defaults: the paper's
    recommended W8A8 blockwise rollout with an fp8 KV cache)."""

    # --- rollout (inference engine) side -----------------------------------
    quantize_linears: bool = True
    kv_cache_dtype: str = "fp8_e4m3"           # "bf16" | "fp8_e4m3"
    quantize_attention: bool = False           # "Full FP8": QDQ'd q, k, v and P
    calculate_kv_scales: bool = True
    router_dtype: RouterDtype = RouterDtype.BF16
    scale_format: ScaleFormat = ScaleFormat.FP32

    # --- trainer side -------------------------------------------------------
    fp8_training: bool = False
    recipe: Fp8Recipe = Fp8Recipe.HYBRID

    # --- correction ---------------------------------------------------------
    correction: RolloutCorrection = RolloutCorrection.TIS
    tis_clip: float = 2.0
    mis_low: float = 0.5
    mis_high: float = 2.0

    # --- misc ---------------------------------------------------------------
    rollout_router_replay: bool = False

    @property
    def kv_quantized(self) -> bool:
        return self.kv_cache_dtype.startswith("fp8")

    @property
    def any_fp8_rollout(self) -> bool:
        return self.quantize_linears or self.kv_quantized or self.quantize_attention

    def replace(self, **kw) -> "PrecisionConfig":
        return dataclasses.replace(self, **kw)


BF16_ROLLOUT = PrecisionConfig(
    quantize_linears=False, kv_cache_dtype="bf16", quantize_attention=False,
    calculate_kv_scales=False, correction=RolloutCorrection.NONE,
)
FP8_LINEAR_ROLLOUT = PrecisionConfig(kv_cache_dtype="bf16", calculate_kv_scales=False)
FP8_KV_ONLY_ROLLOUT = PrecisionConfig(quantize_linears=False)
FULL_FP8_ROLLOUT = PrecisionConfig(quantize_attention=True)
# end-to-end FP8: `fp8_dot` in every linear given bf16 weights, and the
# quantized attention
E2E_FP8 = PrecisionConfig(quantize_attention=True, fp8_training=True)
