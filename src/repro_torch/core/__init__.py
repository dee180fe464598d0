"""Core numerics of the port (port of `repro.core`)."""
from repro_torch.core.precision import (
    BF16_ROLLOUT,
    E2E_FP8,
    E4M3,
    E5M2,
    FP8_KV_ONLY_ROLLOUT,
    FP8_LINEAR_ROLLOUT,
    FP8_MAX,
    FULL_FP8_ROLLOUT,
    PrecisionConfig,
    RolloutCorrection,
    ScaleFormat,
)
from repro_torch.core.quant import QuantizedTensor, qdq, qdq_weight, quantization_rel_error

__all__ = ["BF16_ROLLOUT", "E2E_FP8", "E4M3", "E5M2", "FP8_KV_ONLY_ROLLOUT",
           "FP8_LINEAR_ROLLOUT", "FP8_MAX", "FULL_FP8_ROLLOUT",
           "PrecisionConfig", "QuantizedTensor", "RolloutCorrection", "ScaleFormat",
           "qdq", "qdq_weight", "quantization_rel_error"]
