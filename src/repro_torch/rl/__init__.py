"""RL stack of the port (port of `repro.rl`): DAPO with FP8 rollout and
TIS/MIS correction."""
from repro_torch.rl.advantage import dynamic_sampling_mask, group_advantages
from repro_torch.rl.correction import (
    correction_weights,
    importance_weights,
    mis_mask,
    mismatch_kl,
    tis_weights,
    versioned_correction_weights,
    versioned_mismatch_stats,
)
from repro_torch.rl.loss import LossConfig, dapo_token_loss
from repro_torch.rl.rollout import (
    SamplerConfig,
    Trajectory,
    gather_response_logps,
    generate,
    packed_sequences,
)
from repro_torch.rl.trainer import RLConfig, RLTrainer
from repro_torch.rl.weight_sync import (
    VersionedWeights,
    WeightSyncer,
    sync_policy_weights,
    weight_quant_error,
)

__all__ = [
    "correction_weights", "importance_weights", "tis_weights", "mis_mask",
    "mismatch_kl", "versioned_correction_weights",
    "versioned_mismatch_stats", "group_advantages", "dynamic_sampling_mask",
    "LossConfig", "dapo_token_loss", "SamplerConfig", "Trajectory",
    "generate", "packed_sequences", "gather_response_logps", "RLConfig",
    "RLTrainer", "sync_policy_weights", "VersionedWeights", "WeightSyncer",
    "weight_quant_error",
]
