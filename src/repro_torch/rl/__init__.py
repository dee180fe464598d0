"""RL side of the port (port of `repro.rl`): weight sync and rollout."""
from repro_torch.rl.rollout import SamplerConfig, Trajectory, generate
from repro_torch.rl.weight_sync import sync_policy_weights

__all__ = ["SamplerConfig", "Trajectory", "generate", "sync_policy_weights"]
