"""Group-relative advantages (GRPO) with DAPO refinements (port of
`repro.rl.advantage`, paper §2.2.1)."""
from __future__ import annotations

import torch


def group_advantages(rewards: torch.Tensor, n_per_prompt: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """rewards (B,) grouped as (B/n, n): A = (r - mean_g) / (std_g + eps)."""
    g = rewards.reshape(-1, n_per_prompt)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, correction=0, keepdim=True)
    adv = (g - mean) / (std + eps)
    return adv.reshape(-1)


def dynamic_sampling_mask(rewards: torch.Tensor, n_per_prompt: int
                          ) -> torch.Tensor:
    """DAPO dynamic sampling: groups whose rewards are all identical carry
    zero learning signal and are masked out of the loss (the fixed-shape
    equivalent of resampling them)."""
    g = rewards.reshape(-1, n_per_prompt)
    informative = g.std(dim=1, correction=0) > 1e-6
    return torch.repeat_interleave(informative.float(), n_per_prompt)


def overlong_penalty(resp_lengths: torch.Tensor, max_len: int,
                     soft_start_frac: float = 0.8,
                     max_penalty: float = 0.5) -> torch.Tensor:
    """DAPO overlong reward shaping: responses approaching the hard cutoff
    get a soft penalty growing linearly to `max_penalty` at the cap."""
    soft = int(max_len * soft_start_frac)
    over = torch.clamp(resp_lengths - soft, 0, max_len - soft)
    return -max_penalty * over / max(max_len - soft, 1)
