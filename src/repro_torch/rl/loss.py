"""DAPO token-level policy loss with rollout correction (port of
`repro.rl.loss`, paper §2.1.3).

Per token t of response i:

    r_t = exp(logp_theta - logp_old)           # PPO ratio
    w_t = correction(logp_old, logp_rollout)   # TIS / MIS / 1
    L_t = -w_t * min(r_t * A_i, clip(r_t, 1-eps_lo, 1+eps_hi) * A_i)

Token-level normalization (DAPO): the sum over all tokens divided by the
token count.  `eps_high > eps_low` is DAPO's clip-higher.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.precision import PrecisionConfig
from repro_torch.rl.correction import (
    correction_weights,
    mismatch_kl,
    versioned_correction_weights,
    versioned_mismatch_stats,
)


class LossConfig(NamedTuple):
    eps_low: float = 0.2
    eps_high: float = 0.28       # DAPO clip-higher
    entropy_coef: float = 0.0
    moe_aux_coef: float = 0.0


def dapo_token_loss(
    logp_theta: torch.Tensor,     # (B, G) current-policy logprobs (grad flows)
    logp_old: torch.Tensor,       # (B, G) scoring-policy logprobs at rollout
    logp_rollout: torch.Tensor,   # (B, G) FP8 rollout-engine logprobs
    advantages: torch.Tensor,     # (B,)
    mask: torch.Tensor,           # (B, G) loss mask (dynamic sampling applied)
    precision: PrecisionConfig,
    cfg: LossConfig = LossConfig(),
    metrics_mask: Optional[torch.Tensor] = None,    # (B, G) raw response mask
    token_versions: Optional[torch.Tensor] = None,  # (B, G) weight version
    num_versions: int = 1,
):
    """Returns (loss, stats); the stats are 0-dim tensors (the versioned
    breakdown (num_versions,) tensors)."""
    logp_old = logp_old.detach()
    ratio = torch.exp(logp_theta - logp_old)
    adv = advantages[:, None]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - cfg.eps_low, 1.0 + cfg.eps_high) * adv
    pg = -torch.minimum(unclipped, clipped)

    if token_versions is not None:
        w = versioned_correction_weights(
            logp_old, logp_rollout, token_versions, mask, precision,
            num_versions=num_versions)
    else:
        w = correction_weights(logp_old, logp_rollout, precision)
    n_tok = torch.clamp_min(mask.sum(), 1.0)
    loss = (pg * w * mask).sum() / n_tok

    with torch.no_grad():
        stats = {
            "pg_loss": loss.detach(),
            "ratio_mean": (ratio * mask).sum() / n_tok,
            "clip_frac": (((ratio - 1.0).abs() > cfg.eps_low) * mask).sum() / n_tok,
            "corr_weight_mean": (w * mask).sum() / n_tok,
            "corr_masked_frac": ((w < 1e-6) * mask).sum() / n_tok,
            # normalized effective sample size of the weights over masked
            # tokens, (sum w)^2 / (n * sum w^2) in [1/n, 1]
            "corr_weight_ess": (w * mask).sum() ** 2
            / (torch.clamp_min((w * w * mask).sum(), 1e-12) * n_tok),
        }
        # mismatch over *all* response tokens: the dynamic-sampling mask
        # must not hide the distribution shift
        mmask = mask if metrics_mask is None else metrics_mask
        stats.update(mismatch_kl(logp_rollout, logp_old, mmask))
        if token_versions is not None:
            stats.update(versioned_mismatch_stats(
                logp_rollout, logp_old, token_versions, mmask,
                num_versions=num_versions))
    return loss, stats
