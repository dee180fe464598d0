"""Importance-sampling rollout correction and mismatch metrics (port of
`repro.rl.correction`, paper §2.1.3).

The trainer optimizes pi_theta on samples drawn from the quantized policy
pi^FP8.  Corrections reweight each token by w = pi_theta / pi^FP8: TIS
clips w at C (C = 2 in the paper), MIS masks tokens with w outside
[low, high].  `mismatch_kl` is the monitoring metric D_KL(pi^FP8 ||
pi_theta) on sampled tokens (k1 and k3 estimators).  The versioned
variants correct each token against the weight version that sampled it,
self-normalizing the ratios within each version first.  Every weight is
detached: it corrects the sampling distribution and is not
differentiated.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import PrecisionConfig, RolloutCorrection


def importance_weights(logp_train: torch.Tensor, logp_rollout: torch.Tensor
                       ) -> torch.Tensor:
    """w = pi_theta / pi_fp8 per token; inputs are per-token logprobs."""
    return torch.exp(logp_train - logp_rollout)


def tis_weights(logp_train, logp_rollout, clip: float = 2.0) -> torch.Tensor:
    """Token-level truncated importance sampling (eq. 3)."""
    w = importance_weights(logp_train, logp_rollout)
    return torch.clamp(w, max=clip)


def mis_mask(logp_train, logp_rollout, low: float = 0.5, high: float = 2.0
             ) -> torch.Tensor:
    """Masked importance sampling: drop tokens with unreliable ratios."""
    w = importance_weights(logp_train, logp_rollout)
    return ((w >= low) & (w <= high)).float()


def correction_weights(logp_train: torch.Tensor, logp_rollout: torch.Tensor,
                       precision: PrecisionConfig) -> torch.Tensor:
    """Dispatch on the configured correction."""
    mode = precision.correction
    if mode == RolloutCorrection.NONE:
        return torch.ones_like(logp_train)
    if mode == RolloutCorrection.TIS:
        w = tis_weights(logp_train, logp_rollout, precision.tis_clip)
    elif mode == RolloutCorrection.MIS:
        w = mis_mask(logp_train, logp_rollout, precision.mis_low,
                     precision.mis_high)
    else:  # pragma: no cover
        raise ValueError(mode)
    return w.detach()


def _version_onehot(token_versions, mask, num_versions: int) -> torch.Tensor:
    """(..., V) membership of each token in its version, zeroed outside
    the mask."""
    ar = torch.arange(num_versions, device=token_versions.device)
    return (token_versions[..., None] == ar).float() * mask[..., None]


def versioned_correction_weights(
    logp_train: torch.Tensor,
    logp_rollout: torch.Tensor,
    token_versions: torch.Tensor,
    mask: torch.Tensor,
    precision: PrecisionConfig,
    *,
    num_versions: int,
    normalize: bool = True,
) -> torch.Tensor:
    """Version-aware token-level TIS/MIS for rollouts spanning hot-swaps.

    With `normalize`, each token's ratio is divided by the masked mean
    ratio of its version over the whole batch (self-normalized IS per
    proposal distribution); empty versions and tokens outside
    [0, num_versions) keep their raw ratio.  The TIS clip / MIS band then
    applies to the normalized ratios."""
    mode = precision.correction
    if mode == RolloutCorrection.NONE:
        return torch.ones_like(logp_train)
    w = importance_weights(logp_train, logp_rollout)
    if normalize:
        onehot = _version_onehot(token_versions, mask, num_versions)
        flat_oh = onehot.reshape(-1, num_versions)
        flat_w = w.reshape(-1)
        count = flat_oh.sum(dim=0)
        mean_w = (flat_oh * flat_w[:, None]).sum(dim=0) / torch.clamp_min(count, 1.0)
        mean_w = torch.where(count > 0.0, mean_w, 1.0)
        norm = (onehot * mean_w).sum(dim=-1)
        norm = torch.where(norm > 0.0, norm, 1.0)
        w = w / norm
    if mode == RolloutCorrection.TIS:
        w = torch.clamp(w, max=precision.tis_clip)
    elif mode == RolloutCorrection.MIS:
        w = ((w >= precision.mis_low) & (w <= precision.mis_high)).float()
    else:  # pragma: no cover
        raise ValueError(mode)
    return w.detach()


# ---------------------------------------------------------------------------
# mismatch monitoring
# ---------------------------------------------------------------------------

def mismatch_kl(logp_rollout: torch.Tensor, logp_train: torch.Tensor,
                mask: torch.Tensor) -> dict:
    """D_KL(pi_fp8 || pi_theta) on tokens sampled from pi_fp8.

    k1 = E[log pi_fp8 - log pi_theta]
    k3 = E[(r - 1) - log r],  r = pi_theta / pi_fp8   (Schulman's estimator)
    """
    d = (logp_rollout - logp_train) * mask
    n = torch.clamp_min(mask.sum(), 1.0)
    k1 = d.sum() / n
    log_r = logp_train - logp_rollout
    r = torch.exp(torch.clamp(log_r, -20.0, 20.0))
    k3 = (((r - 1.0) - log_r) * mask).sum() / n
    return {"mismatch_kl_k1": k1, "mismatch_kl": k3,
            "is_weight_mean": (r * mask).sum() / n,
            "is_weight_max": torch.max(r * mask)}


def versioned_mismatch_stats(logp_rollout: torch.Tensor,
                             logp_train: torch.Tensor,
                             token_versions: torch.Tensor, mask: torch.Tensor,
                             *, num_versions: int) -> dict:
    """Per-weight-version mismatch monitoring: (num_versions,) token
    counts, k3 KL and mean raw IS ratio per version."""
    onehot = _version_onehot(token_versions, mask, num_versions)
    onehot = onehot.reshape(-1, num_versions)
    log_r = (logp_train - logp_rollout).reshape(-1)
    r = torch.exp(torch.clamp(log_r, -20.0, 20.0))
    k3_tok = (r - 1.0) - log_r
    n = torch.clamp_min(onehot.sum(dim=0), 1.0)
    return {
        "tokens_per_version": onehot.sum(dim=0),
        "mismatch_kl_per_version": (onehot * k3_tok[:, None]).sum(dim=0) / n,
        "is_weight_mean_per_version": (onehot * r[:, None]).sum(dim=0) / n,
    }
