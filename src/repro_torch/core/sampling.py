"""Token sampler of the rollout loop (port of `repro.core.sampling.sample`).

f32 logits; temperature 0 is greedy argmax (ties to the lowest index, as
`jnp.argmax` and `torch.argmax` both do); temperature > 0 is a
(optionally top-k truncated) categorical draw.  The draw uses Gumbel-max
noise from the caller's `torch.Generator`: it cannot reproduce
`jax.random`'s bits, only the distribution.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def _top_k_mask(scaled: torch.Tensor, k: int) -> torch.Tensor:
    """Mask keeping EXACTLY `k` entries of the last axis; ties at the k-th
    value go to the lower index (the order of the reference's
    `lax.top_k`).  `torch.topk` promises no tie order, so a stable
    descending sort decides instead."""
    idx = torch.sort(scaled, dim=-1, descending=True, stable=True).indices[..., :k]
    mask = torch.zeros_like(scaled, dtype=torch.bool)
    return mask.scatter_(-1, idx, True)


def sampling_logits(logits: torch.Tensor, temperature: float,
                    top_k: int = 0) -> torch.Tensor:
    assert temperature > 0.0, "greedy sampling has no distribution to scale"
    scaled = logits.float() / temperature
    if top_k > 0:
        scaled = torch.where(_top_k_mask(scaled, top_k), scaled, _NEG_INF)
    return scaled


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float, top_k: int = 0):
    """Sample next tokens from `logits` (..., V) -> (tokens, logps).

    logps are under the (tempered, truncated) sampling distribution; for
    greedy they come from the untempered softmax (the rollout-side
    pi^FP8 convention of TIS).
    """
    logits = logits.float()
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        logits = sampling_logits(logits, temperature, top_k)
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        tok = torch.argmax(logits + gumbel, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    return tok, logp.gather(-1, tok[..., None])[..., 0]
