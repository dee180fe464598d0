"""Token sampler of the rollout and serving loops, and the speculative
verifier (port of `repro.core.sampling`).

f32 logits; temperature 0 is greedy argmax (ties to the lowest index, as
`jnp.argmax` and `torch.argmax` both do); temperature > 0 is a
(optionally top-k truncated) categorical draw.  Every draw uses Gumbel-max
noise or uniforms from the caller's `torch.Generator`: it cannot
reproduce `jax.random`'s bits, only the distribution.
`sampling_logits` is the one definition of the truncated distribution
that `sample` draws from and `rejection_sample` verifies against.
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


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float, top_k: int = 0, want_logp: bool = True):
    """Sample next tokens from `logits` (..., V) -> (tokens, logps).

    logps are under the (tempered, truncated) sampling distribution; for
    greedy they come from the untempered softmax (the rollout-side
    pi^FP8 convention of TIS).  `want_logp=False` skips the vocab-wide
    log_softmax and returns (tokens, None), as the serving engine asks.
    """
    logits = logits.float()
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        logits = sampling_logits(logits, temperature, top_k)
        tok = _categorical(logits, generator)
    if not want_logp:
        return tok, None
    logp = torch.log_softmax(logits, dim=-1)
    return tok, logp.gather(-1, tok[..., None])[..., 0]


def rejection_sample(target_logits: torch.Tensor, draft_tokens,
                     generator: Optional[torch.Generator],
                     temperature: float, top_k: int = 0):
    """Modified rejection sampling for a deterministic (one-hot q) drafter
    (port of `repro.core.sampling.rejection_sample`).

    target_logits (K+1, V): row i is the target's logits after the
    pending token (i = 0) or draft i-1; draft_tokens (K,).  Returns
    (tokens, n_accepted, logps): the accepted draft prefix plus one more
    token (the corrected resample at the first rejection, or the bonus
    token from the last row), and each emitted token's logprob under the
    target sampling distribution.  Greedy accepts a draft iff it is the
    row's argmax, so its output is bit-exact vs plain greedy decoding;
    temperature > 0 accepts draft d with probability p(d) and otherwise
    resamples from p with d removed, which leaves the output distributed
    exactly as the target.
    """
    k = len(draft_tokens)
    target_logits = target_logits.float()
    assert target_logits.dim() == 2 and target_logits.shape[0] >= k + 1, \
        (tuple(target_logits.shape), k)
    draft = [int(t) for t in draft_tokens]
    rows = target_logits[:k + 1]

    if temperature <= 0.0:
        greedy = torch.argmax(rows, dim=-1).tolist()
        tokens, n_accepted = [], 0
        for i in range(k):
            tokens.append(greedy[i])              # accepted or corrected
            if greedy[i] != draft[i]:
                break
            n_accepted += 1
        else:
            tokens.append(greedy[k])              # bonus token
        logp = torch.log_softmax(rows, dim=-1)
        logps = logp[torch.arange(len(tokens)), torch.tensor(tokens)].tolist()
        return tokens, n_accepted, logps

    logits_s = sampling_logits(rows, temperature, top_k)
    logp = torch.log_softmax(logits_s, dim=-1)
    probs = torch.exp(logp)
    tokens, n_accepted = [], 0
    for i in range(k):
        d = draft[i]
        u = torch.rand((), generator=generator, device=rows.device)
        if float(u) < float(probs[i, d]):         # one-hot q: accept w.p. p(d)
            tokens.append(d)
            n_accepted += 1
            continue
        residual = probs[i].clone()
        residual[d] = 0.0                         # p with the draft removed
        tokens.append(int(_categorical(torch.log(residual), generator)))
        break
    else:
        tokens.append(int(_categorical(logits_s[k], generator)))
    logps = logp[torch.arange(len(tokens)), torch.tensor(tokens)].tolist()
    return tokens, n_accepted, logps
