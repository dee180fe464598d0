"""Mixture-of-Experts layer with precision-controlled routing (port of
`repro.models.moe`, paper §2.2.4).

Router precision is the paper's MoE-specific knob: the router weight's
dtype is set at weight sync (`core.fp8_params._router_cast`: bf16, f32, or
E4M3 under the FP8 ablation) and the logits are computed in it.

Rollout Router Replay (RRR): `moe_forward` returns the chosen expert
indices in its aux dict, and takes them back as `forced_topk_idx` (gate
values are then recomputed from this pass's router).

Dispatch is sort/gather-based, as the reference's: tokens are grouped
(one group per batch row for sequences, one group for decode), each group
sorts its (token, k) units by expert (a stable sort) and gathers the first
`capacity` units per expert into an (E, G·C, D) batch; units past the
capacity are dropped.  The experts' SwiGLU runs through `core.fp8_linear`
on the stacked (E, K, N) weights: under W8A8 one kernel-1 launch over all
E·G·C rows and one expert-batched kernel-3 launch per expert linear.
Every op here is deterministic (sorts, integer counts, gathers and
scatters to distinct slots), so a checkpointed layer's recompute routes
as its forward did.  Top-k ranks with a stable descending sort, so equal
probabilities rank the lower expert first, as `jax.lax.top_k` does
(`torch.topk` promises no order among ties).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fp8_linear import _dot, linear
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quant import QuantizedTensor, dequantize
from repro_torch.models.mlp import _ACT


def init_moe_params(dense, ones, cfg, repeats: int):
    """The reference's `init_moe_params` stacked over `repeats` layers:
    yields (name, leaf) in draw order, one leaf at a time.  `dense(shape,
    fan_in, dtype=None)` draws a normal x fan_in^-0.5 leaf (the model's
    dtype when None), `ones(*shape)` a norm scale.  The router is bf16
    whatever the model's dtype, as in the reference."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    yield "router", dense((repeats, d, e), d, torch.bfloat16)
    yield "fc1", dense((repeats, e, d, 2 * f), d)       # fused gate | up
    yield "fc2", dense((repeats, e, f, d), f)
    yield "norm_scale", ones(repeats, d)


def group_capacity(tokens_per_group: int, cfg) -> int:
    """Slots per expert and group: tokens x top_k / E x capacity_factor,
    at least top_k, rounded up to a multiple of 8 from 8 on."""
    c = int(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    c = max(c, cfg.top_k)
    return -(-c // 8) * 8 if c >= 8 else c


def router_logits(x: torch.Tensor, router_w) -> torch.Tensor:
    """(N, D) -> (N, E) f32 logits in the router weight's precision: a
    bf16 dot (f32 sums, rounded to bf16), an f32 matmul, or the FP8 router
    dequantized to bf16 first (its K-major storage is padded to 128
    columns; the (D, E) view dequantizes to E columns)."""
    if isinstance(router_w, QuantizedTensor):
        w = dequantize(router_w, torch.bfloat16)
        return _dot(x.to(torch.bfloat16), w).float()
    if router_w.dtype == torch.float32:
        return x.float() @ router_w
    return _dot(x.to(router_w.dtype), router_w).float()


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, ties to the lower
    index (`jax.lax.top_k`'s order), on the CPU and on the card."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(topk_idx: torch.Tensor, cap: int, n_experts: int):
    """The reference's `_dispatch_one_group` for every group at once.

    topk_idx (G, n, K) -> token_for_slot (G, E·C) (index into [0, n], n
    the padding row), flat_for_unit (G, n·K) (index into [0, E·C], E·C
    the dropped sentinel), keep (G, n·K) bool."""
    g, n, k_top = topk_idx.shape
    u = n * k_top
    dev = topk_idx.device
    unit_expert = topk_idx.reshape(g, u)
    order = torch.sort(unit_expert, dim=-1, stable=True).indices
    counts = torch.zeros((g, n_experts), dtype=torch.long, device=dev)
    counts.scatter_add_(1, unit_expert, torch.ones_like(unit_expert))
    starts = torch.cumsum(counts, dim=1) - counts
    arange_u = torch.arange(u, device=dev).expand(g, u)
    slot_sorted = arange_u - torch.gather(starts, 1, torch.gather(unit_expert, 1, order))
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = slot < cap
    flat = torch.where(keep, unit_expert * cap + slot, n_experts * cap)
    token_for_slot = torch.full((g, n_experts * cap + 1), n, dtype=torch.long, device=dev)
    # kept units own distinct slots; every dropped one writes the same n
    # into the sentinel column, which is cut off
    token_for_slot.scatter_(1, flat, torch.where(keep, arange_u // k_top, n))
    return token_for_slot[:, :-1], flat, keep


def moe_forward(x: torch.Tensor, params: dict, cfg,
                precision: Optional[PrecisionConfig] = None, *,
                forced_topk_idx: Optional[torch.Tensor] = None):
    """x (B, T, D) -> (out (B, T, D) in x.dtype, aux).  aux holds the
    reference's keys: `topk_idx` (B, T, K) int32, `router_entropy`,
    `dropped_frac`, `aux_loss` (the load-balancing loss, E x sum(load x
    importance)) and `router_logits_amax`, each a 0-dim f32."""
    b, t, d = x.shape
    e, k_top = cfg.n_experts, cfg.top_k
    g = b if t > 1 else 1
    n_g = (b * t) // g
    cap = group_capacity(n_g, cfg)
    xg = x.reshape(g, n_g, d)

    logits = router_logits(xg.reshape(-1, d), params["router"])      # (N, E)
    probs = torch.softmax(logits, dim=-1)
    if forced_topk_idx is not None:
        topk_idx = forced_topk_idx.to(x.device).reshape(-1, k_top).long()
        topk_p = torch.gather(probs, 1, topk_idx)
    else:
        topk_p, topk_idx = top_k(probs, k_top)                       # (N, K)
    gates = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)

    token_for_slot, flat_for_unit, keep = _dispatch(
        topk_idx.reshape(g, n_g, k_top), cap, e)
    rows = torch.arange(g, device=x.device)[:, None]
    x_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    expert_in = x_pad[rows, token_for_slot]                           # (G, E·C, D)
    expert_in = expert_in.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)

    h = _expert_ffn(expert_in, params, cfg, precision)               # (E, G·C, D)

    h = h.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    h_pad = torch.cat([h, h.new_zeros((g, 1, d))], dim=1)
    h_unit = h_pad[rows, flat_for_unit].reshape(g, n_g, k_top, d)
    w_unit = (gates * keep.reshape(-1, k_top)).reshape(g, n_g, k_top, 1)
    out = torch.sum(h_unit.float() * w_unit, dim=2)                   # (G, n_g, D)

    # as the compiled reference: 1 - kept x f32(1 / units) in one fused
    # multiply-add (exact in f64), rounded once to f32
    recip = float(np.float32(1) / np.float32(b * t * k_top))
    dropped = (1.0 - keep.sum().double() * recip).float()
    # counts by scatter (bincount would wait for the card to size its output)
    load = torch.zeros((e,), dtype=torch.float32, device=x.device).scatter_add_(
        0, topk_idx.reshape(-1), torch.ones(topk_idx.numel(), device=x.device))
    load = load / torch.clamp_min(load.sum(), 1.0)
    importance = probs.mean(dim=0)
    aux = {
        "topk_idx": topk_idx.reshape(b, t, k_top).to(torch.int32),
        "router_entropy": -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), -1)),
        "dropped_frac": dropped,
        "aux_loss": e * torch.sum(load * importance),
        "router_logits_amax": logits.abs().max(),
    }
    return out.reshape(b, t, d).to(x.dtype), aux


def _expert_ffn(expert_in: torch.Tensor, params: dict, cfg,
                precision: Optional[PrecisionConfig]) -> torch.Tensor:
    """Per-expert SwiGLU with fused fc1 = [gate | up] over the stacked
    experts: (E, M, D) -> (E, M, D), every expert's M rows (padding rows
    included) in one call per linear."""
    act = _ACT[cfg.act]
    gu = linear(expert_in, params["fc1"], precision=precision)       # (E, M, 2F)
    gate, up = torch.chunk(gu, 2, dim=-1)
    return linear(act(gate) * up, params["fc2"], precision=precision)
