"""Layer-pattern assembly (port of `repro.models.blocks`).

A model is `n_layers = R * len(pattern)` layers; params and caches are
stacked over the R repeats, as in the reference, and the port walks them
with a Python loop where the reference scans.  Attention slots with an
MLP (the dense decoder) or an MoE layer are ported; SSM and
cross-attention slots raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import rms_norm


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    mixer: str                 # "attn" | "ssm"
    ffn: Optional[str]         # "mlp" | "moe" | None
    cross: bool = False        # enc-dec decoder slot


def layer_pattern(cfg, decoder: bool = True) -> Tuple[SlotSpec, ...]:
    period = 1
    if cfg.attn_period > 1:
        period = cfg.attn_period
    if cfg.n_experts and cfg.moe_period > 1:
        period = math.lcm(period, cfg.moe_period)
    n = cfg.n_layers if decoder else cfg.n_enc_layers
    assert n % period == 0, (n, period, cfg.name)
    slots = []
    for j in range(period):
        if cfg.attention_free or (cfg.ssm_state and not cfg.is_attn_layer(j)):
            mixer = "ssm"
        else:
            mixer = "attn"
        if cfg.family == "ssm":
            ffn = None
        elif cfg.is_moe_layer(j):
            ffn = "moe"
        else:
            ffn = "mlp"
        slots.append(SlotSpec(mixer=mixer, ffn=ffn,
                              cross=decoder and cfg.is_encdec))
    return tuple(slots)


def n_repeats(cfg, decoder: bool = True) -> int:
    n = cfg.n_layers if decoder else cfg.n_enc_layers
    return n // len(layer_pattern(cfg, decoder))


def check_supported(spec: SlotSpec) -> None:
    """The port runs attention slots with an MLP or an MoE layer
    (ROADMAP queue 1)."""
    if spec.mixer != "attn" or spec.ffn not in ("mlp", "moe") or spec.cross:
        raise NotImplementedError(
            f"slot {spec} is not ported yet: SSM and cross-attention "
            "wait for the model-breadth item of ROADMAP queue 1")


def _ffn(x, slot_params, spec: SlotSpec, cfg, precision, forced_topk=None):
    """The slot's MLP or MoE layer on its pre-norm input, residual added:
    (x, aux), aux the MoE layer's (`moe.moe_forward`) or empty."""
    if spec.ffn == "moe":
        p = slot_params["moe"]
        h, aux = moe_mod.moe_forward(rms_norm(x, p["norm_scale"], cfg.norm_eps), p, cfg,
                                     precision, forced_topk_idx=forced_topk)
        return x + h, aux
    p = slot_params["mlp"]
    return x + mlp_mod.mlp_forward(rms_norm(x, p["norm_scale"], cfg.norm_eps),
                                   p, cfg, precision), {}


def apply_slot_full(x, slot_params, spec: SlotSpec, cfg, precision, *,
                    kv_cache=None, positions=None, lengths=None, mask=None,
                    block_tables=None, chunk_start=None,
                    use_kernel: bool = False,
                    live_blocks: Optional[int] = None, forced_topk=None):
    """Full-sequence branch of the reference's `apply_slot_full`, then the
    MLP or MoE layer (`forced_topk` (B, T, K) replays an MoE routing).
    Without `kv_cache` (training / scoring): cache-free attention
    under `mask` (`attention.attention_forward`).  With a cache: prefill
    attention over the prompt, writing the cache (a contiguous `KVCache`,
    or a pool through `block_tables`) — or, with `chunk_start`, over one
    chunk of it at [chunk_start, chunk_start + C) of a pool (`use_kernel`
    and `live_blocks` as in `attention_prefill_chunk`).  Returns (x, aux),
    aux the MoE layer's or empty."""
    p = slot_params["attn"]
    xn = rms_norm(x, p["norm_scale"], cfg.norm_eps)
    if kv_cache is None:
        h = attn_mod.attention_forward(xn, p, cfg, precision,
                                       positions=positions, mask=mask,
                                       lengths=lengths)
    elif chunk_start is not None:
        h = attn_mod.attention_prefill_chunk(
            xn, p, cfg, kv_cache, precision, start=chunk_start,
            lengths=lengths, block_tables=block_tables,
            live_blocks=live_blocks, use_kernel=use_kernel)
    else:
        h = attn_mod.attention_prefill(
            xn, p, cfg, kv_cache, precision, lengths=lengths,
            positions=positions, block_tables=block_tables)
    return _ffn(x + h, slot_params, spec, cfg, precision, forced_topk)


def apply_slot_decode(x, slot_params, spec: SlotSpec, cfg, precision, *,
                      kv_cache, lengths, block_tables=None,
                      use_kernel: Optional[bool] = None,
                      live_blocks: Optional[int] = None, forced_topk=None):
    """One-token decode through the slot: attention through kernel 6 (a
    contiguous `KVCache`, no `block_tables`) or kernel 4 (a pool), or with
    `use_kernel` off through the reference's full-cache path or the gather
    of `live_blocks` table entries (None: `attention.attention_decode`'s
    default); then the MLP or MoE layer.  Returns (x, aux)."""
    p = slot_params["attn"]
    xn = rms_norm(x, p["norm_scale"], cfg.norm_eps)
    x = x + attn_mod.attention_decode(xn, p, cfg, kv_cache, lengths,
                                      precision, block_tables=block_tables,
                                      use_kernel=use_kernel,
                                      live_blocks=live_blocks)
    return _ffn(x, slot_params, spec, cfg, precision, forced_topk)
