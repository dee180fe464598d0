"""Layer-pattern assembly (port of `repro.models.blocks`).

A model is `n_layers = R * len(pattern)` layers; params and caches are
stacked over the R repeats, as in the reference, and the port walks them
with a Python loop where the reference scans.  A slot's mixer is
attention or an SSM (Mamba2) layer, its FFN an MLP, an MoE layer or none
(mamba2); an enc-dec decoder's slots also attend over the encoder
(`cross`), between the mixer and the FFN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import constrain, rms_norm


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


def _ffn(x, slot_params, spec: SlotSpec, cfg, precision, forced_topk=None):
    """The slot's MLP or MoE layer on its pre-norm input, residual added:
    (x, aux), aux the MoE layer's (`moe.moe_forward`) or empty; x as it
    is for a slot without one (mamba2)."""
    if spec.ffn is None:
        return x, {}
    if spec.ffn == "moe":
        p = slot_params["moe"]
        h, aux = moe_mod.moe_forward(rms_norm(x, p["norm_scale"], cfg.norm_eps), p, cfg,
                                     precision, forced_topk_idx=forced_topk)
        return x + h, aux
    p = slot_params["mlp"]
    return x + mlp_mod.mlp_forward(rms_norm(x, p["norm_scale"], cfg.norm_eps),
                                   p, cfg, precision), {}


def _ssm_full(x, slot_params, cfg, precision, ssm_state, lengths, chunk_start):
    """The SSM mixer over a sequence, residual added.  With `ssm_state`
    (a cache layer's, prefill or a chunk of it) it runs from that state
    and writes the new one into it in place; padded positions are state
    no-ops: `lengths` counts the valid tokens, so inside a chunk starting
    at `chunk_start` the valid region is its first lengths - chunk_start
    positions."""
    p = slot_params["ssm"]
    xn = rms_norm(x, p["norm_scale"], cfg.norm_eps)
    if ssm_state is None:
        h, _ = ssm_mod.ssm_forward(xn, p, cfg, precision)
        return x + h
    ssm_lengths = None
    if lengths is not None:
        ssm_lengths = lengths - chunk_start if chunk_start is not None else lengths
    h, new = ssm_mod.ssm_forward(xn, p, cfg, precision, state=ssm_state,
                                 return_state=True, lengths=ssm_lengths)
    ssm_state.copy_(new)
    return x + h


def _cross(x, slot_params, spec: SlotSpec, cfg, precision, cross_cache, src_lengths,
           enc_out):
    """The enc-dec decoder slot's cross attention, residual added: over
    the encoder output `enc_out` (training: keys past `src_lengths`
    masked), or over the layer's quantized `cross_cache`; x as it is for a
    slot without one, or with neither source."""
    if not spec.cross or (enc_out is None and cross_cache is None):
        return x
    p = slot_params["cross"]
    xn = rms_norm(x, p["norm_scale"], cfg.norm_eps)
    if cross_cache is not None:
        return x + attn_mod.cross_attention_decode(xn, p, cfg, cross_cache, src_lengths,
                                                   precision)
    src_mask = None
    if src_lengths is not None:
        k_pos = torch.arange(enc_out.shape[1], device=x.device)
        src_mask = (k_pos[None, :] < src_lengths.to(x.device)[:, None])[:, None, :]
    return x + attn_mod.attention_forward(xn, p, cfg, precision, mask=src_mask,
                                          causal=False, kv_src=enc_out, use_rope=False)


def apply_slot_full(x, slot_params, spec: SlotSpec, cfg, precision, *,
                    kv_cache=None, ssm_state=None, positions=None,
                    lengths=None, mask=None, causal: bool = True, prefix_len: int = 0,
                    block_tables=None, chunk_start=None, use_kernel: bool = False,
                    live_blocks: Optional[int] = None, forced_topk=None,
                    cross_cache=None, src_lengths=None, enc_out=None):
    """Full-sequence branch of the reference's `apply_slot_full`: the
    mixer, the cross attention of an enc-dec decoder slot (`_cross`), then
    the MLP or MoE layer (`forced_topk` (B, T, K) replays an MoE routing).
    Without a cache (training / scoring / the encoder): cache-free
    attention under `mask` (`attention.attention_forward`, bidirectional
    with `causal=False`; `prefix_len` keys visible to all under the
    chunked impl), or the SSM mixer from a zero state.  With a cache:
    prefill attention over the prompt, writing the cache (a contiguous
    `KVCache`, or a pool through `block_tables`) — or, with `chunk_start`,
    over one chunk of it at [chunk_start, chunk_start + C) of a pool
    (`use_kernel` and `live_blocks` as in `attention_prefill_chunk`); an
    SSM slot runs from its `ssm_state` and writes the new state into it.
    Returns (x, aux), aux the MoE layer's or empty."""
    if spec.mixer == "ssm":
        x = _ssm_full(x, slot_params, cfg, precision, ssm_state, lengths, chunk_start)
        x = _cross(x, slot_params, spec, cfg, precision, cross_cache, src_lengths, enc_out)
        x, aux = _ffn(x, slot_params, spec, cfg, precision, forced_topk)
        return constrain(x, "act_btd"), aux
    p = slot_params["attn"]
    xn = rms_norm(x, p["norm_scale"], cfg.norm_eps)
    if kv_cache is None:
        h = attn_mod.attention_forward(xn, p, cfg, precision,
                                       positions=positions, mask=mask, causal=causal,
                                       prefix_len=prefix_len, lengths=lengths)
    elif chunk_start is not None:
        h = attn_mod.attention_prefill_chunk(
            xn, p, cfg, kv_cache, precision, start=chunk_start,
            lengths=lengths, block_tables=block_tables,
            live_blocks=live_blocks, use_kernel=use_kernel)
    else:
        h = attn_mod.attention_prefill(
            xn, p, cfg, kv_cache, precision, lengths=lengths,
            positions=positions, block_tables=block_tables)
    x = _cross(x + h, slot_params, spec, cfg, precision, cross_cache, src_lengths, enc_out)
    x, aux = _ffn(x, slot_params, spec, cfg, precision, forced_topk)
    return constrain(x, "act_btd"), aux


def apply_slot_decode(x, slot_params, spec: SlotSpec, cfg, precision, *,
                      kv_cache=None, ssm_state=None, lengths=None,
                      block_tables=None, use_kernel: Optional[bool] = None,
                      live_blocks: Optional[int] = None, forced_topk=None,
                      cross_cache=None, src_lengths=None):
    """One-token decode through the slot: attention through kernel 6 (a
    contiguous `KVCache`, no `block_tables`) or kernel 4 (a pool), or with
    `use_kernel` off through the reference's full-cache path or the gather
    of `live_blocks` table entries (None: `attention.attention_decode`'s
    default); or the SSM mixer's recurrent step, which writes the new
    state into `ssm_state` in place; then an enc-dec slot's cross
    attention over its `cross_cache` (plain, as the reference's), then the
    MLP or MoE layer.  Returns (x, aux)."""
    if spec.mixer == "ssm":
        p = slot_params["ssm"]
        h, new = ssm_mod.ssm_decode(rms_norm(x, p["norm_scale"], cfg.norm_eps), p, cfg,
                                    ssm_state, precision)
        ssm_state.copy_(new)
        x = x + h
    else:
        p = slot_params["attn"]
        xn = rms_norm(x, p["norm_scale"], cfg.norm_eps)
        x = x + attn_mod.attention_decode(xn, p, cfg, kv_cache, lengths,
                                          precision, block_tables=block_tables,
                                          use_kernel=use_kernel,
                                          live_blocks=live_blocks)
    x = _cross(x, slot_params, spec, cfg, precision, cross_cache, src_lengths, None)
    return _ffn(x, slot_params, spec, cfg, precision, forced_topk)
