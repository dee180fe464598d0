"""Step builders and input specs for prefill and decode (port of
`repro.launch.steps`, the serving half).

    prefill_step(params, batch)      -> (last_logits, cache)
    serve_step(params, tokens, cache) -> (logits, cache)

Both run the contiguous-cache path of `models.Transformer` on CUDA unless
given a device: the prefill fills a cache of seq_len + 1 positions and
returns only the last-position logits; each serve step appends one token
and attends through kernel 6 (`fp8_decode_attention`).  They are eager,
like the paged path (no `torch.compile`, no CUDA graph).  A serve step
whose write would land past the cache raises a `ValueError` on the host
before any launch (the reference's XLA scatter drops it silently).

`input_specs`, `cache_specs` and `param_specs` are the counterpart of the
reference's `ShapeDtypeStruct` stand-ins: tensors on the "meta" device,
with shapes and dtypes and no storage.  The port runs dense and MoE text
decoders, so there are no frontend specs.  `make_train_step` and
`make_opt_specs` (the TRAIN_4K cell's step) are not ported yet; the RL
trainer's update is `rl.RLTrainer.update_fn` (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import fp8_params
from repro_torch.core.precision import E4M3, PrecisionConfig, RouterDtype
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.transformer import Transformer

META = torch.device("meta")


def _text_only(cfg: ArchConfig) -> None:
    if cfg.frontend is not None or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: frontends and encoder-decoders are not ported "
            "(ROADMAP queue 1)")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Model inputs of one cell as meta tensors: train and prefill take
    tokens (B, S) (prefill also lengths (B,)); decode one token (B,)
    against a cache of seq_len."""
    _text_only(cfg)
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    if shape.kind == "train":
        return {"tokens": torch.empty((b, s), **i32)}
    if shape.kind == "prefill":
        return {"tokens": torch.empty((b, s), **i32),
                "lengths": torch.empty((b,), **i32)}
    return {"tokens": torch.empty((b,), **i32)}


def cache_specs(cfg: ArchConfig, shape: ShapeConfig,
                precision: PrecisionConfig) -> dict:
    """The contiguous rollout cache of a cell (S_max = seq_len) on meta."""
    _text_only(cfg)
    return Transformer(cfg, META).init_cache(shape.global_batch, shape.seq_len,
                                             precision)


def param_specs(cfg: ArchConfig, precision: Optional[PrecisionConfig] = None) -> dict:
    """Param shapes on meta; with `precision`, the rollout tree that
    `core.fp8_params.quantize_params` makes: the linears it quantizes
    (E4M3 payload, f32 scales per 128x128 block) when `precision`
    quantizes them, and an MoE router in the router dtype (E4M3 blocks
    under the FP8 router)."""
    specs = Transformer(cfg, META).init_params(0)
    if precision is None:
        return specs

    def blocks(leaf):
        *lead, k, n = leaf.shape
        scales = torch.empty((*lead, -(-k // 128), -(-n // 128)), dtype=torch.float32,
                             device=META)
        return QuantizedTensor(torch.empty(leaf.shape, dtype=E4M3, device=META), scales,
                               (1,) * len(lead) + (128, 128))

    def rollout(path, leaf):
        if "router" in path:
            if precision.router_dtype == RouterDtype.FP8:
                return blocks(leaf)
            dtype = torch.float32 if precision.router_dtype == RouterDtype.FP32 \
                else torch.bfloat16
            return torch.empty(leaf.shape, dtype=dtype, device=META)
        if precision.quantize_linears and fp8_params.default_quant_filter(path, leaf):
            return blocks(leaf)
        return leaf

    return fp8_params._map_with_path(rollout, specs)


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig,
                      precision: PrecisionConfig, device=None):
    """Prompt processing into a fresh contiguous cache of seq_len + 1
    positions; returns only the last-position logits (B, V) f32 and the
    cache."""
    model = Transformer(cfg, device)
    b, s = shape.global_batch, shape.seq_len

    def prefill_step(params, batch):
        cache = model.init_cache(b, s + 1, precision)
        return model.prefill(params, batch, cache, precision)

    return prefill_step


def make_serve_step(cfg: ArchConfig, precision: PrecisionConfig, device=None):
    """One decode token (B,) against an existing contiguous cache, through
    kernel 6 on the card (its plain version on the CPU)."""
    model = Transformer(cfg, device)

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache, precision)

    return serve_step
