"""Gated MLP (SwiGLU) with FP8-aware linears (port of `repro.models.mlp`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fp8_linear import linear, linears
from repro_torch.core.precision import PrecisionConfig


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * 1 / (1 + exp(-x)), one rounding to x.dtype after each op — how
    the reference's compiled `jax.nn.silu` evaluates in bf16 (a fused
    f32 silu rounds once and differs from it in many elements)."""
    return x * (1.0 / (torch.exp(-x) + 1.0))


_ACT = {"silu": _silu}


def mlp_forward(x: torch.Tensor, params: dict, cfg,
                precision: Optional[PrecisionConfig] = None) -> torch.Tensor:
    act = _ACT[cfg.act]
    if cfg.mlp_gated:   # gate and up share one quantization of x
        g, u = linears(x, (params["wg"], params["wu"]), precision=precision)
        h = act(g) * u
    else:
        h = act(linear(x, params["wg"], precision=precision))
    return linear(h, params["wd"], precision=precision)
