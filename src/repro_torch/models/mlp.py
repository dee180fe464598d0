"""The MLP with FP8-aware linears (port of `repro.models.mlp`): gated
(SwiGLU, 3 matrices) or classic (2 matrices, starcoder2's gelu), with the
reference's activations.

The activations round as the reference's compiled ones do in bf16: one
rounding to x.dtype after each op, constants rounded to x.dtype first
(JAX's weak-typed Python floats take the array's dtype; torch would
multiply a bf16 tensor by the f32 constant).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.fp8_linear import linear, linears
from repro_torch.core.precision import PrecisionConfig
from repro_torch.models.common import constrain


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * 1 / (1 + exp(-x)), one rounding to x.dtype after each op — how
    the reference's compiled `jax.nn.silu` evaluates in bf16 (a fused
    f32 silu rounds once and differs from it in many elements)."""
    return x * (1.0 / (torch.exp(-x) + 1.0))


_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, `jax.nn.gelu(approximate=True)`:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))), each op
    rounded to x.dtype.  Bit-equal to the jitted reference for every bf16
    input of magnitude 1e-30 or more; below, the reference flushes
    subnormal intermediates to zero and the two differ by under 1e-38."""
    c = torch.tensor(_SQRT_2_OVER_PI, dtype=x.dtype).item()
    k = torch.tensor(0.044715, dtype=x.dtype).item()
    inner = x + k * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(c * inner)))


_ACT = {"silu": _silu, "gelu": _gelu, "relu": torch.relu}


def mlp_forward(x: torch.Tensor, params: dict, cfg,
                precision: Optional[PrecisionConfig] = None) -> torch.Tensor:
    act = _ACT[cfg.act]
    if cfg.mlp_gated:   # gate and up share one quantization of x
        g, u = linears(x, (params["wg"], params["wu"]), precision=precision)
        h = act(g) * u
    else:
        h = act(linear(x, params["wg"], precision=precision))
    h = constrain(h, "act_btf")
    return linear(h, params["wd"], precision=precision)
