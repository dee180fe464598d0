"""Gradient tile-exceedance profiling (port of `repro.core.grad_profile`,
paper §2.4.3, "Gradient profiling").

The paper diagnoses the pure-E4M3 recipe's collapse by profiling
grad-output tensors: under *delayed scaling* (a scale predicted from an
earlier amax) tiles whose amax exceeds the predicted range clamp; under
*current scaling* small values in a tile with a huge amax flush to zero.
`tile_exceedance_stats` measures both, and the share of elements the cast
distorts by more than half; `grad_tap` captures the grad-output of a
tensor during the backward.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.precision import E4M3, E5M2, FP8_MAX
from repro_torch.core.quant import RECIP_FP8_MAX, dequantize, quantize_blockwise

_EPS = 1e-12
# smallest positive subnormal: E4M3 2^-9, E5M2 2^-16
_FP8_TINY = {E4M3: 2.0 ** -9, E5M2: 2.0 ** -16}


class TileStats(NamedTuple):
    exceed_frac: torch.Tensor     # tiles overflowing a delayed scale
    underflow_frac: torch.Tensor  # nonzero elements flushed to 0 (current scaling)
    loss_frac: torch.Tensor       # elements with > 50% relative error after the cast
    amax: torch.Tensor            # the tensor's amax (for delayed-scale updates)
    p99_tile_amax: torch.Tensor


def tile_exceedance_stats(g: torch.Tensor, fp8_dtype=E4M3, tile: int = 128,
                          ref_scale: Optional[torch.Tensor] = None) -> TileStats:
    """Profile one grad-output tensor in 1 x `tile` tiles along its last
    dim.  `ref_scale` models delayed scaling (e.g. the previous step's
    amax / fp8_max); None uses the tensor's own amax (pure current
    scaling: nothing exceeds, underflow still counts).  0-dim f32 tensors
    on g's device."""
    fmax, recip = FP8_MAX[fp8_dtype], RECIP_FP8_MAX[fp8_dtype]
    n = g.shape[-1]
    g2 = g.float().reshape(-1, n).abs()
    m = g2.shape[0]
    nt = -(-n // tile)
    tiles = F.pad(g2, (0, nt * tile - n)).reshape(m, nt, tile)
    tile_amax = tiles.amax(dim=-1)                                   # (m, nt)
    amax = tile_amax.max()
    # `/ fmax` as the compiled reference computes it (see core.quant)
    scale_ref = amax * recip if ref_scale is None else ref_scale
    exceed = tile_amax > (scale_ref * fmax) * (1 + 1e-6)
    # current per-tile scaling: values below tiny * scale flush to zero
    thresh = torch.clamp_min(tile_amax, _EPS) * recip * (_FP8_TINY[fp8_dtype] / 2.0)
    nonzero = tiles > 0
    under = nonzero & (tiles < thresh[..., None])
    underflow_frac = under.sum() / torch.clamp_min(nonzero.sum(), 1)
    # material distortion after the actual cast
    qt = quantize_blockwise(g.reshape(-1, n), (1, min(tile, n)), fp8_dtype)
    deq = dequantize(qt, torch.float32).abs()
    src = g.float().reshape(m, -1).abs()
    rel = (deq - src).abs() / torch.clamp_min(src, _EPS)
    loss = (src > 0) & (rel > 0.5)
    loss_frac = loss.sum() / torch.clamp_min((src > 0).sum(), 1)
    return TileStats(
        exceed_frac=exceed.float().mean(),
        underflow_frac=underflow_frac.float(),
        loss_frac=loss_frac.float(),
        amax=amax,
        p99_tile_amax=torch.quantile(tile_amax.reshape(-1), 0.99),
    )


class _GradTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps, name):
        ctx.taps, ctx.name = taps, name
        taps[name] = torch.zeros_like(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.taps[ctx.name] = ctx.taps[ctx.name] + g
        return g, None, None


def grad_tap(x: torch.Tensor, taps: dict, name: str) -> torch.Tensor:
    """Identity on `x` that records its grad-output: after the backward
    `taps[name]` is dL/dx (summed over every use of `name` in the
    forward), the paper's grad-output tensor.  The forward puts zeros
    there.  The reference adds a zero tap and differentiates with respect
    to it; eager autograd records the gradient instead.

        y = grad_tap(linear(x, w), taps, f"layer{i}.fc1")
    """
    return _GradTap.apply(x, taps, name)
