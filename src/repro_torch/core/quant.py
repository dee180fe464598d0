"""Blockwise FP8 quantization (port of `repro.core.quant`).

Weights: per-128x128-block scales; activations: per-1x128-row-tile scales;
per-tensor scales for the KV cache.  Scales are `max(amax, 1e-12)/fp8_max`
in FP32 (the division folded into a multiply by f32(1/fp8_max), as the
compiled reference does), or UE8M0 (2^ceil(log2 s)).  Every cast clips first
(`saturating_cast`).  Trailing blocks that do not fill 128 are reduced
over zero padding, which never wins the amax; scales are ceil-shaped.

These are the plain PyTorch spellings of the reference's jnp functions
and hold the payload bits and scales of their compiled form exactly.  The CUDA quantizers of the
hot path live in `repro_torch.kernels`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.precision import (
    ACT_BLOCK,
    E4M3,
    FP8_MAX,
    WEIGHT_BLOCK,
    ScaleFormat,
)

_EPS = 1e-12


_LN2 = 0.6931471805599453


def exp2_like_reference(e: torch.Tensor) -> torch.Tensor:
    """2**e the way `jnp.exp2` computes it: exp(f32(ln 2) * e).  That is
    not always an exact power of two, and the reference's UE8M0 scales
    are made this way, so the port's are too."""
    return torch.exp(e.float() * _LN2)


def encode_scale(scale: torch.Tensor, scale_format: ScaleFormat) -> torch.Tensor:
    """FP32 as is; UE8M0 rounds *up* to the next power of two."""
    if scale_format == ScaleFormat.FP32:
        return scale.float()
    exp = torch.ceil(torch.log2(torch.clamp_min(scale, _EPS)))
    return exp2_like_reference(exp)


# f32(1 / fp8_max).  The reference's `max(amax, eps) / fp8_max` runs
# compiled (jit, scan bodies, Pallas), where XLA folds the division by a
# constant into a multiply by this reciprocal; its scales are therefore
# amax * f32(1/fp8_max), not the IEEE quotient, and so are the port's.
RECIP_FP8_MAX = {dt: float(np.float32(1.0) / np.float32(m))
                 for dt, m in FP8_MAX.items()}


def _amax_to_scale(amax: torch.Tensor, fp8_dtype, scale_format: ScaleFormat):
    scale = torch.clamp_min(amax, _EPS) * RECIP_FP8_MAX[fp8_dtype]
    return encode_scale(scale, scale_format)


def saturating_cast(x: torch.Tensor, fp8_dtype) -> torch.Tensor:
    """Clip-then-cast; the clip provides the saturation."""
    m = FP8_MAX[fp8_dtype]
    return torch.clamp(x.float(), -m, m).to(fp8_dtype)


class QuantizedTensor(NamedTuple):
    """An fp8 tensor plus its block scales.

    `data`   — fp8 tensor, same shape as the source.
    `scales` — f32 scales, ceil(shape/block) per blocked axis.
    `block`  — per-axis block sizes (1 = per element axis).
    """

    data: torch.Tensor
    scales: torch.Tensor
    block: tuple

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def layer(self, r: int) -> "QuantizedTensor":
        """Slice `r` of a layer-stacked tensor (views, no copy)."""
        return QuantizedTensor(self.data[r], self.scales[r], self.block[1:])


def _block_amax(x: torch.Tensor, block: tuple) -> torch.Tensor:
    """Per-block max(|x|); shapes not divisible by the block are padded."""
    assert len(block) == x.dim(), (block, x.shape)
    ax = x.float().abs()
    pads = []
    for dim, blk in zip(reversed(x.shape), reversed(block)):
        pads.extend((0, (-dim) % blk))
    if any(pads):
        ax = F.pad(ax, pads)  # zeros never win the max
    new_shape, reduce_axes = [], []
    for i, (dim, blk) in enumerate(zip(ax.shape, block)):
        new_shape.extend((dim // blk, blk))
        reduce_axes.append(2 * i + 1)
    return ax.reshape(new_shape).amax(dim=tuple(reduce_axes))


def _broadcast_scales(scales: torch.Tensor, shape, block: tuple) -> torch.Tensor:
    """Expand per-block scales to elementwise, cropped to `shape`."""
    out = scales
    for i, blk in enumerate(block):
        if blk != 1:
            out = torch.repeat_interleave(out, blk, dim=i)
    return out[tuple(slice(0, d) for d in shape)]


def quantize_blockwise(x: torch.Tensor, block: tuple, fp8_dtype=E4M3,
                       scale_format: ScaleFormat = ScaleFormat.FP32
                       ) -> QuantizedTensor:
    """Quantize with one scale per `block` region (any rank)."""
    amax = _block_amax(x, block)
    scales = _amax_to_scale(amax, fp8_dtype, scale_format)
    full = _broadcast_scales(scales, x.shape, block)
    q = saturating_cast(x.float() / full, fp8_dtype)
    return QuantizedTensor(q, scales, tuple(block))


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    block = qt.block[len(qt.block) - qt.data.dim():]
    full = _broadcast_scales(qt.scales, qt.data.shape, block)
    return (qt.data.float() * full).to(dtype)


def quantize_weight(w: torch.Tensor, fp8_dtype=E4M3,
                    scale_format: ScaleFormat = ScaleFormat.FP32,
                    block_size: int = WEIGHT_BLOCK) -> QuantizedTensor:
    """128x128 blocks over the last two dims; leading (layer-stacked) dims
    get blocks of 1."""
    assert w.dim() >= 2, "weight quantization expects a matrix"
    block = (1,) * (w.dim() - 2) + (block_size, block_size)
    return quantize_blockwise(w, block, fp8_dtype, scale_format)


def quantize_activation(x: torch.Tensor, fp8_dtype=E4M3,
                        scale_format: ScaleFormat = ScaleFormat.FP32,
                        block_size: int = ACT_BLOCK) -> QuantizedTensor:
    """Dynamic 1x128 tiles along the contraction (last) dim."""
    block = (1,) * (x.dim() - 1) + (block_size,)
    return quantize_blockwise(x, block, fp8_dtype, scale_format)


def qdq(x: torch.Tensor, block: tuple | None = None, fp8_dtype=E4M3,
        scale_format: ScaleFormat = ScaleFormat.FP32) -> torch.Tensor:
    """Quantize-dequantize: the fp8 values of `x` in its own dtype (1x128
    tiles along the last dim unless `block` says otherwise).  The payload
    and scales are the reference's; the dequantize multiplies in f32 and
    rounds once to x.dtype.  "Full FP8" attention quantizes q, k, v and P
    through it; nothing differentiates through it (`fp8_dot` has its own
    backward)."""
    if block is None:
        block = (1,) * (x.dim() - 1) + (ACT_BLOCK,)
    return dequantize(quantize_blockwise(x, block, fp8_dtype, scale_format), x.dtype)


def qdq_weight(x: torch.Tensor, scale_format: ScaleFormat = ScaleFormat.FP32,
               fp8_dtype=E4M3) -> torch.Tensor:
    """`qdq` over 128x128 weight blocks (leading dims blocks of 1)."""
    return dequantize(quantize_weight(x, fp8_dtype, scale_format), x.dtype)


# ---------------------------------------------------------------------------
# Per-tensor quantization (KV-cache scales, paper §2.3)
# ---------------------------------------------------------------------------

def quantize_per_tensor(x: torch.Tensor, scale: torch.Tensor,
                        fp8_dtype=E4M3) -> torch.Tensor:
    return saturating_cast(x.float() / scale, fp8_dtype)


def dequantize_per_tensor(q: torch.Tensor, scale: torch.Tensor,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Like the reference: the scale is rounded to the target dtype and the
    multiply happens in it (bf16 here), not in f32."""
    if dtype != torch.float32:
        return q.to(dtype) * scale.float().to(dtype)
    return (q.float() * scale).to(dtype)


def calibrate_scale(amax: torch.Tensor, fp8_dtype=E4M3,
                    scale_format: ScaleFormat = ScaleFormat.FP32,
                    margin: float = 1.0) -> torch.Tensor:
    """amax -> scale with a safety margin (KV calibration uses 1.05)."""
    return _amax_to_scale(amax * margin, fp8_dtype, scale_format)


# ---------------------------------------------------------------------------
# Quantization error metrics (used by tests and the weight-sync monitor).
# ---------------------------------------------------------------------------

def quantization_rel_error(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """||x - dequantize(qt)|| / (||x|| + eps), in f32 on `x`'s device (a
    0-dim tensor)."""
    xf = x.float()
    err = torch.linalg.vector_norm(xf - dequantize(qt, torch.float32))
    return err / (torch.linalg.vector_norm(xf) + _EPS)
