"""Shared model components: norms, RoPE, initializers (port of
`repro.models.common`)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


# The card's reduction kernels and GEMM library pick their algorithm, and so
# their summation order, by the number of rows.  Below ROW_FLOOR rows the
# port pads to it, so that a row's norm and logits do not depend on how
# many rows share the call (a decode step's slots, a speculative verify
# chunk, one prompt's last position): the serving engine's bit-exact
# contracts (speculative greedy = plain greedy) rest on that.  Padding
# changes no value on the CPU, where each row is reduced on its own.
ROW_FLOOR = 16


def pad_rows(x2d: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (max(n, ROW_FLOOR), d), zero rows appended."""
    n = x2d.shape[0]
    return F.pad(x2d, (0, 0, 0, ROW_FLOOR - n)) if n < ROW_FLOOR else x2d


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    sq = (xf * xf).reshape(-1, xf.shape[-1])
    var = torch.mean(pad_rows(sq), dim=-1)[: sq.shape[0]]
    y = xf * torch.rsqrt(var.reshape(xf.shape[:-1] + (1,)) + eps)
    return (y * scale.float()).to(x.dtype)


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape, in_axis_size: Optional[int] = None,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """normal * fan_in^-0.5, drawn in f32 one leading slice at a time (a
    full-width stacked leaf never exists in f32 at once).  On `device`
    (the generator's when None; "meta" gives shapes only)."""
    device = generator.device if device is None else device
    fan_in = in_axis_size if in_axis_size is not None else shape[-2]
    std = fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:             # shapes only: nothing to draw
        return out
    flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for i in range(flat.shape[0]):
        flat[i] = torch.randn(shape[-2:], generator=generator, device=device) * std
    return out


def embed_init(generator: torch.Generator, shape, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    device = generator.device if device is None else device
    return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)
