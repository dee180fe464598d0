"""Shared model components: norms, RoPE, initializers, the
activation-sharding hook (port of `repro.models.common`)."""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import is_dtensor


# ---------------------------------------------------------------------------
# Activation-sharding hook.  The launcher installs mesh rules; model code
# calls `constrain(x, "act_btd")`, which returns x itself when no rules are
# active or x is not a DTensor.
# ---------------------------------------------------------------------------

_SHARDING_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(rules):
    """`rules` maps logical names -> specs (`distributed.ShardingRules`)."""
    prev = getattr(_SHARDING_CTX, "rules", None)
    _SHARDING_CTX.rules = rules
    try:
        yield
    finally:
        _SHARDING_CTX.rules = prev


def split_dim(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """`x.unflatten(dim, sizes)` (as a reshape: its backward takes a
    gradient of any layout).  A DTensor sharded on `dim` over mesh dims
    whose shard count does not divide sizes[0] (a projection's H·D over
    16 ranks into (24 heads, D)) is first gathered on those mesh dims: a
    shard cannot be split unevenly (GSPMD reshards such a view by itself,
    DTensor refuses it)."""
    dim = dim % x.dim()
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        on_dim = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
        if sizes[0] % math.prod(x.device_mesh.shape[i] for i in on_dim):
            x = x.redistribute(x.device_mesh, [Replicate() if i in on_dim else p
                                               for i, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def active_rules():
    """The rules `activation_sharding` installed in this thread (None
    outside it)."""
    return getattr(_SHARDING_CTX, "rules", None)


def replicate_like(t: torch.Tensor, x) -> torch.Tensor:
    """Plain `t` as a DTensor replicated on DTensor `x`'s mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


def zero_gather(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight gathered over the active rules' ZeRO axes (its TP
    shards kept), as ZeRO-3 gathers a weight before it is used; `w`
    itself without rules, without ZeRO or for a plain tensor."""
    rules = active_rules()
    if rules is None or not rules.dpz or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    zero = [w.device_mesh.mesh_dim_names.index(a) for a in rules.dpz]
    return w.redistribute(w.device_mesh, [Replicate() if i in zero else p
                                          for i, p in enumerate(w.placements)])


_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def redistribute(x, places):
    """`x.redistribute(x.device_mesh, places)`; an fp8 DTensor moves as its
    raw bytes (gloo has no fp8 type)."""
    if x.dtype not in _FP8:
        return x.redistribute(x.device_mesh, places)
    from torch.distributed.tensor import DTensor

    raw = DTensor.from_local(x.to_local().view(torch.uint8), x.device_mesh, x.placements,
                             run_check=False, shape=x.shape, stride=x.stride())
    raw = raw.redistribute(x.device_mesh, places)
    return DTensor.from_local(raw.to_local().view(x.dtype), x.device_mesh, raw.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def constrain(x: torch.Tensor, name: str, **meta) -> torch.Tensor:
    """x redistributed to the active rules' layout for activation `name`
    (the reference's `with_sharding_constraint`): the DTensor's own mesh
    takes the spec's placements.  Without rules, for a plain tensor, or
    for a name the rules do not know, x itself."""
    rules = active_rules()
    if rules is None or not is_dtensor(x):
        return x
    spec = rules.activation(name, tuple(x.shape), meta=meta)
    if spec is None:
        return x
    from repro_torch.distributed.sharding import placements

    return redistribute(x, placements(rules.mesh, spec))


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
    if is_dtensor(x):   # each rank reduces its own rows: no row padding
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        sq = (xf * xf).reshape(-1, xf.shape[-1])
        var = torch.mean(pad_rows(sq), dim=-1)[: sq.shape[0]].reshape(xf.shape[:-1] + (1,))
    y = xf * torch.rsqrt(var + eps)
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
    if is_dtensor(x):   # replicated operands (their backward may run on another thread)
        cos, sin = replicate_like(cos, x), replicate_like(sin, x)
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
