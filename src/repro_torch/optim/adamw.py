"""AdamW with optional blockwise-FP8 moment storage (port of
`repro.optim.adamw`).

The reference's update, not `torch.optim.AdamW` (which places eps and
the weight decay differently): a global-norm clip, bias-corrected moments,
delta = mhat / (sqrt(vhat) + eps) (+ wd * p), p -= lr * delta, all in
f32 and rounded once to the param dtype.  With `fp8_moments` m and v are
stored as E4M3 payloads with one f32 scale per 128 elements of the last
axis (`core.quant.quantize_blockwise`), requantized after every update.

Params, grads and moments are nested dicts of tensors (moments:
`QuantizedTensor`s with fp8 moments), as `Transformer.init_params` makes
them.  `update` works in place: each leaf is updated in chunks along its
leading axis of at most `CHUNK_ELEMS` elements (one layer of a stacked
(36, 4096, 12288) leaf), so the f32 temporaries of a full-width update
stay at one chunk's size instead of 7 GB per temporary per leaf.  A
moment block never crosses the leading axis, so each element's arithmetic
is the whole-leaf one, bit for bit.

Sharded params (DTensors laid out by `distributed.ShardingRules`) keep
their moments sharded as they are (ZeRO: each rank holds only its
shards): each gradient is first redistributed to its param's placements
(the reduce-scatter / all-reduce of data parallelism), the global norm
sums every shard once, and each rank updates its local shards with the
same arithmetic.  fp8 moments keep the one-process payload and scales bit
for bit (`_moment_layout`): where a rank's shard of the last axis starts
and ends on 128-block boundaries (or the last axis is not sharded), its
local blocks are the global ones and the scales shard with the payload;
where a shard boundary splits a block, the scales of the last axis are
replicated and each block's amax is reduced (max) over the ranks that
share it before the scale is taken.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import is_dtensor
from repro_torch.core.fp8_params import tree_leaves
from repro_torch.core.precision import E4M3, ScaleFormat
from repro_torch.core.quant import (
    QuantizedTensor,
    _amax_to_scale,
    dequantize,
    quantize_blockwise,
    saturating_cast,
)

# f32 elements per update chunk: 2**26 (256 MiB per f32 temporary)
CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    fp8_moments: bool = False
    warmup_steps: int = 0


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: dict              # tree of f32 tensors or QuantizedTensors
    v: dict


def _moment_block(shape) -> tuple:
    return (1,) * (len(shape) - 1) + (min(128, shape[-1]),)


def _quant_moment(x: torch.Tensor) -> QuantizedTensor:
    if x.dim() == 0:
        return quantize_blockwise(x[None], (1,), E4M3)
    return quantize_blockwise(x, _moment_block(x.shape), E4M3, ScaleFormat.FP32)


def _load_moment(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, QuantizedTensor):
        out = dequantize(x, torch.float32)
        return out[0] if like.dim() == 0 else out
    return x


def _store_moment(x: torch.Tensor, fp8: bool):
    return _quant_moment(x) if fp8 else x


def _local(t):
    """A DTensor's local shard (under no_grad the tensor itself, so
    in-place writes land in the DTensor); `t` itself otherwise."""
    if isinstance(t, QuantizedTensor):
        return QuantizedTensor(_local(t.data), _local(t.scales), t.block)
    return t.to_local() if is_dtensor(t) else t


def _moment_layout(p):
    """The fp8 moment blocks of a DTensor param `p` against its shards:
    (block, n_blocks, shard start on the last axis, aligned, mesh dims
    sharding the last axis, scale placements).  Blocks are 1 x
    min(128, N) of the global last axis N (a 0-dim param is one (1,)
    block); `aligned` when this layout's shards of the last axis start and
    end on block boundaries, and then the scales shard like the payload;
    otherwise their last axis is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape = tuple(p.shape) or (1,)
    last = len(shape) - 1
    blk = min(128, shape[-1])
    places = list(p.placements)
    on = [i for i, q in enumerate(places) if q == Shard(last)]
    mesh = p.device_mesh
    ways = math.prod(mesh.size(i) for i in on)
    # the rules' shards are even: L = N / ways, starting at multiples of L
    aligned = ways == 1 or (shape[-1] % ways == 0 and (shape[-1] // ways) % blk == 0)
    _, off = compute_local_shape_and_global_offset(shape, mesh, places)
    s_pl = places if aligned else [Replicate() if q == Shard(last) else q for q in places]
    return blk, -(-shape[-1] // blk), off[-1], aligned, on, s_pl


def _sharded_zero_moment(p, fp8: bool):
    """A zero moment of a DTensor param: its local shard's (f32), with the
    param's placements; with fp8 a zero payload laid out like `p` and the
    scale of amax 0 in `_moment_layout`'s scale layout."""
    from torch.distributed.tensor import DTensor

    mesh = p.device_mesh
    if not fp8:
        return DTensor.from_local(_zero_moment(p.to_local(), False), mesh, p.placements,
                                  run_check=False)
    blk, nb, off, aligned, _, s_pl = _moment_layout(p)
    local = p.to_local()
    shape = tuple(p.shape) or (1,)
    lshape = tuple(local.shape) or (1,)
    nbl = -(-lshape[-1] // blk) if aligned else nb
    scale = _amax_to_scale(torch.zeros((), device=local.device), E4M3, ScaleFormat.FP32)
    data = DTensor.from_local(torch.zeros(lshape, dtype=E4M3, device=local.device), mesh,
                              p.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())
    s_shape = shape[:-1] + (nb,)
    scales = DTensor.from_local(scale.expand(lshape[:-1] + (nbl,)).clone(), mesh, s_pl,
                                run_check=False, shape=s_shape,
                                stride=torch.empty(s_shape, device="meta").stride())
    return QuantizedTensor(data, scales, (1,) * (len(shape) - 1) + (blk,))


def _load_shard(m: QuantizedTensor, head: int, n: int) -> torch.Tensor:
    """f32 values of a local fp8 moment shard of `n` elements along the
    last axis whose first element sits `head` elements into its first
    scale block."""
    full = torch.repeat_interleave(m.scales, m.block[-1], dim=-1)[..., head:head + n]
    return m.data.float() * full


def _store_shard(dst: QuantizedTensor, x: torch.Tensor, head: int, groups: list) -> None:
    """Quantize the f32 local shard `x` into `dst` (`_load_shard`'s
    layout) as `quantize_blockwise` quantizes the global leaf: each
    block's amax over its local elements, reduced (max) over the process
    groups `groups` that share the block, then the scale and the cast."""
    blk, nbl = dst.block[-1], dst.scales.shape[-1]
    n = x.shape[-1]
    ax = F.pad(x.abs(), (head, nbl * blk - head - n))
    amax = ax.reshape(*x.shape[:-1], nbl, blk).amax(dim=-1)
    c10d = torch.ops._c10d_functional
    for name in groups:
        amax = c10d.wait_tensor(c10d.all_reduce(amax.contiguous(), "max", name))
    scales = _amax_to_scale(amax, E4M3, ScaleFormat.FP32)
    full = torch.repeat_interleave(scales, blk, dim=-1)[..., head:head + n]
    dst.data.copy_(saturating_cast(x / full, E4M3))
    dst.scales.copy_(scales)


def _zero_moment(p: torch.Tensor, fp8: bool):
    """A zero moment for `p`; with fp8, `_quant_moment` of zeros (zero
    payload, the scale of amax 0) built without an f32 copy of the leaf."""
    if is_dtensor(p):
        return _sharded_zero_moment(p, fp8)
    if not fp8:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    shape = tuple(p.shape) or (1,)
    block = _moment_block(shape) if p.dim() else (1,)
    scale = _amax_to_scale(torch.zeros((), device=p.device), E4M3, ScaleFormat.FP32)
    n_blocks = tuple(-(-d // b) for d, b in zip(shape, block))
    return QuantizedTensor(torch.zeros(shape, dtype=E4M3, device=p.device),
                           scale.expand(n_blocks).clone(), block)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _chunk_ranges(p: torch.Tensor) -> list:
    """[start, stop) ranges along `p`'s leading axis, at most CHUNK_ELEMS
    elements each (one row at least); [None] (the whole leaf) below 2
    dims."""
    if p.dim() < 2:
        return [None]
    per_row = max(math.prod(p.shape[1:]), 1)
    rows = max(1, CHUNK_ELEMS // per_row)
    return [(i, min(i + rows, p.shape[0])) for i in range(0, p.shape[0], rows)]


def _chunk(t, r):
    """Rows r = (start, stop) of a tensor or of a `QuantizedTensor`'s
    payload and scales (views); `t` itself for r None."""
    if r is None:
        return t
    if isinstance(t, QuantizedTensor):
        return QuantizedTensor(t.data[r[0]:r[1]], t.scales[r[0]:r[1]], t.block)
    return t[r[0]:r[1]]


def init(params: dict, config: AdamWConfig) -> AdamWState:
    def zero(p):
        return _zero_moment(p, config.fp8_moments)

    dev = _local(next(tree_leaves(params))).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=_map(zero, params), v=_map(zero, params))


def _schedule(config: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    lr = torch.tensor(config.lr, dtype=torch.float32, device=step.device)
    if config.warmup_steps > 0:
        lr = lr * torch.clamp((step + 1) / config.warmup_steps, max=1.0)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (leaf by leaf and
    chunk by chunk, so no leaf is widened whole; a DTensor leaf shard by
    shard, each counted once)."""
    total = None
    for g in tree_leaves(tree):
        if is_dtensor(g):
            sq = torch.sum(torch.square(g.float())).full_tensor()
            total = sq if total is None else total + sq
            continue
        for r in _chunk_ranges(g):
            sq = torch.sum(torch.square(_chunk(g, r).float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _adam(p, g, m, v, *, scale, lr, bc1, bc2, config: AdamWConfig):
    """The reference's AdamW arithmetic on f32 moments -> (new p, m, v)."""
    b1, b2 = config.b1, config.b2
    g = g.float() * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mhat = m / bc1
    vhat = v / bc2
    delta = mhat / (torch.sqrt(vhat) + config.eps)
    if config.weight_decay:
        delta = delta + config.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


def _update_leaf(p, g, m, v, *, scale, lr, bc1, bc2, config: AdamWConfig):
    """The reference's per-leaf AdamW on `p` (any shape: a whole leaf or
    one chunk of it) -> (new p, stored m, stored v)."""
    new_p, m, v = _adam(p, g, _load_moment(m, g), _load_moment(v, g), scale=scale, lr=lr,
                        bc1=bc1, bc2=bc2, config=config)
    return new_p, _store_moment(m, config.fp8_moments), \
        _store_moment(v, config.fp8_moments)


def _update_sharded_fp8(p, g, m, v, **kw) -> None:
    """One DTensor leaf with fp8 moments, in place, chunk by chunk of its
    local shard (`_moment_layout`: blocks that straddle a shard boundary
    reduce their amax over the ranks sharing them)."""
    blk, _, off, aligned, on, _ = _moment_layout(p)
    # aligned: every local block is whole; else the scales span the axis
    head = 0 if aligned else off
    groups = [] if aligned else [p.device_mesh.get_group(i).group_name for i in on]
    p, g, m, v = _local(p), _local(g), _local(m), _local(v)
    if p.dim() == 0:
        p, g = p[None], g[None]
    for r in _chunk_ranges(p):
        pc, mc, vc = _chunk(p, r), _chunk(m, r), _chunk(v, r)
        n = pc.shape[-1]
        new_p, new_m, new_v = _adam(pc, _chunk(g, r), _load_shard(mc, head, n),
                                    _load_shard(vc, head, n), **kw)
        pc.copy_(new_p)
        _store_shard(mc, new_m, head, groups)
        _store_shard(vc, new_v, head, groups)


def _write_moment(dst, src):
    if isinstance(dst, QuantizedTensor):
        dst.data.copy_(src.data)
        dst.scales.copy_(src.scales)
    else:
        dst.copy_(src)


@torch.no_grad()
def update(params: dict, grads: dict, state: AdamWState, config: AdamWConfig):
    """Returns (params, new_state, stats); params and the moments are
    updated in place (the returned trees are the same objects)."""
    grads = _map(lambda p, g: g.redistribute(p.device_mesh, p.placements)
                 if is_dtensor(p) else g, params, grads)
    gnorm = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    if config.grad_clip > 0:
        scale = torch.where(gnorm > config.grad_clip,
                            config.grad_clip / (gnorm + 1e-9), one)
    else:
        scale = one
    step = state.step + 1
    lr = _schedule(config, state.step)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(config.b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(config.b2, device=stepf.device), stepf)

    def upd(p, g, m, v):
        if is_dtensor(p) and isinstance(m, QuantizedTensor):
            return _update_sharded_fp8(p, g, m, v, scale=scale, lr=lr, bc1=bc1, bc2=bc2,
                                       config=config)
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        for r in _chunk_ranges(p):
            pc, mc, vc = _chunk(p, r), _chunk(m, r), _chunk(v, r)
            new_p, new_m, new_v = _update_leaf(
                pc, _chunk(g, r), mc, vc, scale=scale, lr=lr, bc1=bc1,
                bc2=bc2, config=config)
            pc.copy_(new_p)
            _write_moment(mc, new_m)
            _write_moment(vc, new_v)

    _map(upd, params, grads, state.m, state.v)
    stats = {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
    return params, AdamWState(step=step, m=state.m, v=state.v), stats


def state_bytes(state: AdamWState) -> int:
    total = 0
    for leaf in tree_leaves({"m": state.m, "v": state.v}):
        leaf = _local(leaf)
        if isinstance(leaf, QuantizedTensor):
            total += leaf.data.numel() + 4 * leaf.scales.numel()
        else:
            total += leaf.numel() * leaf.element_size()
    return total
