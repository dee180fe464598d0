"""GPipe pipeline parallelism over a mesh dim (port of
`repro.distributed.pipeline`).

Schedule: classic GPipe fill-drain.  With S stages and M microbatches the
loop runs M + S - 1 ticks; at tick t, stage s processes microbatch t - s
if it exists (stage 0 takes a fresh microbatch, the others the ring's
buffer).  A stage idle at a tick produces zeros, as the reference's
`where` does (here without computing the stage on a dummy input).
Activations hop to the next stage by `batch_isend_irecv` around the ring;
the last stage writes each finished microbatch into the output slab, and
a closing all-reduce gives the slab to every stage (the other stages add
zeros).

Bubble fraction = (S-1)/(M+S-1), reported by `bubble_fraction` so the
launcher can pick M.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import host_collectives


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def shard_stages(params_stacked, mesh, stage_axis: str = "stage"):
    """Lay a stacked (S, ...) tree out over the `stage_axis` mesh dim, as
    the reference's `in_specs` P(stage_axis) do: DTensors sharded on dim
    0 there (replicated over any other mesh dim), so each rank keeps only
    its own stage's slice (`distribute` copies it out; nothing is
    communicated)."""
    from repro_torch.distributed.sharding import distribute

    def specs(tree):
        if isinstance(tree, dict):
            return {k: specs(v) for k, v in tree.items()}
        return (stage_axis,) + (None,) * (tree.dim() - 1)

    return distribute(params_stacked, specs(params_stacked), mesh)


def _stage_slice(tree, s: int):
    """This stage's params: the local slice of a `shard_stages` DTensor,
    or slice s of a plain stacked (S, ...) tree (views)."""
    from repro_torch import is_dtensor

    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    if is_dtensor(tree):
        return tree.to_local()[0]
    return tree[s]


def pipeline_apply(stage_fn: Callable, mesh, stage_axis: str = "stage"):
    """Returns pipelined(params_stacked, x_microbatched).

    stage_fn       : (stage_params, x) -> y, same shape.
    mesh           : a `DeviceMesh` with a `stage_axis` dim; this rank is
                     stage `mesh.get_local_rank(stage_axis)`.
    params_stacked : (S, ...) tree — stage s uses slice s: `shard_stages`
                     DTensors, each rank holding only its own slice, or
                     plain tensors holding every stage's.
    x_microbatched : (M, mb, ...) — M microbatches, the same on every rank.
    Result         : (M, mb, ...) = stack of stage_{S-1}(...stage_0(x_m)),
                     on every rank.
    """
    group = mesh.get_group(stage_axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    s = mesh.get_local_rank(stage_axis)
    send_to = dist.get_global_rank(group, (s + 1) % n_stages)
    recv_from = dist.get_global_rank(group, (s - 1) % n_stages)

    def pipelined(params_stacked, xs):
        sp = _stage_slice(params_stacked, s)
        m = xs.shape[0]
        buf = torch.zeros_like(xs[0])
        out = torch.zeros_like(xs)
        for t in range(m + n_stages - 1):
            mb_idx = t - s
            if 0 <= mb_idx < m:
                y = stage_fn(sp, xs[t] if s == 0 else buf)
                if s == n_stages - 1:
                    out[mb_idx] = y
            else:
                y = torch.zeros_like(buf)
            buf = host_collectives.ring_shift(y, group, send_to, recv_from)
        # outputs live on the last stage only; share them with everyone
        mine = out if s == n_stages - 1 else torch.zeros_like(out)
        if host_collectives.needs_host(mine.device):
            host_collectives.install()
        c10d = torch.ops._c10d_functional
        return c10d.wait_tensor(c10d.all_reduce(mine, "sum", group.group_name))

    return pipelined
