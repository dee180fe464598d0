"""Sharding rules: DP / TP / EP / SP / ZeRO-3 over a device mesh (port of
`repro.distributed.sharding`).

Conventions, as in the reference:
  * DP spans the ("pod", "data") axes (pod present only in multi-pod mode).
  * TP spans "model": Megatron column/row parallel on *fused* head and d_ff
    dims — fused dims divide 16 for every assigned arch even when head
    counts (24, 48) do not.
  * EP: expert dim sharded over "model" when n_experts % tp == 0 (jamba:16),
    else TP-in-expert (d_ff over "model": granite 512/16, grok 32768/16).
  * ZeRO-3: params/optimizer additionally sharded over "data" on the dim not
    taken by TP; each layer's forward gathers them back.
  * SP: residual activations sharded over "model" along the sequence dim.

A spec is a tuple with one entry per tensor dim: None, an axis name, or a
tuple of axis names (the counterpart of a `PartitionSpec`).  Every spec
passes through `safe_spec`, which drops axis assignments that do not
divide their dim.  The rules need only the mesh's ordered axis names and
sizes: a `torch.distributed.device_mesh.DeviceMesh` with named dims, or a
`MeshShape` (no process group), so their logic runs anywhere.  On a
`DeviceMesh`, `placements` turns a spec into DTensor placements,
`shard_shape` gives a rank's local shape, and `distribute` (the
reference's `jax.device_put`) lays a tree out as DTensors.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.core.quant import QuantizedTensor

Axis = Union[str, Sequence[str], None]


class MeshShape(NamedTuple):
    """A mesh's ordered axis names and sizes, with no devices (the
    production meshes' description, the rules' pure logic)."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axes(mesh) -> dict:
    """{axis name: size} in mesh-dim order, of a `MeshShape` or of a
    `DeviceMesh` with named dims."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_tuple(axis: Axis) -> tuple:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _axis_size(mesh, axis: Axis) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _axis_tuple(axis))


def safe_spec(mesh, shape, spec) -> tuple:
    """Drop axis assignments that don't divide their dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries[:len(shape)]):
        if axis is None:
            out.append(None)
            continue
        out.append(axis if dim % _axis_size(mesh, axis) == 0 else None)
    return tuple(out)


def shard_shape(mesh, shape, spec) -> tuple:
    """The local shape of one rank's shard of `shape` under `spec`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim // _axis_size(mesh, axis) for dim, axis in zip(shape, spec))


def placements(mesh, spec) -> list:
    """DTensor placements (one per mesh dim) of a spec: mesh dim i shards
    the tensor dim whose entry names it, else replicates.  With several
    axes on one tensor dim, the shard order is the mesh-dim order (JAX's
    for a spec that lists its axes in mesh order, as the rules do)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for dim, axis in enumerate(spec):
        axes = _axis_tuple(axis)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"axes {axes} of dim {dim} are not in mesh order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


def local_shard(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of the whole plain tensor `full` under DTensor
    `like`'s layout (views; no communication)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, off = compute_local_shape_and_global_offset(full.shape, like.device_mesh,
                                                       like.placements)
    for d, (n, o) in enumerate(zip(shape, off)):
        full = full.narrow(d, o, n)
    return full


def distribute(tree, specs, mesh):
    """Lay out every tensor of `tree` as a DTensor on `mesh` under the
    matching spec of `specs` (`ShardingRules.params` / `batch_spec`):
    each rank copies its shard out of the full tensor it holds (every rank
    must hold the same values; nothing is communicated, and the DTensors
    share no storage with `tree`).  A `QuantizedTensor`'s payload and
    scales are laid out as two DTensors.  Meta tensors (the dry run's)
    stay on meta."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(distribute(tree.data, specs.data, mesh),
                               distribute(tree.scales, specs.scales, mesh), tree.block)
    places = placements(mesh, specs)
    coord = mesh.get_coordinate()
    local = tree if tree.is_meta else tree.to(mesh.device_type)
    # mesh dims split in mesh-dim order, DTensor's order for a dim that
    # several mesh dims shard
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local.clone(memory_format=torch.contiguous_format), mesh,
                              places, run_check=False)


class ShardingRules:
    """Maps param paths / activation names to specs on `mesh`."""

    def __init__(
        self,
        mesh,
        *,
        tp_axis: Axis = "model",
        dp_axes: Axis = None,        # default: every non-tp axis
        zero3: bool = True,
        sequence_parallel: bool = False,
        vocab_parallel_ce: bool = False,
    ):
        self.mesh = mesh
        self.tp = tp_axis            # str or tuple of axes (full-TP decode)
        if dp_axes is None:
            tp_set = set(_axis_tuple(tp_axis))
            dp_axes = tuple(a for a in mesh_axes(mesh) if a not in tp_set)
        if isinstance(dp_axes, str):
            dp_axes = (dp_axes,)
        # empty dp (full-TP): None, so spec entries stay valid
        self.dp = tuple(dp_axes) if dp_axes else None
        self.zero3 = zero3 and self.dp is not None
        self.sp = sequence_parallel
        self.vp_ce = vocab_parallel_ce

    # -- helpers ---------------------------------------------------------
    @property
    def dpz(self) -> Axis:
        """The data axes used for ZeRO param sharding (None if disabled)."""
        return self.dp if self.zero3 else None

    def tp_size(self) -> int:
        return _axis_size(self.mesh, self.tp)

    def named(self, shape, *spec_entries) -> tuple:
        return safe_spec(self.mesh, shape, spec_entries)

    # -- parameters --------------------------------------------------------
    # order matters: first match wins
    _RULES = (
        # (pattern, spec builder (ndim-agnostic from the right))
        (r"\bemb\b",               ("tp", "dpz")),        # vocab-parallel
        (r"lm_head",               ("dpz", "tp")),        # column-parallel
        (r"\bwq\b",                ("dpz", "tp")),        # column-parallel
        # KV projections: ZeRO only, no TP (the reference's choice: with
        # kvh < tp the "act_kv" rule replicates K/V over the model axis, so
        # a column-parallel wk/wv would be gathered right back)
        (r"\bwk\b|\bwv\b",         ("dpz", None)),
        (r"\bwo\b",                ("tp", "dpz")),        # row-parallel
        (r"\bwg\b|\bwu\b",         ("dpz", "tp")),
        (r"\bwd\b",                ("tp", "dpz")),
        (r"\bw_in\b",              ("dpz", "tp")),
        (r"\bw_out\b",             ("tp", "dpz")),
        (r"\bw_patch\b",           ("dpz", "tp")),
        (r"router",                ("dpz", None)),
        (r"\bfc1\b",               "moe_fc1"),
        (r"\bfc2\b",               "moe_fc2"),
        (r"\bconv_w\b",            (None, "tp")),
        (r"\bconv_b\b",            ("tp",)),
        (r"gate_norm_scale",       ("tp",)),
    )

    def _resolve(self, token):
        return {"tp": self.tp, "dpz": self.dpz, None: None}[token]

    def param_spec(self, path: str, leaf) -> tuple:
        shape = tuple(leaf.shape)
        ndim = len(shape)
        for pat, rule in self._RULES:
            if re.search(pat, path):
                if rule == "moe_fc1":
                    # (.., E, D, 2F): EP over E when divisible, else TP on 2F
                    if shape[-3] % self.tp_size() == 0:
                        spec = [self.tp, self._resolve("dpz"), None]
                    else:
                        spec = [None, self._resolve("dpz"), self.tp]
                elif rule == "moe_fc2":
                    if shape[-3] % self.tp_size() == 0:
                        spec = [self.tp, None, self._resolve("dpz")]
                    else:
                        spec = [None, self.tp, self._resolve("dpz")]
                else:
                    spec = [self._resolve(t) for t in rule]
                full = [None] * max(0, ndim - len(spec)) + spec[-ndim:] \
                    if ndim >= 1 else []
                return self.named(shape, *full)
        # default: replicated (norm scales, biases, dt params)
        return self.named(shape)

    def params(self, params_tree, prefix: str = ""):
        """Tree of specs matching `params_tree` (tensors, or meta tensors
        from `launch.steps.param_specs`).  QuantizedTensor leaves: .data
        and .scales (paths ".../0" and ".../1", as the reference's pytree
        flattens them) both inherit the weight rule's axes — scale dims
        are the weight dims / 128, so `safe_spec` keeps whatever still
        divides."""
        if isinstance(params_tree, dict):
            return {k: self.params(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in params_tree.items()}
        if isinstance(params_tree, QuantizedTensor):
            return QuantizedTensor(self.param_spec(prefix + "/0", params_tree.data),
                                   self.param_spec(prefix + "/1", params_tree.scales),
                                   params_tree.block)
        return self.param_spec(prefix, params_tree)

    # -- activations --------------------------------------------------------
    def activation(self, name: str, shape, meta=None) -> Optional[tuple]:
        """Logical activation specs.  Decode shapes (T == 1) and batch=1
        cells fall back gracefully through safe_spec."""
        dp, tp = self.dp, self.tp
        tps = self.tp_size()
        meta = meta or {}
        if name == "act_btd":       # (B, T, D) residual stream
            spec = (dp, tp if self.sp else None, None)
        elif name == "act_btf":     # (B, T, F) mlp hidden
            spec = (dp, None, tp)
        elif name == "act_qkv":     # (B, S, H, Dh) attention heads
            if shape[2] % tps == 0:
                spec = (dp, None, tp, None)          # head-parallel
            elif shape[1] % tps == 0 and shape[1] > 1:
                spec = (dp, tp, None, None)          # seq-parallel fallback
            else:
                spec = (dp, None, None, None)
        elif name == "act_kv":      # (B, S, KVH, Dh) GQA key/value heads
            # compatible with q's layout: when kvh < tp but q is
            # head-parallel, REPLICATE KV over tp (Megatron kv-head
            # duplication)
            n_heads = meta.get("n_heads", 0)
            if shape[2] % tps == 0:
                spec = (dp, None, tp, None)
            elif n_heads % tps == 0:
                spec = (dp, None, None, None)        # duplicate KV over tp
            elif shape[1] % tps == 0 and shape[1] > 1:
                spec = (dp, tp, None, None)          # match seq-parallel q
            else:
                spec = (dp, None, None, None)
        elif name == "logits":      # (B, T, V) or (B, V)
            # vocab-parallel CE keeps V sharded where lm_head produced it;
            # the baseline shards logits over the sequence
            if len(shape) == 3:
                if self.vp_ce and shape[2] % tps == 0:
                    spec = (dp, None, tp)
                elif shape[1] % tps == 0 and shape[1] > 1:
                    spec = (dp, tp, None)
                else:
                    spec = (dp, None, None)
            else:
                spec = (dp, tp if self.vp_ce and shape[-1] % tps == 0 else None)
        elif name == "act_ecd":     # (E, M, D) dispatched expert tokens
            if shape[0] % tps == 0:
                spec = (tp, dp, None)                # EP over experts
            else:
                spec = (None, dp, None)              # TP lives in d_ff instead
        elif name == "kv_gather":   # (B, S, KVH, D) decode-path KV payload
            # batch-sharded, replicated over tp: the resharding collective
            # then moves fp8 bytes, and dequantization happens locally
            spec = (dp, None, None, None)
        elif name == "act_gnd":     # (G, N, D) MoE per-group tokens/gathers
            spec = (dp, None, None)
        elif name == "act_gnkd":    # (G, N, K, D) MoE combine gather
            spec = (dp, None, None, None)
        elif name == "tokens":      # (B, T)
            spec = (dp, None)
        elif name == "batch":       # (B, ...)
            spec = (dp,)
        else:
            return None
        return safe_spec(self.mesh, shape, spec)

    def batch_spec(self, tree):
        """Shard the leading (batch) dim of every leaf."""
        if isinstance(tree, dict):
            return {k: self.batch_spec(v) for k, v in tree.items()}
        return self.named(tuple(tree.shape), self.dp)

    # -- rollout caches ----------------------------------------------------
    def cache_spec(self, cache_tree, prefix: str = ""):
        """Specs for a rollout cache tree (`launch.steps.cache_specs`).

        KV payloads (R, B, S, KVH, D): batch over dp; the model axis takes
        KVH when it divides, else D (head-dim sharding), else nothing.
        When B doesn't divide dp (long_500k: B=1) the sequence dim takes dp
        so a 500k cache is not replicated.  SSM state (R, B, H, P, N):
        heads over tp, batch dp.  Leaves are tensors, or the port's
        `KVCache` / `SSMState` dataclasses (their field names are the
        reference's path keys, spelled ".../.k" as the reference's paths
        spell a named tuple's fields, so "/h" never matches an SSM state's
        ".h" there either and the state stays replicated, as in the
        reference); host ints pass through.
        """
        if isinstance(cache_tree, dict):
            return {k: self.cache_spec(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in cache_tree.items()}
        if dataclasses.is_dataclass(cache_tree):
            return type(cache_tree)(**{
                f.name: self.cache_spec(getattr(cache_tree, f.name), f"{prefix}/.{f.name}")
                for f in dataclasses.fields(cache_tree)})
        if not isinstance(cache_tree, torch.Tensor):
            return cache_tree
        tp, dp = self.tp, self.dp
        p = prefix
        shape = tuple(cache_tree.shape)
        if "lengths" in p:
            return self.named(shape)
        if ("/k" in p or "/v" in p or p.endswith("k") or p.endswith("v")) \
                and len(shape) == 5:
            r, b, s, kvh, d = shape
            batch_ok = b % _axis_size(self.mesh, dp) == 0
            model_dim = 3 if kvh % self.tp_size() == 0 else \
                (4 if d % self.tp_size() == 0 else None)
            entries = [None] * 5
            if batch_ok:
                entries[1] = dp
            else:
                entries[2] = dp          # shard S instead (B=1 decode)
            if model_dim is not None:
                entries[model_dim] = tp
            return self.named(shape, *entries)
        if "scale" in p:
            return self.named(shape)
        if "/h" in p and len(shape) == 5:      # SSM state (R,B,H,P,N)
            return self.named(shape, None, dp, tp, None, None)
        if "conv" in p and len(shape) == 4:    # (R,B,W-1,C)
            return self.named(shape, None, dp, None, tp)
        return self.named(shape)

    def replicated(self, tree=None):
        """The all-None spec of each leaf of `tree` (`()` alone: the
        reference's `P()`, replicated at any rank)."""
        if tree is None:
            return ()
        if isinstance(tree, dict):
            return {k: self.replicated(v) for k, v in tree.items()}
        return (None,) * len(tree.shape)


_REGISTERED = []


def register_dtensor_ops() -> None:
    """Sharding strategies for the GEMMs DTensor has none for:
    `aten::mm.dtype` and `aten::bmm.dtype` (the card's `_dot`: one GEMM of
    the operands as they are with f32 sums and an f32 result) take mm's
    and bmm's.  Idempotent."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    @register_sharding(aten.mm.dtype)
    def _mm_dtype(x, w, out_dtype):
        # per mesh dim: replicated, rows, columns, or the contraction
        # sharded (partial sums)
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]

    @register_sharding(aten.bmm.dtype)
    def _bmm_dtype(x, w, out_dtype):
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Shard(0), Shard(0), None]),
                ([Shard(1)], [Shard(1), Replicate(), None]),
                ([Shard(2)], [Replicate(), Shard(2), None]),
                ([Partial()], [Shard(2), Shard(1), None])]

    _REGISTERED.append((_mm_dtype, _bmm_dtype))
