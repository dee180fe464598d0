#!/usr/bin/env python3
"""Where the production meshes' shards split a 128-block, for every
registry config, as the runtime itself decides it: the params are meta
DTensors on a fake process group of the mesh's size (opened in this
process, one mesh after the other), and each leaf goes through the
functions a sharded step calls.

    PYTHONPATH=src python3 tools/shard_blocks.py

Two lists per mesh, (16, 16) and (2, 16, 16), under the default rules
(ZeRO-3 over the data axes, TP over "model"), printed as one JSON object:

* `moment_straddles`: bf16 param leaves whose fp8 AdamW moment blocks
  straddle a shard boundary (`optim.adamw._moment_layout` not aligned),
  so `optim.adamw` replicates their scales' last axis and reduces each
  block's amax over the ranks that share it;
* `linear_splits`: W8A8 linears (one layer's slice of the rollout tree's
  quantized weights) whose TP shard of K or N `core.fp8_linear.
  _sharded_plan` gathers because it would split a 128x128 scale block
  (for K also a 1x128 activation tile): the linear runs replicated over
  those axes.  The activation is split by batch over the data axes, as a
  prefill or serve step gives it (ZeRO's data axes are then gathered too,
  on every weight, and are not listed).
"""
from __future__ import annotations

import json

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import REGISTRY
from repro_torch.core.fp8_linear import _sharded_plan
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed.sharding import ShardingRules, _axis_size, distribute
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim.adamw import _moment_layout

MESHES = {"single": 256, "multi": 512}


def _leaves(tree, specs, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, specs[k], path)
        else:
            yield path, v, specs[k]


def moment_straddles(cfg, rules) -> list:
    params = steps.param_specs(cfg)
    out = []
    for path, leaf, spec in _leaves(params, rules.params(params)):
        p = distribute(leaf, spec, rules.mesh)
        if not _moment_layout(p)[3]:
            out.append(f"{path} {tuple(leaf.shape)} -> last axis {p.to_local().shape[-1]}")
    return out


def linear_splits(cfg, rules) -> list:
    mesh = rules.mesh
    roll = steps.param_specs(cfg, PrecisionConfig())
    tp = {mesh.mesh_dim_names.index(a) for a in
          ((rules.tp,) if isinstance(rules.tp, str) else rules.tp)}
    out = []
    for path, leaf, spec in _leaves(roll, rules.params(roll)):
        if not isinstance(leaf, QuantizedTensor):
            continue
        data, dspec = leaf.data, tuple(spec.data)
        if "blocks/" in path:                       # one layer of the stack
            data, dspec = data[0], dspec[1:]
        w = distribute(data, dspec, mesh)
        if data.dim() == 3:                         # experts: x split like them
            x_shape, x_spec = (data.shape[0], 8, data.shape[1]), (dspec[0], None, None)
        else:
            b = _axis_size(mesh, rules.dp)
            x_shape, x_spec = (b, 1, data.shape[0]), (rules.dp, None, None)
        x = distribute(torch.empty(x_shape, dtype=torch.bfloat16, device="meta"), x_spec, mesh)
        w_pl = _sharded_plan(x, QuantizedTensor(w, None, leaf.block))[0]
        nd = data.dim()
        for name, d in (("K", nd - 2), ("N", nd - 1)):
            dropped = [i for i in tp if w.placements[i] == Shard(d)
                       and w_pl[i] != w.placements[i]]
            if dropped:
                out.append(f"{path} {tuple(leaf.data.shape)}: {name} shard "
                           f"{w.to_local().shape[d]}")
    return out


def main():
    out = {}
    for mesh_name, world in MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        try:
            rules = ShardingRules(make_production_mesh(multi_pod=mesh_name == "multi",
                                                       device_type="cpu"))
            out[mesh_name] = {name: {"moment_straddles": moment_straddles(cfg, rules),
                                     "linear_splits": linear_splits(cfg, rules)}
                              for name, cfg in sorted(REGISTRY.items())}
        finally:
            dist.destroy_process_group()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
