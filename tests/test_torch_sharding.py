"""The port's sharding rules against the reference's (pure logic, no
process group).

The reference's `ShardingRules` run on `jax.sharding.AbstractMesh`es of
the production shapes, (16, 16) and (2, 16, 16), with no devices; the
port's on the same `MeshShape`s.  Every spec is compared entry by entry
(an axis name, a tuple of names or None per dim) with its local shard
shape: every leaf of every registry config's bf16 param tree (and the
fp8 rollout trees of a dense, an MoE and a hybrid config), every
activation name over a grid of shapes, and the rollout caches of
DECODE_32K and LONG_500K.
"""
import functools

import numpy as np
import pytest

import jax
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import REGISTRY as REF_REGISTRY
from repro.core.precision import FP8_LINEAR_ROLLOUT as REF_FP8
from repro.distributed.sharding import ShardingRules as RefRules
from repro.distributed.sharding import _path_str
from repro.distributed.sharding import safe_spec as ref_safe_spec
from repro.launch import steps as ref_steps

from repro_torch.configs import DECODE_32K, LONG_500K, get_config
from repro_torch.core.precision import FP8_LINEAR_ROLLOUT
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed.sharding import MeshShape, ShardingRules, safe_spec, shard_shape
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
SETTINGS = {
    "default": {},
    "no_zero3": {"zero3": False},
    "full_tp": "full_tp",
    "sp": {"sequence_parallel": True},
    "vp_ce": {"vocab_parallel_ce": True},
}


def _norm(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _norm_spec(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(_norm(e) for e in spec)


def _rules(mesh_key, setting):
    shape, names = MESHES[mesh_key]
    ref_mesh = AbstractMesh(shape, names)
    port_mesh = MeshShape(names, shape)
    kw = SETTINGS[setting]
    if kw == "full_tp":
        return (RefRules(ref_mesh, tp_axis=names, dp_axes=()),
                ShardingRules(port_mesh, tp_axis=names, dp_axes=()))
    return RefRules(ref_mesh, **kw), ShardingRules(port_mesh, **kw)


@functools.lru_cache(maxsize=None)
def _ref_params(name, fp8):
    return ref_steps.param_specs(REF_REGISTRY[name], REF_FP8 if fp8 else None)


@functools.lru_cache(maxsize=None)
def _port_params(name, fp8):
    return steps.param_specs(get_config(name), FP8_LINEAR_ROLLOUT if fp8 else None)


def _port_leaves(tree, prefix=""):
    """{reference path: (shape, spec)} of a port spec tree laid over its
    param tree (a QuantizedTensor's payload and scales at ".../0", ".../1",
    as the reference's pytree flattens them)."""
    params, specs = tree
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_port_leaves((v, specs[k]), path))
        elif isinstance(v, QuantizedTensor):
            out[path + "/0"] = (tuple(v.data.shape), specs[k].data)
            out[path + "/1"] = (tuple(v.scales.shape), specs[k].scales)
        else:
            out[path] = (tuple(v.shape), specs[k])
    return out


def _compare_params(name, fp8, mesh_key, setting):
    ref_rules, rules = _rules(mesh_key, setting)
    ref_tree = _ref_params(name, fp8)
    port_tree = _port_params(name, fp8)
    port = _port_leaves((port_tree, rules.params(port_tree)))
    ref = jax.tree_util.tree_leaves_with_path(ref_rules.params(ref_tree))
    shapes = dict((_path_str(p), leaf.shape)
                  for p, leaf in jax.tree_util.tree_leaves_with_path(ref_tree))
    assert len(ref) == len(port), (sorted(shapes), sorted(port))
    for path, sharding in ref:
        path = _path_str(path)
        shape = tuple(shapes[path])
        got_shape, got_spec = port[path]
        assert got_shape == shape, path
        assert _norm_spec(got_spec, len(shape)) == _norm_spec(sharding.spec, len(shape)), path
        assert shard_shape(rules.mesh, shape, got_spec) == tuple(sharding.shard_shape(shape)), path


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_param_specs_match_reference(mesh_key, setting):
    for name in sorted(REF_REGISTRY):
        _compare_params(name, False, mesh_key, setting)


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-30b-a3b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_fp8_param_specs_match_reference(name, mesh_key):
    for setting in ("default", "full_tp"):
        _compare_params(name, True, mesh_key, setting)


ACT_NDIM = {"act_btd": 3, "act_btf": 3, "act_qkv": 4, "act_kv": 4, "logits": 3,
            "act_ecd": 3, "kv_gather": 4, "act_gnd": 3, "act_gnkd": 4,
            "tokens": 2, "batch": 1}


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_activation_specs_match_reference(mesh_key, setting):
    ref_rules, rules = _rules(mesh_key, setting)
    rng = np.random.default_rng(0)
    dims = [1, 2, 3, 8, 16, 24, 32, 40, 48, 64, 96, 128, 256, 4096]
    for name, ndim in list(ACT_NDIM.items()) + [("logits", 2), ("unknown", 3)]:
        for _ in range(24):
            shape = tuple(int(d) for d in rng.choice(dims, ndim))
            for n_heads in (0, 24, 32):
                meta = {"n_heads": n_heads}
                want = ref_rules.activation(name, shape, meta)
                got = rules.activation(name, shape, meta)
                if want is None:
                    assert got is None, (name, shape)
                    continue
                assert _norm_spec(got, ndim) == _norm_spec(want.spec, ndim), (name, shape)
                assert shard_shape(rules.mesh, shape, got) == tuple(want.shard_shape(shape))


@pytest.mark.parametrize("cell", [DECODE_32K, LONG_500K], ids=lambda c: c.name)
@pytest.mark.parametrize("name", ["qwen3-8b", "jamba-1.5-large-398b", "seamless-m4t-medium"])
def test_cache_specs_match_reference(cell, name):
    from repro.configs.base import DECODE_32K as REF_D, LONG_500K as REF_L
    from repro.core.precision import PrecisionConfig as RefPrecision

    from repro_torch.core.precision import PrecisionConfig

    ref_cell = {"decode_32k": REF_D, "long_500k": REF_L}[cell.name]
    ref_tree = ref_steps.cache_specs(REF_REGISTRY[name], ref_cell, RefPrecision())
    port_tree = steps.cache_specs(get_config(name), cell, PrecisionConfig())
    for mesh_key in sorted(MESHES):
        for setting in ("default", "full_tp"):
            ref_rules, rules = _rules(mesh_key, setting)
            port_specs = rules.cache_spec(port_tree)
            for path, sharding in jax.tree_util.tree_leaves_with_path(
                    ref_rules.cache_spec(ref_tree)):
                node, tensor = port_specs, port_tree
                for key in _path_str(path).split("/"):
                    get = (lambda t, k=key: getattr(t, k[1:])) if key.startswith(".") \
                        else (lambda t, k=key: t[k])
                    node, tensor = get(node), get(tensor)
                shape = tuple(tensor.shape)
                assert _norm_spec(node, len(shape)) == _norm_spec(sharding.spec, len(shape)), \
                    (name, _path_str(path))


def test_safe_spec_matches_reference():
    class FakeMesh:
        shape = {"data": 4, "model": 8}
        axis_names = ("data", "model")

    m = FakeMesh()
    # the reference test's five cases
    assert safe_spec(m, (24, 32), ("data", "model")) == ("data", "model")
    assert safe_spec(m, (25, 32), ("data", "model")) == (None, "model")
    assert safe_spec(m, (24, 30), ("data", "model")) == ("data", None)
    assert safe_spec(m, (24,), (("data", "model"),)) == (None,)
    assert safe_spec(m, (32,), (("data", "model"),)) == (("data", "model"),)
    rng = np.random.default_rng(1)
    choices = [None, "data", "model", ("data", "model")]
    for _ in range(300):
        ndim = int(rng.integers(1, 5))
        shape = tuple(int(d) for d in rng.integers(1, 130, ndim))
        spec = tuple(choices[int(i)] for i in rng.integers(0, 4, int(rng.integers(0, ndim + 1))))
        want = ref_safe_spec(m, shape, P(*spec))
        assert _norm_spec(safe_spec(m, shape, spec), ndim) == _norm_spec(want, ndim)


def test_production_mesh_shapes():
    # the reference's `make_production_mesh` needs 256 / 512 devices; its
    # shapes are the MESHES above.  No process group: a MeshShape.
    for multi_pod, key in ((False, "pod"), (True, "multipod")):
        got = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        assert isinstance(got, MeshShape)
        assert (got.sizes, got.axis_names) == MESHES[key]
