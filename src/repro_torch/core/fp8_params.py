"""Param-tree quantization — the substrate of weight sync (port of
`repro.core.fp8_params`).

Every RL step the BF16 training weights are blockwise-quantized and
handed to the rollout engine (paper §2.1.2).  The port's params are nested
dicts with the reference's key names and layer-stacked leaves, so the same
path regexes select the same leaves ("blocks/s0/attn/wq", ...).  Linear
weights become `QuantizedTensor`s through kernel 2 (one launch per stacked
leaf); embeddings, norms and the lm_head pass through by reference.
An MoE router is cast to the configured router dtype instead (paper
§2.2.4, fig. 6): bf16 or f32, or under the FP8 ablation quantized like a
linear (E4M3, f32 block scales).
"""
from __future__ import annotations

import re

import torch

from repro_torch.core.precision import E4M3, PrecisionConfig, RouterDtype, ScaleFormat
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import ops

QUANTIZE_PATTERNS = (
    r"\bwq\b", r"\bwk\b", r"\bwv\b", r"\bwo\b",            # attention proj
    r"\bwg\b", r"\bwu\b", r"\bwd\b",                        # gate/up/down MLP
    r"\bfc1\b", r"\bfc2\b",                                 # MoE experts
    r"\bw_in\b", r"\bw_out\b", r"\bw_x\b", r"\bw_z\b",      # SSM projections
    r"\bwqkv\b", r"\bw_cross_", r"\bw_patch\b",
)
EXCLUDE_PATTERNS = (
    r"\bemb", r"lm_head", r"\bnorm", r"\bln", r"\bscale\b", r"\bbias\b",
    r"router", r"\brope", r"\ba_log\b", r"\bdt_bias\b", r"\bD\b",
)

_QUANT_RE = re.compile("|".join(QUANTIZE_PATTERNS))
_EXCL_RE = re.compile("|".join(EXCLUDE_PATTERNS))


def default_quant_filter(path: str, leaf) -> bool:
    """True -> quantize this leaf for rollout."""
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
        return False
    if _EXCL_RE.search(path):
        return False
    return bool(_QUANT_RE.search(path))


def _map_with_path(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def quantize_params(params: dict, precision: PrecisionConfig) -> dict:
    """BF16 training params -> rollout params (paper Fig 1, "weight
    synchronization phase").  Stacked (L, K, N) and (L, E, K, N) weights
    keep per-slice 128x128 blocks.  Router weights are cast to the
    configured router dtype instead."""
    if not precision.quantize_linears:
        return _apply_router_dtype(params, precision)
    return _map_with_path(lambda path, leaf: quantize_leaf(path, leaf, precision), params)


def quantize_leaf(path: str, leaf, precision: PrecisionConfig):
    """One leaf of `quantize_params` (its "/"-joined key path): the same
    function leaf by leaf, so a caller can sync a tree that never exists
    whole in bf16 (`models.Transformer.iter_params`)."""
    if "router" in path:
        return _router_cast(leaf, precision.router_dtype)
    if precision.quantize_linears and default_quant_filter(path, leaf):
        return ops.quantize_weight(leaf, E4M3, precision.scale_format)
    return leaf


def _router_cast(leaf: torch.Tensor, router_dtype: RouterDtype):
    if router_dtype == RouterDtype.FP32:
        return leaf.float()
    if router_dtype == RouterDtype.FP8:
        # router quantized along with the linears (ablation, paper fig 6)
        return ops.quantize_weight(leaf, E4M3, ScaleFormat.FP32)
    return leaf.to(torch.bfloat16)


def _apply_router_dtype(params: dict, precision: PrecisionConfig) -> dict:
    def convert(path, leaf):
        if "router" in path:
            return _router_cast(leaf, precision.router_dtype)
        return leaf

    return _map_with_path(convert, params)


def tree_leaves(tree):
    """The leaves of a nested-dict tree (params, grads, moments), in dict
    order; a `QuantizedTensor` is one leaf."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def count_quantized(params: dict) -> dict:
    """How much of the model went fp8 (leaf and byte counts)."""
    n_q = n_raw = bytes_q = bytes_raw = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, QuantizedTensor):
            n_q += 1
            bytes_q += leaf.data.numel() + leaf.scales.numel() * 4
        else:
            n_raw += 1
            bytes_raw += leaf.numel() * leaf.element_size()
    return dict(quantized_leaves=n_q, raw_leaves=n_raw,
                quantized_bytes=bytes_q, raw_bytes=bytes_raw)
