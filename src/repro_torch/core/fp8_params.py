"""Param-tree quantization — the substrate of weight sync (port of
`repro.core.fp8_params`).

Every RL step the BF16 training weights are blockwise-quantized and
handed to the rollout engine (paper §2.1.2).  The port's params are nested
dicts with the reference's key names and layer-stacked leaves, so the same
path regexes select the same leaves ("blocks/s0/attn/wq", ...).  Linear
weights become `QuantizedTensor`s through kernel 2 (one launch per stacked
leaf); embeddings, norms and the lm_head pass through by reference.
"""
from __future__ import annotations

import re

import torch

from repro_torch.core.precision import E4M3, PrecisionConfig
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
    synchronization phase").  Stacked (L, K, N) weights keep per-layer
    128x128 blocks.  (MoE router casts come with the MoE slice.)"""
    def convert(path, leaf):
        if precision.quantize_linears and default_quant_filter(path, leaf):
            return ops.quantize_weight(leaf, E4M3, precision.scale_format)
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
