"""Dynamic weight synchronization (port of `repro.rl.weight_sync`).

Every RL step the BF16 training weights are quantized to blockwise FP8 and
handed to the rollout engine (paper §2.1.2, Fig 1).  Here that is
`core.fp8_params.quantize_params` on the params' own device — kernel 2 on
the card, one launch per stacked linear leaf.  The rollout params share
every unquantized leaf (embedding, norms, lm_head) with the training
params by reference.  The versioned `WeightSyncer` waits for the fleet
slice.
"""
from __future__ import annotations

import time
from typing import Tuple

import torch

from repro_torch.core.fp8_params import count_quantized, quantize_params
from repro_torch.core.precision import PrecisionConfig


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def sync_policy_weights(train_params: dict, precision: PrecisionConfig
                        ) -> Tuple[dict, dict]:
    """BF16 train params -> rollout params.  Returns (params, stats); the
    stats' `sync_ms` is host time up to a device synchronize."""
    t0 = time.perf_counter()
    if not precision.any_fp8_rollout:
        return train_params, {"sync_ms": 0.0, "quantized_leaves": 0}
    rollout_params = quantize_params(train_params, precision)
    leaf = _first_leaf(train_params)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    stats = dict(count_quantized(rollout_params))
    stats["sync_ms"] = (time.perf_counter() - t0) * 1e3
    return rollout_params, stats
