"""Dynamic weight synchronization (port of `repro.rl.weight_sync`).

Every RL step the BF16 training weights are quantized to blockwise FP8 and
handed to the rollout engine (paper §2.1.2, Fig 1).  Here that is
`core.fp8_params.quantize_params` on the params' own device — kernel 2 on
the card, one launch per stacked linear leaf.  The rollout params share
every unquantized leaf (embedding, norms, lm_head) with the training
params by reference.

For the live-updating fleet, `WeightSyncer` wraps the same transform in
a monotonic version counter: each `push()` requantizes the current train
params and returns a `VersionedWeights` the serving front-end installs
into every replica at a step boundary (`ServingFrontend.update_weights`).
Tokens generated after the install carry the new version — the per-token
attribution that version-aware TIS/MIS correction keys on.  The
reference's `rollout_shardings` (a GSPMD resharding of the quantized
tree) has no meaning on one card and is left out.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import torch

from repro_torch.core.fp8_params import _map_with_path, count_quantized, quantize_params
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quant import QuantizedTensor, quantization_rel_error


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def sync_policy_weights(train_params: dict, precision: PrecisionConfig
                        ) -> Tuple[dict, dict]:
    """BF16 train params -> rollout params.  Returns (params, stats); the
    stats' `sync_ms` is host time up to a device synchronize."""
    t0 = time.perf_counter()
    if not precision.any_fp8_rollout and precision.router_dtype.value == "bf16":
        return train_params, {"sync_ms": 0.0, "quantized_leaves": 0}
    rollout_params = quantize_params(train_params, precision)
    leaf = _first_leaf(train_params)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    stats = dict(count_quantized(rollout_params))
    stats["sync_ms"] = (time.perf_counter() - t0) * 1e3
    return rollout_params, stats


@dataclasses.dataclass(frozen=True)
class VersionedWeights:
    """One requantized weight snapshot, stamped with the monotonic
    version the fleet will attribute its tokens to."""

    params: object
    version: int
    stats: dict


class WeightSyncer:
    """Version-stamped weight sync for the live-updating fleet.

    Owns the monotonic version counter.  The fleet starts at version 0
    (the checkpoint the engines were built from); every push bumps it
    and requantizes, so version k's tokens were sampled from the weights
    of the k-th sync.  Versions never repeat or go backwards —
    `ServingFrontend.update_weights` and `ServingEngine.install_weights`
    both enforce monotonicity on their side too.

    `push_to()` is the failure-aware spelling: the version is minted
    only AFTER the fleet accepts the push.  The fleet owns the retries
    (`ServingFrontend.update_weights` retries each replica and
    quarantines one that keeps failing); if the install raises anyway,
    `self.version` is untouched, so the next successful push reuses the
    same number — the fleet never sees a skipped or repeated version.
    The reference's `start_version`, `install_retries` and `backoff_s`
    (a second retry loop around the front end's own) are left out.
    """

    def __init__(self, precision: PrecisionConfig):
        self.precision = precision
        self.version = 0

    def push(self, train_params) -> VersionedWeights:
        """Requantize `train_params` and mint the next weight version.

        Fire-and-forget spelling: the caller owns delivery.  Use
        `push_to(fleet)` when a front-end should absorb install
        failures without desyncing the version counter."""
        params, stats = sync_policy_weights(train_params, self.precision)
        self.version += 1
        stats["weight_version"] = self.version
        return VersionedWeights(params=params, version=self.version,
                                stats=stats)

    def push_to(self, train_params, fleet) -> VersionedWeights:
        """Requantize and install onto `fleet` (anything with an
        ``update_weights(params, version)``, e.g. `ServingFrontend`),
        committing the version bump only on success."""
        params, stats = sync_policy_weights(train_params, self.precision)
        version = self.version + 1
        fleet.update_weights(params, version)
        self.version = version
        stats["weight_version"] = self.version
        return VersionedWeights(params=params, version=self.version,
                                stats=stats)


def weight_quant_error(train_params: dict, rollout_params: dict,
                       top_n: int = 5) -> dict:
    """Per-leaf relative quantization error (monitoring): the `top_n`
    worst leaves by "/"-joined path, and the mean over quantized leaves."""
    errs = {}

    def visit(path, roll_leaf):
        if isinstance(roll_leaf, QuantizedTensor):
            train_leaf = train_params
            for k in path.split("/"):
                train_leaf = train_leaf[k]
            errs[path] = float(quantization_rel_error(train_leaf, roll_leaf))

    _map_with_path(visit, rollout_params)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:top_n]
    return {"worst": worst,
            "mean_rel_err": sum(errs.values()) / max(len(errs), 1)}
