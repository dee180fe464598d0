"""QKV scale calibration for the FP8 KV cache (port of
`repro.rl.calibration`, the `apply_kv_scales` half).

Inference-side calibration is `calculate_kv_scales=True` (prefill sets
the scales).  Trainer-side calibration ships per-layer scales that
`apply_kv_scales` installs into a fresh rollout cache; the calibration
pass itself (`calibrate_kv_scales`) comes with the training slice.
"""
from __future__ import annotations

import torch


def apply_kv_scales(cache: dict, scales: dict) -> dict:
    """Install {slot: {"k_scale": (R,), "v_scale": (R,)}} into `cache`,
    contiguous or paged (in place; the cache is returned)."""
    for name, sc in scales.items():
        slot = cache["slots"].get(name, {})
        if "kv" in slot:
            kv = slot["kv"]
            kv.k_scale.copy_(torch.as_tensor(sc["k_scale"]))
            kv.v_scale.copy_(torch.as_tensor(sc["v_scale"]))
    return cache
