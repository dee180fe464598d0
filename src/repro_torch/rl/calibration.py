"""QKV scale calibration for the FP8 KV cache (port of
`repro.rl.calibration`, paper §2.3.1).

Inference-side calibration is `calculate_kv_scales=True` (prefill sets
the scales).  Trainer-side calibration (NeMo-RL's paradigm): after each
update the trainer runs a bf16 prefill of a calibration batch through the
updated policy (`calibrate_kv_scales`), and `apply_kv_scales` installs the
per-layer scales into the next rollout's fresh cache, which then runs
with `calculate_kv_scales=False` (`trainer_side_precision`).
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import BF16_ROLLOUT, PrecisionConfig
from repro_torch.core.quant import calibrate_scale
from repro_torch.models.transformer import Transformer


def calibrate_kv_scales(params: dict, calib_inputs: dict, cfg) -> dict:
    """Run a bf16 prefill over `calib_inputs` ({"tokens": (B, T),
    "lengths": (B,)}) into a contiguous bf16 cache of T positions and
    harvest each layer's K/V amax — over every cached position, padding
    included, as the reference does.  Returns {slot: {"k_scale": (R,),
    "v_scale": (R,)}} (amax x 1.05 / 448) for the attention slots, on the
    params' device."""
    model = Transformer(cfg, params["emb"].device)
    b, t = calib_inputs["tokens"].shape
    with torch.no_grad():
        cache = model.init_cache(b, t, BF16_ROLLOUT)
        model.prefill(params, calib_inputs, cache, BF16_ROLLOUT)
        scales = {}
        for name, slot in cache["slots"].items():
            if "kv" not in slot:        # an SSM slot holds no KV
                continue
            kv = slot["kv"]
            amax = {f: getattr(kv, f).float().abs().flatten(1).amax(dim=1)
                    for f in ("k", "v")}
            scales[name] = {f"{f}_scale": calibrate_scale(a, margin=1.05)
                            for f, a in amax.items()}
    return scales


def apply_kv_scales(cache: dict, scales: dict) -> dict:
    """Install {slot: {"k_scale": (R,), "v_scale": (R,)}} into `cache`,
    contiguous or paged (in place; the cache is returned).  Slots without
    KV (SSM) are left as they are."""
    for name, sc in scales.items():
        slot = cache["slots"].get(name, {})
        if "kv" in slot:
            kv = slot["kv"]
            kv.k_scale.copy_(torch.as_tensor(sc["k_scale"]))
            kv.v_scale.copy_(torch.as_tensor(sc["v_scale"]))
    return cache


def trainer_side_precision(precision: PrecisionConfig) -> PrecisionConfig:
    """Rollout precision for the trainer-side paradigm: quantized KV but no
    per-prefill recalibration (scales come from the trainer)."""
    return precision.replace(calculate_kv_scales=False)
