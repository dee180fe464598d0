#!/usr/bin/env python3
"""Kernel 1 (`quantize_activation_kernel`) alone and in front of kernel 3,
on the card, for A/B runs.

    python3 tools/time_quant.py                         # this checkout
    python3 tools/time_quant.py \\
        --run parent=.chip_scratch/parent --run change=. \\
        --order parent,change,change,parent --ptxas [--pairs wq,wk] [--step]

Runs, turns, `NAME=VALUE` rewrites of `csrc/fp8_quant.cu`'s `constexpr
int` constants (`LABEL=PATH:kQuantUnroll=2`) and `--ptxas`: see
`tools/ab_driver.py`.

A turn holds the run's kernel 1 bit-equal to its plain version at every
shape of `chip_smoke.QUANT_ACT_HOLDS`, then times it at
`chip_smoke.QUANT_ACT_MS` (device ms, host-paced ms, the bound, and the
host microseconds of one `ops.quantize_activation` call), and the pair
kernel 1 + kernel 3 at M `chip_smoke.PAIR_M` over a seeded 36-layer
weight stack of each of qwen3-8b's four (K, N) (`--pairs` picks leaves of
`chip_smoke.GEMM_SHAPES`), made by the run's own `ops.quantize_weight`.
With `--step`, one `generate` decode step of full-width qwen3-8b
(random weights from a seed, synced by the run's own code) is profiled
too: its wall and device-busy ms, kernels, and kernel 1's device ms.
Every hold and time is this checkout's `chip_smoke.py` helper
(`hold_quant_act`, `quant_row`, `pair_row`, `profile_decode_step`): one
yardstick for every run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import ab_driver

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 36
STEPS = 16          # `--step`: decode steps whose wall median is reported


def worker(src: str, settings: dict, argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs")
    ap.add_argument("--step", action="store_true")
    args = ap.parse_args(argv)
    pairs = args.pairs.split(",") if args.pairs else None
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.core import precision
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda", 0)
    build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    for (m, k), dtype, fp8, fmt in cs.QUANT_ACT_HOLDS:
        x = (torch.randn((m, k), generator=gen, device=dev) * 3.0).to(getattr(torch, dtype))
        cs.hold_quant_act(x, getattr(precision, fp8), precision.ScaleFormat[fmt])
    for m in cs.QUANT_ACT_MS:
        row = dict(kernel="quant_act", m=m, k=4096, **cs.quant_row(m, 4096, gen, dev))
        print("ROW " + json.dumps(row), flush=True)
    for (_, name), (k, n) in cs.GEMM_SHAPES.items():
        if pairs and name not in pairs:
            continue
        stack = cs.gemm_weight(dev, gen, k, n, layers=LAYERS)
        row = dict(kernel="pair", m=cs.PAIR_M, k=k, n=n, weight=name,
                   **cs.pair_row(stack, cs.PAIR_M, gen))
        print("ROW " + json.dumps(row), flush=True)
        del stack
        torch.cuda.empty_cache()
    if args.step:
        print("ROW " + json.dumps(dict(kernel="step", **decode_step(cs, dev))), flush=True)


def decode_step(cs, dev) -> dict:
    """One `generate` decode step of full qwen3-8b under `PrecisionConfig()`
    (8 ragged prompts of 64-128 tokens, `chip_smoke.profile_decode_step`):
    wall ms, device busy ms, kernels, and kernel 1's device ms in it; and
    the median wall ms of STEPS - 1 more steps (the first is a warm-up)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.models import Transformer
    from repro_torch.rl import sync_policy_weights
    cfg, prec = get_config("qwen3-8b"), PrecisionConfig()
    model = Transformer(cfg, dev)
    roll, _ = sync_policy_weights(model.init_params(cs.SEED), prec)
    torch.cuda.empty_cache()
    prompts, lengths = cs.make_prompts(np.random.default_rng(cs.SEED))
    row = cs.profile_decode_step(model, roll, prec, prompts, lengths, dev)
    cache = model.init_cache(len(prompts), prompts.shape[1] + STEPS + 1, prec, page_size=16)
    logits, cache = model.prefill(roll, {"tokens": torch.from_numpy(prompts).to(dev),
                                         "lengths": torch.from_numpy(lengths).to(dev)},
                                  cache, prec)
    walls = []
    for _ in range(STEPS):
        (logits, cache), ms = cs._sync_ms(model.decode_step, roll, logits.argmax(-1), cache, prec)
        walls.append(ms)
    row["decode_step_wall_ms_median"] = float(np.median(walls[1:]))
    return row


def summary(row: dict) -> str:
    if row["kernel"] == "step":
        return (f"decode step: wall ms {row['decode_step_wall_ms_median']:.1f} (median of "
                f"{STEPS - 1}), device busy ms "
                f"{row['decode_step_device_busy_ms']:.3f}, kernels "
                f"{row['decode_step_device_kernels']}, kernel 1 device ms "
                f"{row['decode_step_quant_act_ms']:.3f}, kernel 3 device ms "
                f"{row['decode_step_fp8_gemm_ms']:.3f}")
    if row["kernel"] == "quant_act":
        return (f"quant_act ({row['m']}, {row['k']}): device ms {row['device_ms']:.4f}, ms "
                f"{row['ms']:.4f}, bound {row['bound_ms']:.4f}, host us "
                f"{row['host_us']:.1f}")
    return (f"pair M {row['m']} K {row['k']} N {row['n']}: device ms {row['device_ms']:.4f} "
            f"(alone {row['quant_act_device_ms']:.4f} + {row['fp8_gemm_device_ms']:.4f}; "
            f"kernel 3 behind a spacer {row['fp8_gemm_apart_device_ms']:.4f} - "
            f"{row['spacer_device_ms']:.4f}), "
            f"ms {row['ms']:.4f}, bound {row['bound_ms']:.4f}, host us {row['host_us']:.1f}")


if __name__ == "__main__":
    sys.exit(ab_driver.main(__file__, "fp8_quant.cu", worker, summary))
