#!/usr/bin/env python3
"""Kernel 3 (`fp8_gemm`) alone on the card, for A/B runs.

    python3 tools/time_gemm.py                          # this checkout
    python3 tools/time_gemm.py \\
        --run parent=.chip_scratch/parent --run change=. \\
        --order parent,change,change,parent --ptxas [--shapes wg,wd]

Runs, turns, `NAME=VALUE` rewrites of `csrc/fp8_gemm.cu`'s `constexpr
int` constants (`LABEL=PATH:kSmallStages=4`) and `--ptxas`: see
`tools/ab_driver.py`.

At each of the four (K, N) of qwen3-8b's linears (`--shapes` picks
leaves of `chip_smoke.GEMM_SHAPES`: wq, wk, wg, wd) a turn makes a
seeded 36-layer weight stack with the run's own `ops.quantize_weight`
(so each tree gets the layout its sync makes), and at each M of
`chip_smoke.py`'s `GEMM_MS` holds the run's kernel to its plain version
and times it with this checkout's `chip_smoke.py` (`gemm_weight`,
`hold_gemm`, `gemm_row`: the same hold, cold-weight rotation, yardstick
and bound as phase 6).  Then it times the run's weight-sync quantizer
(kernel 2 through `ops.quantize_weight`, `chip_smoke.sync_quant_ms`)
over the seven stacked leaves of a qwen3-8b sync, so a parent turn gives
the cost of the layout the parent's sync wrote.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import ab_driver

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 36
# a sync's quantized leaves of each timed shape: wo shares wq's, wv wk's,
# wu wg's
SYNC_LEAVES = {"wq": 2, "wk": 2, "wg": 2, "wd": 1}


def worker(src: str, settings: dict, argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes")
    shapes = ap.parse_args(argv).shapes
    shapes = shapes.split(",") if shapes else None
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fp8_quant as fq

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda", 0)
    build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    for (_, name), (k, n) in cs.GEMM_SHAPES.items():
        if shapes and name not in shapes:
            continue
        stack = cs.gemm_weight(dev, gen, k, n, layers=LAYERS)
        first = stack.layer(0)
        x = torch.randn((max(cs.GEMM_MS), k), generator=gen, device=dev).to(torch.bfloat16)
        a, a_s = fq.quantize_activation_kernel(x)
        for m in cs.GEMM_MS:
            err = cs.hold_gemm(a[:m], first.data, a_s[:m], first.scales,
                               f"M {m} K {k} N {n}")
            row = dict(m=m, k=k, n=n, weight=name, max_abs_err=err,
                       **cs.gemm_row(stack, m, gen))
            print("ROW " + json.dumps(row), flush=True)
        del stack, first
        torch.cuda.empty_cache()
    leaves = [(LAYERS, k, n) for (_, name), (k, n) in cs.GEMM_SHAPES.items()
              for _ in range(SYNC_LEAVES[name])]
    print("ROW " + json.dumps(dict(sync_leaves=len(leaves),
                                   sync_quant_device_ms=cs.sync_quant_ms(leaves, gen))),
          flush=True)


def summary(row: dict) -> str:
    if "sync_leaves" in row:
        return (f"weight sync: kernel 2 over {row['sync_leaves']} stacked leaves, device ms "
                f"{row['sync_quant_device_ms']:.3f}")
    return (f"M {row['m']} K {row['k']} N {row['n']}: device ms {row['device_ms']:.4f}, "
            f"ms {row['ms']:.4f}, bound {row['bound_ms']:.4f}, _scaled_mm "
            f"{row['scaled_mm_device_ms']}, bf16 mm {row['bf16_mm_device_ms']:.4f}, "
            f"err {row['max_abs_err']:.2e}")


if __name__ == "__main__":
    sys.exit(ab_driver.main(__file__, "fp8_gemm.cu", worker, summary))
