#!/usr/bin/env python3
"""Kernel 6 (`fp8_decode_attention`) alone on the card, for A/B runs.

    python3 tools/time_decode_attention.py                    # this checkout
    python3 tools/time_decode_attention.py \\
        --run parent=.chip_scratch/parent --run change=. \\
        --order parent,change,change,parent --ptxas

Runs, turns, `NAME=VALUE` rewrites of `csrc/fp8_decode.cu`'s `constexpr
int` constants (`LABEL=PATH:kDecStages=6,kDecWarps=8`) and `--ptxas`:
see `tools/ab_driver.py`.  `SPLIT_KEYS=N` in a run sets the split width
of that run's wrapper instead (`LABEL=PATH:SPLIT_KEYS=512`).

At each of kernel 6's phase-6 shapes (B 8, S 1057 with 7a-like ragged
lengths; B 8, S 32768 all live; B 1, S 524288 at length 524284, one
layer of the LONG_500K cell; KVH 8, G 4, D 128, an e4m3 cache from a
seed) a turn holds the run's kernel to its plain version and times it
with this checkout's `chip_smoke.py` (`contiguous_case`, `hold_decode`,
`decode_row`: the same hold, yardstick and bound as phase 6) and prints
one `ROW {json}` line.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import ab_driver

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((8, 1057), (8, 32768), (1, 524288))


def worker(src: str, settings: dict, argv: list[str]) -> None:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fp8_kv_attention as fa

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if "SPLIT_KEYS" in settings:
        fa.SPLIT_KEYS = int(settings["SPLIT_KEYS"])
    dev = torch.device("cuda", 0)
    build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, s_len in SHAPES:
        if s_len == 1057:
            lens = rng.integers(512 + 32, 1024 + 33, size=b)
        else:
            lens = np.full(b, s_len if b > 1 else s_len - 4)
        args = cs.contiguous_case(dev, gen, b, s_len, lens)
        results = {"decode": {}}
        cs.hold_decode(args, f"B {b} S {s_len}", results)
        row = dict(b=b, s_max=s_len, splits=list(fa.decode_splits(s_len, sms)),
                   max_abs_err=results["decode"]["max_abs_err"], **cs.decode_row(args))
        print("ROW " + json.dumps(row), flush=True)
        del args
        torch.cuda.empty_cache()


def summary(row: dict) -> str:
    return (f"B {row['b']} S {row['s_max']}: ms {row['ms']:.4f}, device ms "
            f"{row['device_ms']:.4f}, SDPA {row['library_ms']:.4f} / "
            f"{row['library_device_ms']:.4f}, bound {row['bound_ms']:.4f}, "
            f"splits {row['splits']}, err {row['max_abs_err']:.2e}")


if __name__ == "__main__":
    sys.exit(ab_driver.main(__file__, "fp8_decode.cu", worker, summary,
                            settings=("SPLIT_KEYS",)))
