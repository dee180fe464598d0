#!/usr/bin/env python3
"""Kernel 6 (`fp8_decode_attention`) alone on the card, for A/B runs.

    python3 tools/time_decode_attention.py                    # this checkout
    python3 tools/time_decode_attention.py \\
        --run parent=.chip_scratch/parent --run change=. \\
        --order parent,change,change,parent --ptxas

Each run is a checkout root (`LABEL=PATH`), optionally with `constexpr
int` constants of its `csrc/fp8_decode.cu` rewritten
(`LABEL=PATH:kDecStages=6,kDecWarps=8`) or its `SPLIT_KEYS` set
(`LABEL=PATH:SPLIT_KEYS=512`): a run with rewritten CUDA constants is a
copy of PATH's `src/` under `.chip_scratch/variants/LABEL/`, which builds
its own kernel library.  The runs go in `--order`, each in its own
process, so two trees are compared on one card in turns.

At each of kernel 6's phase-6 shapes (B 8, S 1057 with 7a-like ragged
lengths; B 8, S 32768 all live; B 1, S 524288 at length 524284, one
layer of the LONG_500K cell; KVH 8, G 4, D 128, an e4m3 cache from a
seed) a run holds the run's kernel to its plain version and times it
with this checkout's `chip_smoke.py` (`contiguous_case`, `hold_decode`,
`decode_row`: the same hold, yardstick and bound as phase 6) and prints
one `ROW {json}` line.  `--ptxas` first prints `nvcc -Xptxas -v`'s
registers and spills for the kernel 6 instantiations of each run's
source.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((8, 1057), (8, 32768), (1, 524288))


def worker(src: str, split_keys: int | None) -> None:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fp8_kv_attention as fa

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if split_keys:
        fa.SPLIT_KEYS = split_keys
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


def variant(label: str, path: Path, consts: dict) -> Path:
    """`path` itself, or a copy of its `src/` with constants rewritten."""
    if not consts:
        return path
    dst = ROOT / ".chip_scratch" / "variants" / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(path / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src" / "repro_torch" / "csrc" / "fp8_decode.cu"
    text = cu.read_text()
    for name, value in consts.items():
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if n != 1:
            sys.exit(f"{label}: no `constexpr int {name}` in {cu}")
    cu.write_text(text)
    return dst


def ptxas(trees: dict) -> None:
    """`nvcc -Xptxas -v` of each tree's kernel 6 source, all at once: one
    line per kernel with its registers and spills."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for tree, label in trees.items():
        csrc = tree / "src" / "repro_torch" / "csrc"
        procs[label] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-I", str(csrc), "-c", str(csrc / "fp8_decode.cu"),
             "-o", os.devnull], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for label, proc in procs.items():
        out, _ = proc.communicate()
        kernel, spills = None, ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '\S*?(decode_(?:split|combine)_kernel)(\S*)'",
                          line)
            if m:
                kernel = m.group(1)
                tmpl = re.findall(r"Li(\d+)E", m.group(2))
                if tmpl:
                    kernel += "<kv " + tmpl[0] + ", D " + tmpl[1] + ", halves " + tmpl[2] + ">"
            elif "spill" in line:
                spills = line.split(":", 1)[-1].strip()
            elif "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"PTXAS {label} {kernel}: {regs} registers, {spills}", flush=True)
        if proc.returncode != 0:
            print(f"PTXAS {label}: nvcc failed\n{out[-3000:]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", action="append", default=[],
                    help="LABEL=PATH[:NAME=VALUE,...] (default: this checkout)")
    ap.add_argument("--order", help="comma-separated labels (default: each run once)")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--split-keys", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.split_keys)
        return 0
    runs = {}
    for spec in args.run or [f"this={ROOT}"]:
        label, rest = spec.split("=", 1)
        path, _, sets = rest.partition(":")
        sets = dict(kv.split("=") for kv in sets.split(",") if kv)
        split_keys = sets.pop("SPLIT_KEYS", None)
        runs[label] = (variant(label, (ROOT / path).resolve(), sets), split_keys)
    order = args.order.split(",") if args.order else list(runs)
    if args.ptxas:
        ptxas({tree: label for label, (tree, _) in reversed(runs.items())})
    failed = []
    for label in order:
        tree, split_keys = runs[label]
        cmd = [sys.executable, __file__, "--worker", str(tree / "src")]
        if split_keys:
            cmd += ["--split-keys", split_keys]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("ROW "):
                row = json.loads(line[4:])
                print(f"{label}: B {row['b']} S {row['s_max']}: ms {row['ms']:.4f}, device ms "
                      f"{row['device_ms']:.4f}, SDPA {row['library_ms']:.4f} / "
                      f"{row['library_device_ms']:.4f}, bound {row['bound_ms']:.4f}, "
                      f"splits {row['splits']}, err {row['max_abs_err']:.2e}", flush=True)
                print(f"JSON {label} " + json.dumps(row), flush=True)
        if proc.returncode != 0:
            print(f"{label}: failed (rc {proc.returncode})\n{proc.stderr[-4000:]}", flush=True)
            failed.append(label)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
