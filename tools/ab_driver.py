"""The A/B driver that the single-kernel timing tools share.

A tool (`tools/time_gemm.py`, `tools/time_decode_attention.py`) names one
kernel source under `src/repro_torch/csrc/` and a worker that holds and
times that kernel in the tree it is given; `main` runs the worker over
several trees in turns, each in its own process, so two trees are compared
on one card:

    --run LABEL=PATH[:NAME=VALUE,...]   a checkout root (default: this one)
    --order LABEL,LABEL,...             the turns (default: each run once)
    --ptxas                             first, `nvcc -Xptxas -v`'s registers,
                                        shared memory and spills of each
                                        run's kernels in the tool's source

A `NAME=VALUE` rewrites `constexpr int NAME` in a copy of PATH's `src/`
under `.chip_scratch/variants/LABEL/`, which builds its own kernel
library, and fails loudly if the source has no such constant; a NAME the
tool lists among its settings goes to its worker instead.  Every other
argument goes to each worker as it is.  A worker prints one `ROW {json}`
line per measurement; the driver prints the tool's summary of it and the
row itself (`JSON LABEL {json}`).
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
CSRC = Path("src") / "repro_torch" / "csrc"


def variant(label: str, path: Path, source: str, consts: dict) -> Path:
    """`path` itself, or a copy of its `src/` with constants of `source`
    rewritten."""
    if not consts:
        return path
    dst = ROOT / ".chip_scratch" / "variants" / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(path / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / CSRC / source
    text = cu.read_text()
    for name, value in consts.items():
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if n != 1:
            sys.exit(f"{label}: no `constexpr int {name}` in {cu}")
    cu.write_text(text)
    return dst


def ptxas(trees: dict, source: str) -> None:
    """`nvcc -Xptxas -v` of each tree's `source`, all at once: one line
    per kernel with its registers, shared memory and spills."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    procs = {}
    for tree, label in trees.items():
        csrc = tree / CSRC
        procs[label] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-I", str(csrc), "-c", str(csrc / source), "-o", os.devnull],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for label, proc in procs.items():
        out, _ = proc.communicate()
        kernel, spills = None, ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
                if os.path.exists(filt):
                    kernel = subprocess.run([filt, kernel], capture_output=True,
                                            text=True).stdout.strip()
            elif "spill" in line:
                spills = line.split(":", 1)[-1].strip()
            elif "registers" in line:
                print(f"PTXAS {label} {kernel}: {line.split(':', 1)[-1].strip()}; {spills}",
                      flush=True)
        if proc.returncode != 0:
            print(f"PTXAS {label}: nvcc failed\n{out[-3000:]}", flush=True)


def main(tool: str, source: str, worker, summary, settings=()) -> int:
    """Run `tool` (the calling script's path) as the driver, or, with
    `--worker SRC`, as one turn: `worker(SRC, {NAME: VALUE}, argv)` with
    the run's settings and the arguments the driver does not know.
    `summary(row)` is the line printed for each `ROW` a turn prints."""
    doc = sys.modules["__main__"].__doc__ or ""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--run", action="append", default=[],
                    help="LABEL=PATH[:NAME=VALUE,...] (default: this checkout)")
    ap.add_argument("--order", help="comma-separated labels (default: each run once)")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--set", action="append", default=[], help=argparse.SUPPRESS)
    args, rest = ap.parse_known_args()
    if args.worker:
        worker(args.worker, dict(kv.split("=", 1) for kv in args.set), rest)
        return 0
    runs = {}
    for spec in args.run or [f"this={ROOT}"]:
        label, spec_rest = spec.split("=", 1)
        path, _, sets = spec_rest.partition(":")
        sets = dict(kv.split("=", 1) for kv in sets.split(",") if kv)
        py = {name: sets.pop(name) for name in settings if name in sets}
        runs[label] = (variant(label, (ROOT / path).resolve(), source, sets), py)
    order = args.order.split(",") if args.order else list(runs)
    if args.ptxas:
        ptxas({tree: label for label, (tree, _) in reversed(runs.items())}, source)
    failed = []
    for label in order:
        tree, py = runs[label]
        cmd = [sys.executable, tool, "--worker", str(tree / "src"),
               *(f"--set={k}={v}" for k, v in py.items()), *rest]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("ROW "):
                row = json.loads(line[4:])
                print(f"{label}: {summary(row)}", flush=True)
                print(f"JSON {label} " + json.dumps(row), flush=True)
        if proc.returncode != 0:
            print(f"{label}: failed (rc {proc.returncode})\n{proc.stderr[-4000:]}", flush=True)
            failed.append(label)
    return 1 if failed else 0
