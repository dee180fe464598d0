"""Build and load the port's CUDA kernels (no counterpart in `repro`).

Every `csrc/*.cu` is compiled by nvcc for sm_90a — one nvcc process per
source, all started together — and linked into one shared library with a
plain C interface, loaded with ctypes.  The build happens at first use,
into `build/kernels/` at the root of the checkout (git-ignored), keyed by
a hash of the sources and flags, so a fresh checkout builds once and
later processes reuse the library.  A failed build raises; there is no
fallback.

Each C entry point launches one kernel on the stream it is given and
returns `cudaGetLastError()`; `launch` raises when that is not 0 and
counts the launch in `LAUNCHES` — the only place a count is taken.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -O3, IEEE division and denormals (no fast-math: the quantizers must
# match the reference bit for bit)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C signatures: every pointer and the trailing stream are c_void_p
SIGNATURES = {
    "fp8rl_quant_act": [_P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P],
    "fp8rl_quant_weight": [_P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _P],
    "fp8rl_gemm": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _P],
    "fp8rl_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                           _I32, _I32, _I32, _I32, _F32, _P],
    "fp8rl_paged_prefill": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                            _I32, _I32, _I32, _I32, _I32, _I32, _F32, _P],
    "fp8rl_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                     _I32, _I64, _I64, _I32, _I32, _I32, _F32, _P],
    "fp8rl_decode_geometry": [_I32, _I32, _I32, _P],
}

# launches per kernel since the last reset (chip_smoke.py reads these)
LAUNCHES = {"quant_act": 0, "quant_weight": 0, "fp8_gemm": 0,
            "paged_decode": 0, "paged_prefill": 0, "decode": 0}

# the kernel of the last launch (in stream order, on one stream): kernel
# 3 launches as a programmatic dependent only behind kernels that never
# write its weights
LAST_LAUNCH = None

_LIB = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link them; returns the .so."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libfp8rl_{_digest()}.so"
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # one builder per checkout
        if lib_path.exists():
            return lib_path
        nvcc = _nvcc()
        objs, procs = [], []
        for src in _sources():
            obj = BUILD_DIR / f"{src.stem}.{lib_path.stem}.o"
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = lib_path.with_suffix(".tmp")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry `entry` on `device`'s current stream; raise on a
    launch error; count one launch of `kernel`.  The device is entered
    only when it is not the current one (a launch is host-bound at decode:
    entering costs more than the rest of it)."""
    fn = getattr(_LIB or library(), entry)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    global LAST_LAUNCH
    LAST_LAUNCH = kernel
    LAUNCHES[kernel] += 1
