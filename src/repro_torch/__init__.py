"""PyTorch / CUDA (Hopper) port of the FP8-RL stack.

The JAX package `repro` is the reference; this package mirrors its
subpackage and module names (`configs`, `data`, `core`, `kernels`,
`models`, `rl`) and never imports it or JAX.  Every TPU (Pallas) kernel on
the ported path is a hand-written CUDA C++ kernel under `csrc/`, built with
nvcc for sm_90a at first use (`kernels/build.py`).

Devices: every entry point runs on CUDA unless the caller passes
``device="cpu"`` (or CPU tensors).  Asked for no device on a machine
without CUDA, it raises — it never carries on silently on the CPU.
"""
from __future__ import annotations

import sys

import torch


def is_dtensor(x) -> bool:
    """True for a `torch.distributed.tensor.DTensor` (checked without
    importing that package: no DTensor exists before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given (a bare "cuda"
    becomes the current CUDA device, so devices compare equal to those of
    the tensors made on them), else the current CUDA device.

    Raises when no device is given and CUDA is absent, so a run meant for
    the card can never fall back to the CPU unnoticed.
    """
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
