"""Collectives of CUDA tensors over a gloo process group, through the host.

One card runs several ranks only over gloo (NCCL refuses two ranks on one
device), and gloo's transport takes host memory: handed a device pointer
it aborts the process (`writev ... Bad address`).  So where the default
group's CUDA backend is gloo, every collective of a CUDA tensor copies its
operand to the host, runs the CPU collective, and copies the result back:
`install` registers such CUDA kernels for the functional collectives
(`torch.ops._c10d_functional`, which DTensor's redistributions and
`distributed.compression` call), and `ring_shift` does the same for the
pipeline's point-to-point hop.  Only the collectives' bytes cross the
host; every computation stays on the card.  `HOST_COPIED` counts the
calls that went this way, by collective, and `HOST_BYTES` the bytes of
their operands.  With one rank per GPU and NCCL none of this applies and
nothing is copied.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

HOST_COPIED: collections.Counter = collections.Counter()
HOST_BYTES: collections.Counter = collections.Counter()

_OPS = ("all_reduce", "all_reduce_coalesced", "all_gather_into_tensor",
        "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
        "reduce_scatter_tensor_coalesced", "all_to_all_single", "broadcast")
_LIB = []


def needs_host(device) -> bool:
    """True when collectives of tensors on `device` go through gloo's
    CUDA path (a CUDA device, a default group whose CUDA backend is
    gloo)."""
    if torch.device(device).type != "cuda" or not dist.is_initialized():
        return False
    config = str(dist.get_backend_config())
    backends = dict(part.split(":") for part in config.split(",")) \
        if ":" in config else {"cuda": config}
    return backends.get("cuda") == "gloo"


def _wait(t):
    return torch.ops._c10d_functional.wait_tensor(t)


def _via_host(name: str):
    op = getattr(torch.ops._c10d_functional, name).default

    def impl(inp, *args):
        many = isinstance(inp, (list, tuple))      # the coalesced forms
        tensors = list(inp) if many else [inp]
        HOST_COPIED[name] += 1
        HOST_BYTES[name] += sum(t.numel() * t.element_size() for t in tensors)
        host = [t.cpu() for t in tensors]
        outs = op(host, *args) if many else [op(host[0], *args)]
        outs = [_wait(o).to(t.device) for o, t in zip(outs, tensors)]
        return outs if many else outs[0]

    return impl


def install() -> None:
    """Register the host-copying CUDA kernels of the functional
    collectives (idempotent).  Call only when `needs_host`."""
    if _LIB:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _OPS:
        if hasattr(torch.ops._c10d_functional, name):
            lib.impl(name, _via_host(name), "CUDA")
    _LIB.append(lib)


def ring_shift(y: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    """Send `y` to global rank `send_to` and receive a tensor like it from
    `recv_from` in one `batch_isend_irecv` (through the host when
    `needs_host(y.device)`)."""
    host = needs_host(y.device)
    src = y.cpu() if host else y.contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, send_to, group),
           dist.P2POp(dist.irecv, buf, recv_from, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if host:
        HOST_COPIED["batch_isend_irecv"] += 1
        HOST_BYTES["batch_isend_irecv"] += src.numel() * src.element_size()
        return buf.to(y.device)
    return buf
