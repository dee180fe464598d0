"""FP8-compressed gradient sums (port of `repro.distributed.compression`).

The same blockwise E4M3 + f32-scale format as the rollout weights halves
the bytes on the wire for the data-parallel gradient sum:

    local grad --kernel 1--> fp8 payload + 1x128 f32 scales
    all_gather(payload, scales)          # 1 + 4/128 bytes/elem, not 2
    dequantize + sum locally in f32, in rank order

The quantization error is bounded by the E4M3 roundoff of each
*contribution* (not of the sum).  Each rank flattens its tensor to one
(1, n) row, pads n to a multiple of 128, widens it to f32 (as the
reference does) and quantizes it through `kernels.ops.quantize_activation`:
kernel 1 on the card, its plain version on the CPU.  The payload crosses
as `uint8` (gloo has no float8 dtypes).  Every rank computes the same sum
from the same gathered bytes, so the result is equal on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.precision import E4M3
from repro_torch.distributed import host_collectives
from repro_torch.kernels import ops


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(world, *t.shape): every rank's `t`, in rank order."""
    if host_collectives.needs_host(t.device):
        host_collectives.install()
    world = dist.get_world_size(group)
    c10d = torch.ops._c10d_functional
    out = c10d.all_gather_into_tensor(t.contiguous(), world,
                                      (group or dist.group.WORLD).group_name)
    return c10d.wait_tensor(out).reshape(world, *t.shape)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (the default group when
    None), with fp8-compressed contributions, in x.dtype."""
    orig_shape = x.shape
    flat = x.reshape(1, -1)
    pad = (-flat.shape[1]) % 128
    if pad:
        flat = F.pad(flat, (0, pad))
    qt = ops.quantize_activation(flat.float(), fp8_dtype=E4M3)
    payload = _all_gather(qt.data.view(torch.uint8), group).view(qt.data.dtype)
    scales = _all_gather(qt.scales, group)                   # (W, 1, n/128)
    expanded = torch.repeat_interleave(scales, 128, dim=-1)
    total = payload[0].float() * expanded[0]
    for r in range(1, payload.shape[0]):
        total = total + payload[r].float() * expanded[r]
    total = total.reshape(-1)[: x.numel()].reshape(orig_shape)
    return total.to(x.dtype)


def compressed_pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    world = dist.get_world_size(group)
    return (compressed_psum(x.float(), group) / world).to(x.dtype)


def comm_bytes(n_elems: int, world: int, compressed: bool) -> int:
    """Wire bytes per device for one all-gather-based all-reduce."""
    per_elem = 1 + 4 / 128 if compressed else 2   # fp8+scales vs bf16
    return int(n_elems * per_elem * (world - 1))
