"""Parameter bridge from the reference's pytree to the port's params.

`params_from_numpy` takes the reference's parameter pytree as nested
dicts of numpy arrays — e.g. `jax.tree.map(np.asarray, params)` — with
leaves stacked over the repeat axis (`blocks/s0/attn/wq` is (R, K, N)),
and returns the port's param dict with the same keys on `device`.
bf16 and fp8 arrays cross as raw bits (`arr.view(np.uint16)` ->
`torch.from_numpy` -> `.view(torch.bfloat16)`), which needs no
`ml_dtypes`.  Quantized leaves — anything with `.data` and `.scales`
(the reference's `QuantizedTensor` after `tree.map`), or a plain
`(data, scales)` pair — become the port's `QuantizedTensor`.
`kv_cache_from_numpy` carries a reference contiguous `KVCache` across the
same way (raw fp8 bytes and f32 scales, one layer or stacked by layer), so
a test can start the port's decode from the reference's exact cache;
`ssm_state_from_numpy` does the same for an `SSMState` (h f32, conv tail
bf16).  SSM params (f32 `dt_bias`, `a_log`, `D` among them), an enc-dec
model's encoder (`enc/blocks/...`, `enc/final_norm_scale`) and cross
attention (`blocks/s0/cross/...`), and a frontend's `frontend/w_patch`
cross as any other leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMState

# numpy dtype names of the ml_dtypes types -> (raw-bit view, torch dtype)
_RAW_BITS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.require(arr, requirements=["C_CONTIGUOUS", "WRITEABLE"])
    raw = _RAW_BITS.get(arr.dtype.name)
    if raw is not None:
        bits, dtype = raw
        return torch.from_numpy(arr.view(bits)).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


def _quantized(data, scales, block, device) -> QuantizedTensor:
    data = tensor_from_numpy(data, device)
    if block is None:   # weights: 128x128 over the last two dims
        block = (1,) * (data.dim() - 2) + (128, 128)
    return QuantizedTensor(data, tensor_from_numpy(scales, device), tuple(block))


def params_from_numpy(tree, device=None):
    """Reference pytree (numpy leaves) -> the port's params on `device`."""
    device = resolve_device(device)
    return _convert(tree, device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if hasattr(tree, "scales") and hasattr(tree, "data"):
        return _quantized(tree.data, tree.scales, getattr(tree, "block", None),
                          device)
    if isinstance(tree, tuple) and len(tree) == 2:
        return _quantized(tree[0], tree[1], None, device)
    return tensor_from_numpy(tree, device)


def kv_cache_from_numpy(kv, device=None) -> KVCache:
    """A reference `KVCache` with numpy leaves (`jax.tree.map(np.asarray,
    cache)`: k/v (B, S, KVH, D) or (R, B, S, KVH, D), scales () or (R,))
    -> the port's `KVCache` on `device`, bit for bit."""
    device = resolve_device(device)
    return KVCache(*(tensor_from_numpy(getattr(kv, f), device)
                     for f in ("k", "v", "k_scale", "v_scale")))


def ssm_state_from_numpy(state, device=None) -> SSMState:
    """A reference `SSMState` with numpy leaves (h (.., B, H, P, N) f32,
    conv (.., B, W-1, C) bf16, one layer or stacked by layer) -> the
    port's `SSMState` on `device`, bit for bit."""
    device = resolve_device(device)
    return SSMState(tensor_from_numpy(state.h, device),
                    tensor_from_numpy(state.conv, device))
