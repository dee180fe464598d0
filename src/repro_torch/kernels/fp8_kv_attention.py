"""Paged decode attention over an FP8 KV pool: kernel 4 of the port.

Port of `repro.kernels.fp8_kv_attention.fp8_paged_decode_attention`
(repro/kernels/fp8_kv_attention.py:285; body `_paged_decode_attn_kernel`
:236, `_live_block_counts` :228, `_clamped_kv_map` :81, `_flash_update`
:89, `_deq` :73) and of its oracle `ref.fp8_paged_decode_attention_ref`.

GQA decode: q (B, KVH, G, D) attends over pools (N+1, BS, KVH, D) through
per-slot tables (B, W) of *physical* rows, masked by `lengths`, with one
f32 scale per pool for K and one for V.  Table entries at or past
nb = clip(ceil(len / BS), 1, W) are never dereferenced, and an idle slot
(len 0) gives exact zeros.  It runs at every decode step in every layer.
On the H100 it is bound by the bytes of the live K/V rows;
`csrc/fp8_paged_decode.cu` gives the design.

`fp8_paged_decode_attention_ref` is the plain version: it dequantizes like
`_deq` (f32 multiply, then a bf16 rounding), reads only the clamped live
entries, and takes the softmax in the kernel's masked form (-1e30 fill,
zeroed probabilities, max(l, 1e-30) denominator).  The CPU path and the
on-card comparisons use it; the card's main path never does.  The
contiguous-cache kernel (`fp8_decode_attention`) and the chunked-prefill
kernel (`fp8_paged_prefill_attention`) are not ported yet (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import E4M3
from repro_torch.kernels import build
from repro_torch.kernels.fp8_quant import DTYPE_CODE

_NEG_INF = -1e30
MAX_G, MAX_D = 16, 256


def live_block_counts(lengths: torch.Tensor, bs: int, n_w: int) -> torch.Tensor:
    """nb[i] = clip(ceil(lengths[i] / bs), 1, n_w)."""
    return torch.clamp((lengths.long() + bs - 1) // bs, 1, n_w)


def _deq(tile: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (tile.float() * scale.float()).to(torch.bfloat16).float()


def fp8_paged_decode_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   block_tables, lengths, sm_scale=None):
    """Plain version of kernel 4 (same arguments, same output)."""
    b, kvh, g, d = q.shape
    n_w, bs = block_tables.shape[1], k_pool.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    nb = live_block_counts(lengths, bs, n_w)
    w = torch.arange(n_w, device=q.device)
    # `_clamped_kv_map`: entries at or past nb are never used as indices
    rows = block_tables.long().gather(
        1, torch.minimum(w[None, :], nb[:, None] - 1))
    kf = _deq(k_pool[rows], k_scale).reshape(b, n_w * bs, kvh, d)
    vf = _deq(v_pool[rows], v_scale).reshape(b, n_w * bs, kvh, d)
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), kf) * sm_scale
    valid = (torch.arange(n_w * bs, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, vf) / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def fp8_paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, lengths, sm_scale=None):
    """Kernel 4 on the card -> (B, KVH, G, D) bf16."""
    b, kvh, g, d = q.shape
    _, bs, kvh2, d2 = k_pool.shape
    n_w = block_tables.shape[1]
    if (kvh2, d2) != (kvh, d) or v_pool.shape != k_pool.shape \
            or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("inconsistent paged-attention shapes")
    if g > MAX_G or d > MAX_D or n_w < 1:
        raise ValueError(f"G={g} > {MAX_G} or D={d} > {MAX_D} or W={n_w} < 1")
    if q.dtype != torch.bfloat16 or k_pool.dtype not in (E4M3, torch.bfloat16) \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError("q must be bf16 and the pools e4m3 or bf16")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
            or k_scale.numel() != 1 or v_scale.numel() != 1:
        raise ValueError("k/v scales must be f32 scalars")
    tensors = (q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths)
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("paged decode takes contiguous CUDA tensors")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    build.launch("paged_decode", "fp8rl_paged_decode", q.device,
                 q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 b, kvh, g, d, bs, n_w, DTYPE_CODE[k_pool.dtype],
                 float(sm_scale))
    return out
