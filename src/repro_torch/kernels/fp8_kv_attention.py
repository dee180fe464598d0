"""Attention over an FP8 KV cache: kernels 4, 5 and 6 of the port.

Kernel 4, paged decode: port of
`repro.kernels.fp8_kv_attention.fp8_paged_decode_attention`
(repro/kernels/fp8_kv_attention.py:285; body `_paged_decode_attn_kernel`
:236, `_live_block_counts` :228, `_clamped_kv_map` :81, `_flash_update`
:89, `_deq` :73) and of its oracle `ref.fp8_paged_decode_attention_ref`.
GQA decode: q (B, KVH, G, D) attends over pools (N+1, BS, KVH, D) through
per-slot tables (B, W) of *physical* rows, masked by `lengths`, with one
f32 scale per pool for K and one for V.  Table entries at or past
nb = clip(ceil(len / BS), 1, W) are never dereferenced, and an idle slot
(len 0) gives exact zeros.  It runs at every decode step in every layer.

Kernel 5, chunked prefill: port of `fp8_paged_prefill_attention`
(repro/kernels/fp8_kv_attention.py:402; body `_paged_prefill_attn_kernel`
:349) and of `ref.fp8_paged_prefill_attention_ref`.  q (B, C, KVH, G, D)
holds a chunk of C queries at absolute positions [start, start + C); row
(c, g) counts key k_pos when k_pos <= start + c < lengths, so rows at or
past `lengths` come out as exact zeros; only entries
w < clip(ceil(min(start + C, lengths) / BS), 1, W) are read.  It runs for
every chunked-prefill chunk and every speculative-verify chunk.

Kernel 6, contiguous decode: port of `fp8_decode_attention`
(repro/kernels/fp8_kv_attention.py:169; body `_decode_attn_kernel` :110).
q (B, KVH, G, D) attends over one layer's contiguous cache
(B, S, KVH, D), masked by `lengths`; it dequantizes in f32 with no bf16
rounding (unlike `_deq`), and a row of length 0 gives exact zeros.  It
runs at every `launch.steps` serve step in every layer.

On the H100 kernels 4 and 6 are bound by the bytes of the live K/V rows
and kernel 5 about equally by bytes and the bf16 tensor-core rate.
Kernels 4 and 5 share one block body, `csrc/fp8_paged_attn.cuh`: Q K^T
and P V on the tensor cores (`mma.sync` bf16; P as two bf16 terms), K/V
staged through a cp.async ring in key tiles of fixed logical positions.
Kernel 5 launches it over tiles of 64 chunk rows, kernel 4 over a slot's
G rows, so a chunk row equals a decode step bit for bit.  Kernel 6 splits
S over the SMs and runs its own tensor-core body (`csrc/fp8_decode.cu`):
raw K/V tiles through a deeper cp.async ring, the payload entering the
`mma.sync` exactly and the scales factored out of the products.  All
three CUDA wrappers take D % 16 == 0 only; the helpers the two bodies
share are in `csrc/fp8_mma.cuh`.  `csrc/fp8_paged_decode.cu`,
`csrc/fp8_paged_prefill.cu` and `csrc/fp8_decode.cu` give the designs.

The `_ref` functions are the plain versions: the paged ones dequantize
like `_deq` (f32 multiply, then a bf16 rounding) and read only the
clamped live entries; kernel 6's dequantizes in f32 and walks S in the
TPU kernel's tiles with its online softmax.  All take the softmax in the
kernels' masked form (-1e30 fill, zeroed probabilities, max(l, 1e-30)
denominator).  The CPU path and the on-card comparisons use them; the
card's main path never does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import E4M3
from repro_torch.kernels import build
from repro_torch.kernels.fp8_quant import DTYPE_CODE

_NEG_INF = -1e30
MAX_G, MAX_D = 16, 256
# the paged kernels' block geometry, for the logs: kernel 5's chunk rows
# per block (csrc/fp8_paged_prefill.cu kRows) and the key tile
# (csrc/fp8_paged_attn.cuh PagedAttnShape::kKeys)
PREFILL_ROWS_PER_BLOCK = 64


def paged_key_tile(d: int) -> int:
    """Keys per tile of kernels 4 and 5 at head width `d`."""
    return 64 if d <= 128 else 32


def live_block_counts(lengths: torch.Tensor, bs: int, n_w: int) -> torch.Tensor:
    """nb[i] = clip(ceil(lengths[i] / bs), 1, n_w)."""
    return torch.clamp((lengths.long() + bs - 1) // bs, 1, n_w)


def _deq(tile: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (tile.float() * scale.float()).to(torch.bfloat16).float()


def _live_kv(k_pool, v_pool, k_scale, v_scale, block_tables, context):
    """Dequantized K/V (B, W*BS, KVH, D) f32 in logical order, gathered
    through the *clamped* table: entries at or past each slot's live
    block count (from `context` tokens) are never used as indices."""
    b, n_w = block_tables.shape
    _, bs, kvh, d = k_pool.shape
    nb = live_block_counts(context, bs, n_w)
    w = torch.arange(n_w, device=block_tables.device)
    rows = block_tables.long().gather(
        1, torch.minimum(w[None, :], nb[:, None] - 1))
    kf = _deq(k_pool[rows], k_scale).reshape(b, n_w * bs, kvh, d)
    vf = _deq(v_pool[rows], v_scale).reshape(b, n_w * bs, kvh, d)
    return kf, vf


def _masked_softmax_pv(scores, valid, vf, spec):
    """The kernels' masked softmax over the last axis, then P @ V."""
    scores = torch.where(valid, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum(spec, p, vf) / torch.clamp_min(l, 1e-30)


def fp8_paged_decode_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   block_tables, lengths, sm_scale=None):
    """Plain version of kernel 4 (same arguments, same output)."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    kf, vf = _live_kv(k_pool, v_pool, k_scale, v_scale, block_tables, lengths)
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), kf) * sm_scale
    valid = (torch.arange(kf.shape[1], device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    return _masked_softmax_pv(scores, valid, vf, "bhgs,bshd->bhgd").to(q.dtype)


def fp8_paged_prefill_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                    block_tables, start, lengths,
                                    sm_scale=None):
    """Plain version of kernel 5 (same arguments, same output)."""
    c, d = q.shape[1], q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    start, lengths = start.long(), lengths.long()
    context = torch.minimum(start + c, lengths)
    kf, vf = _live_kv(k_pool, v_pool, k_scale, v_scale, block_tables, context)
    scores = torch.einsum("bckgd,bskd->bkgcs", q.float(), kf) * sm_scale
    q_pos = start[:, None] + torch.arange(c, device=q.device)[None, :]
    k_pos = torch.arange(kf.shape[1], device=q.device)
    valid = (k_pos[None, None, :] <= q_pos[:, :, None]) \
        & (q_pos < lengths[:, None])[:, :, None]            # (B, C, S)
    out = _masked_softmax_pv(scores, valid[:, None, None], vf,
                             "bkgcs,bskd->bkgcd")           # (B,KVH,G,C,D)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _check_paged(q, k_pool, v_pool, k_scale, v_scale, block_tables, ints):
    """The kernels' common argument checks (q's last three dims are
    (KVH, G, D)); `ints` are the per-slot int32 vectors."""
    b = q.shape[0]
    kvh, g, d = q.shape[-3:]
    _, bs, kvh2, d2 = k_pool.shape
    if (kvh2, d2) != (kvh, d) or v_pool.shape != k_pool.shape \
            or block_tables.dim() != 2 or block_tables.shape[0] != b \
            or any(t.shape != (b,) for t in ints):
        raise ValueError("inconsistent paged-attention shapes")
    n_w = block_tables.shape[1]
    if g > MAX_G or d > MAX_D or d % 16 or n_w < 1:
        raise ValueError(f"G={g}, D={d}, W={n_w}: the paged kernels take "
                         f"G <= {MAX_G}, D <= {MAX_D}, D % 16 == 0 and W >= 1")
    if q.dtype != torch.bfloat16 or k_pool.dtype not in (E4M3, torch.bfloat16) \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError("q must be bf16 and the pools e4m3 or bf16")
    if block_tables.dtype != torch.int32 \
            or any(t.dtype != torch.int32 for t in ints):
        raise ValueError("tables, start and lengths must be int32")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
            or k_scale.numel() != 1 or v_scale.numel() != 1:
        raise ValueError("k/v scales must be f32 scalars")
    tensors = (q, k_pool, v_pool, k_scale, v_scale, block_tables, *ints)
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("paged attention takes contiguous CUDA tensors")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged attention reads q and the pools in 16-byte "
                         "chunks: they must be 16-byte aligned")
    return b, kvh, g, d, bs, n_w


def fp8_paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, lengths, sm_scale=None):
    """Kernel 4 on the card -> (B, KVH, G, D) bf16."""
    b, kvh, g, d, bs, n_w = _check_paged(q, k_pool, v_pool, k_scale, v_scale,
                                         block_tables, (lengths,))
    if q.dim() != 4:
        raise ValueError("decode q must be (B, KVH, G, D)")
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


def fp8_paged_prefill_attention(q, k_pool, v_pool, k_scale, v_scale,
                                block_tables, start, lengths, sm_scale=None):
    """Kernel 5 on the card -> (B, C, KVH, G, D) bf16."""
    b, kvh, g, d, bs, n_w = _check_paged(q, k_pool, v_pool, k_scale, v_scale,
                                         block_tables, (start, lengths))
    if q.dim() != 5:
        raise ValueError("chunk q must be (B, C, KVH, G, D)")
    c = q.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    build.launch("paged_prefill", "fp8rl_paged_prefill", q.device,
                 q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(),
                 block_tables.data_ptr(), start.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), b, c, kvh, g, d, bs, n_w,
                 DTYPE_CODE[k_pool.dtype], float(sm_scale))
    return out


# ---------------------------------------------------------------------------
# kernel 6: decode over a contiguous cache
# ---------------------------------------------------------------------------

# a split walks at most SPLIT_KEYS keys, unless that takes more than one
# split per SM (then one split per SM).  On the H100 (PERF.md §6) 1024
# keys beat 512 at S 32768 and tie at S 524288.
SPLIT_KEYS = 1024


def decode_splits(s_max: int, sm_count: int) -> tuple:
    """(n_split, span) of kernel 6's grid for a cache of `s_max` positions
    on a card with `sm_count` SMs: from the shape alone, never from the
    lengths, so a row's sum order is fixed for a given cache shape."""
    n = max(1, min(sm_count, -(-s_max // SPLIT_KEYS)))
    span = -(-s_max // n)
    return -(-s_max // span), span


def decode_geometry(d: int, g: int, kv_dtype: torch.dtype) -> dict:
    """Kernel 6's block geometry at head width `d`, group size `g` and cache
    dtype `kv_dtype`, as the compiled library reports it (for the logs)."""
    out = (ctypes.c_int * 5)()
    err = build.library().fp8rl_decode_geometry(d, g, DTYPE_CODE[kv_dtype], out)
    if err != 0:
        raise ValueError(f"kernel 6 takes no D={d}, G={g}")
    return dict(stages=out[0], tile_keys=out[1], warps=out[2], smem_bytes=out[3],
                register_blocks=out[4])


def fp8_decode_attention_ref(q, k_cache, v_cache, k_scale, v_scale, lengths,
                             sm_scale=None, bs=None):
    """Plain version of kernel 6 (same arguments, same output).

    Walks S in tiles of `bs` (all of S when None; S % bs == 0) with the
    TPU kernel's online softmax, so with the reference's tile it sums in
    the reference's order.  K/V are dequantized in f32 with no bf16
    rounding; V past each row's length is zeroed before P @ V, so stale
    bytes there (NaN included) never reach the output."""
    b, kvh, g, d = q.shape
    s = k_cache.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    bs = s if bs is None else bs
    assert s % bs == 0, (s, bs)
    qf = q.float()
    lengths = lengths.long().to(q.device)
    m = torch.full((b, kvh, g, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, g, 1), device=q.device)
    acc = torch.zeros((b, kvh, g, d), device=q.device)
    for t0 in range(0, s, bs):
        pos = torch.arange(t0, t0 + bs, device=q.device)
        valid = pos[None, :] < lengths[:, None]                    # (B, bs)
        kf = k_cache[:, t0:t0 + bs].float() * k_scale.float()
        vf = v_cache[:, t0:t0 + bs].float() * v_scale.float()
        vf = torch.where(valid[:, :, None, None], vf, 0.0)
        scores = torch.einsum("bhgd,bshd->bhgs", qf, kf) * sm_scale
        v4 = valid[:, None, None, :]
        scores = torch.where(v4, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(v4, torch.exp(scores - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgs,bshd->bhgd", p, vf)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def fp8_decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                         sm_scale=None):
    """Kernel 6 on the card -> (B, KVH, G, D) bf16.

    `k_cache`/`v_cache` are one layer (B, S, KVH, D), possibly a view into
    the layer-stacked cache: only the KVH and D dims must be dense.  No
    padded copy is made; the kernel masks the ragged tail itself.  The
    split count comes from S and the card's SM count (`decode_splits`)."""
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("decode q must be (B, KVH, G, D) and the cache (B, S, KVH, D)")
    b, kvh, g, d = q.shape
    b2, s_max, kvh2, d2 = k_cache.shape
    if (b2, kvh2, d2) != (b, kvh, d) or v_cache.shape != k_cache.shape \
            or v_cache.stride() != k_cache.stride() or lengths.shape != (b,):
        raise ValueError("inconsistent decode-attention shapes or strides")
    if s_max < 1 or g > MAX_G or d > MAX_D or d % 16:
        raise ValueError(f"S={s_max}, G={g}, D={d}: kernel 6 takes S >= 1, "
                         f"G <= {MAX_G}, D <= {MAX_D} and D % 16 == 0")
    if q.dtype != torch.bfloat16 or k_cache.dtype not in (E4M3, torch.bfloat16) \
            or v_cache.dtype != k_cache.dtype or lengths.dtype != torch.int32:
        raise ValueError("q must be bf16, the cache e4m3 or bf16, lengths int32")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
            or k_scale.numel() != 1 or v_scale.numel() != 1:
        raise ValueError("k/v scales must be f32 scalars")
    if k_cache.stride(3) != 1 or k_cache.stride(2) != d:
        raise ValueError("the cache's KVH and D dims must be dense")
    tensors = (q, k_cache, v_cache, k_scale, v_scale, lengths)
    if not all(t.is_cuda for t in tensors) \
            or not all(t.is_contiguous() for t in (q, lengths)):
        raise ValueError("kernel 6 takes CUDA tensors (q and lengths contiguous)")
    esz = k_cache.element_size()
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)) \
            or (k_cache.stride(0) * esz) % 16 or (k_cache.stride(1) * esz) % 16:
        raise ValueError("kernel 6 reads q and the cache in 16-byte chunks: they "
                         "must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split, span = decode_splits(s_max, sms)
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    ws = torch.empty((b * kvh * n_split * g * (d + 2),), dtype=torch.float32,
                     device=q.device)
    build.launch("decode", "fp8rl_decode", q.device,
                 q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), b, s_max, kvh, g, d,
                 k_cache.stride(0), k_cache.stride(1), n_split, span,
                 DTYPE_CODE[k_cache.dtype], float(sm_scale))
    return out
