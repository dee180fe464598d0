"""GQA attention over a quantizable KV cache (port of
`repro.models.attention`, the rollout, serving and training paths).

Two cache layouts, as in the reference.  The default `KVCache` is one
contiguous (B, S_max, KVH, D) region per layer: prefill writes [0, S),
padding included, and each decode step writes at `lengths`.  The
`PagedKVCache` is a pool of fixed-size token blocks shared by all
sequences and addressed through per-sequence block tables (vLLM's
layout), with one extra *trash* row: writes for unmapped entries (-1) and
padded prompt positions go there, and reads of it are masked by
`lengths`.  Either way the KV payload is fp8 E4M3 (or bf16) with one f32
scale per layer for K and for V, recalibrated at prefill from the
prompt's amax x 1.05 when `precision.calculate_kv_scales` is set.

"Full FP8" (`precision.quantize_attention`, paper §2.3.2) also quantizes
the attention math: q, k, v and the softmax output P go through an E4M3
QDQ (`core.quant.qdq`) in the plain paths (`_sdpa`, `_sdpa_chunked`), as
in the reference's jnp branch; the kernels skip it, as the reference's
kernel branches do.  Which branch a default call takes is decided by
`kernels.config.KernelConfig.resolve` (the plain one under
`quantize_attention`, as the reference's defaults).

One-shot prefill attention is plain PyTorch (as the reference's is plain
jnp) over K/V dequantized the way `dequantize_per_tensor` does: the naive
`_sdpa`, or `_sdpa_chunked` (online softmax over KV chunks, so the scores
never exist at (S, S)) under `attention_impl("chunked")`.  Chunked
prefill (`attention_prefill_chunk`, paged only) and decode each have two
mechanisms, chosen by the caller: the kernels (kernel 5 `ops.
fp8_paged_prefill_attention`; at decode kernel 4 `ops.
fp8_paged_decode_attention` for a pool, kernel 6 `ops.
fp8_decode_attention` for a contiguous cache), or the reference's jnp
paths — for a pool a contiguous copy of the live leading blocks, for a
contiguous cache the full S_max region, dequantized by
`dequantize_per_tensor`, through `_sdpa`.  `attention_forward` is the
cache-free full-sequence attention of the trainer's scoring pass.  The
pool gather is sized by
`_live_blocks` from host-side lengths, so it needs no device sync.
Caches are updated in place (eager PyTorch needs no functional copy);
a decode write at or past S_max raises (`IndexError` here; the steps of
`Transformer.decode_step` raise a `ValueError` before it), where the
reference's XLA scatter drops it.

Cross attention (enc-dec decoders) is plain PyTorch, as the reference's
is jnp: in training `attention_forward` takes the encoder output as
`kv_src` (no RoPE, not causal, a source-length mask); for rollout and
serving `cross_attention_cache` projects and quantizes the cross K/V once
per request (per-tensor scales, recalibrated from their amax when
`calculate_kv_scales` is set, else the cache's seeded scales) and
`cross_attention_decode` attends over their dequantized copy under the
`src_lengths` mask (with the QDQ under `quantize_attention`).  The encoder
is `attention_forward` with `causal=False` under a bidirectional mask.
`attention_impl` selects the naive, chunked or `repeat` impl (the last,
K/V repeated to the flat heads, a tensor-parallel layout).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import is_dtensor
from repro_torch.core.fp8_linear import linear, linears
from repro_torch.core.precision import E4M3, PrecisionConfig
from repro_torch.core.quant import (
    calibrate_scale,
    dequantize_per_tensor,
    qdq,
    quantize_per_tensor,
)
from repro_torch.kernels import ops
from repro_torch.kernels.config import KernelConfig
from repro_torch.models.common import (
    apply_rope,
    constrain,
    redistribute,
    rms_norm,
    split_dim,
)

_NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """Contiguous KV cache of one layer (B, S_max, KVH, D), or of all R
    layers stacked (R, B, S_max, KVH, D)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor    # () per layer, (R,) stacked
    v_scale: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)

    @property
    def max_len(self) -> int:
        return self.k.shape[-3]

    def layer(self, r: int) -> "KVCache":
        """Layer `r` of a stacked cache; views, so writes land in the cache."""
        return KVCache(self.k[r], self.v[r], self.k_scale[r], self.v_scale[r])


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, d_head: int,
                  precision: PrecisionConfig, *, repeats: int, device,
                  dtype=torch.bfloat16) -> KVCache:
    kv_dtype = E4M3 if precision.kv_quantized else dtype
    shape = (repeats, batch, max_len, n_kv_heads, d_head)
    return KVCache(
        k=torch.zeros(shape, dtype=kv_dtype, device=device),
        v=torch.zeros(shape, dtype=kv_dtype, device=device),
        k_scale=torch.ones((repeats,), dtype=torch.float32, device=device),
        v_scale=torch.ones((repeats,), dtype=torch.float32, device=device),
    )


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV pool of one layer (N+1, BS, KVH, D), or of all R layers
    stacked (R, N+1, BS, KVH, D); row N is the trash block."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor    # () per layer, (R,) stacked
    v_scale: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)

    @property
    def block_size(self) -> int:
        return self.k.shape[-3]

    @property
    def num_blocks(self) -> int:
        """Usable blocks (the trash row excluded)."""
        return self.k.shape[-4] - 1

    def layer(self, r: int) -> "PagedKVCache":
        """Layer `r` of a stacked cache; views, so writes land in the pool."""
        return PagedKVCache(self.k[r], self.v[r], self.k_scale[r],
                            self.v_scale[r])


def init_paged_kv_cache(num_blocks: int, block_size: int, n_kv_heads: int,
                        d_head: int, precision: PrecisionConfig, *,
                        repeats: int, device, dtype=torch.bfloat16
                        ) -> PagedKVCache:
    kv_dtype = E4M3 if precision.kv_quantized else dtype
    shape = (repeats, num_blocks + 1, block_size, n_kv_heads, d_head)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=kv_dtype, device=device),
        v=torch.zeros(shape, dtype=kv_dtype, device=device),
        k_scale=torch.ones((repeats,), dtype=torch.float32, device=device),
        v_scale=torch.ones((repeats,), dtype=torch.float32, device=device),
    )


def _paged_physical(cache: PagedKVCache, block_tables: torch.Tensor) -> torch.Tensor:
    """Logical table entries -> physical pool rows (-1 -> trash)."""
    trash = cache.k.shape[-4] - 1
    return torch.where(block_tables < 0, trash, block_tables).to(torch.int32)


def _live_blocks(context_lengths, w: int, bs: int) -> int:
    """Leading table entries that can hold live context:
    ceil(max(context_lengths) / bs), clipped to [1, w].  Takes host-side
    lengths (ints, a list, a numpy array or a CPU tensor) from the caller,
    so sizing a gather never waits for the device."""
    lengths = np.asarray(context_lengths)
    m = int(lengths.max()) if lengths.size else 0
    return max(1, min(w, -(-m // bs)))


def paged_write(cache: PagedKVCache, block_tables: torch.Tensor,
                positions: torch.Tensor, valid: torch.Tensor,
                kq: torch.Tensor, vq: torch.Tensor) -> None:
    """Scatter K/V rows (B, S, KVH, D), already in the cache dtype, into a
    layer's pool through the block table; invalid rows go to the trash."""
    bs = cache.block_size
    w = block_tables.shape[1]
    blk = torch.clamp(positions // bs, 0, w - 1).long()
    off = (positions % bs).long()
    entry = torch.gather(block_tables.long(), 1, blk)              # (B, S)
    trash = cache.k.shape[-4] - 1
    phys = torch.where(valid & (entry >= 0), entry, trash)
    cache.k[phys, off] = kq
    cache.v[phys, off] = vq


def paged_copy_rows(cache: PagedKVCache, src, dst) -> None:
    """Copy pool rows `src` -> `dst` (the device half of copy-on-write);
    the pool-row axis is indexed from the right, so this works on one
    layer's pool and on the stacked (R, N+1, ...) form."""
    src = torch.as_tensor(src, dtype=torch.long, device=cache.k.device)
    dst = torch.as_tensor(dst, dtype=torch.long, device=cache.k.device)
    cache.k[..., dst, :, :, :] = cache.k[..., src, :, :, :]
    cache.v[..., dst, :, :, :] = cache.v[..., src, :, :, :]


def _project_qkv(x, params, cfg, precision, kv_src=None):
    """q (B,S,H,D) from x, k/v (B,S',KVH,D) from x or the cross-attention
    source `kv_src` (B,S',D), in x.dtype (pre-RoPE)."""
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if kv_src is None:
        # one quantization of x for the three projections
        q, k, v = linears(x, (params["wq"], params["wk"], params["wv"]), precision=precision)
    else:
        q = linear(x, params["wq"], precision=precision)
        k, v = linears(kv_src, (params["wk"], params["wv"]), precision=precision)
    q = split_dim(q, -1, (h, dh))
    k = split_dim(k, -1, (kvh, dh))
    v = split_dim(v, -1, (kvh, dh))
    if cfg.qk_norm and "q_norm_scale" in params:
        q = rms_norm(q, params["q_norm_scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm_scale"], cfg.norm_eps)
    # head-parallel (or seq-parallel fallback) so the O(S^2) score tensor
    # shards over the model axis; K/V stay compatible with q's layout
    q = constrain(q, "act_qkv")
    k = constrain(k, "act_kv", n_heads=cfg.n_heads)
    v = constrain(v, "act_kv", n_heads=cfg.n_heads)
    return q, k, v


def _qdq_probs(p: torch.Tensor) -> torch.Tensor:
    """"Full FP8" P: cast to bf16, QDQ in 1x128 tiles along the keys (from
    key 0; masked keys are exact zeros), back to f32."""
    return qdq(p.to(torch.bfloat16)).float()


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: a DTensor's
    local shard must be laid out as its (contiguous) metadata says, or
    the views after it fail."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _sdpa_sharded(q, k, v, mask, precision):
    """`_sdpa` of DTensors: each rank attends its own (batch, query, head)
    shard of q over every key, as GSPMD partitions the reference's
    attention.  q keeps its layout (the rules' "act_qkv": batch over the
    data axes, heads or the sequence over the model axis); K/V keep q's
    batch and head shards where their heads divide as q's do, and are
    gathered elsewhere, each local query head then taking its own KV head
    (gradients of gathered K/V are partial sums: `to_local`'s
    `grad_placements`).  Returns (B, S, H*D) laid out as q."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = q.device_mesh
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q_pl = [p if isinstance(p, Shard) and p.dim < 3 else Replicate() for p in q.placements]
    kv_pl, kv_grad, kv_split = [], [], 1
    for i, p in enumerate(q_pl):
        if p == Shard(0) or (p == Shard(2) and kvh % (kv_split * mesh.size(i)) == 0):
            kv_split *= mesh.size(i) if p == Shard(2) else 1
            kv_pl.append(p)
            kv_grad.append(p)
        else:
            kv_pl.append(Replicate())
            # a gathered K/V serves only this rank's queries or heads
            kv_grad.append(Replicate() if p == Replicate() else Partial())
    ql = _ContiguousGrad.apply(q.redistribute(mesh, q_pl).to_local())
    kl = _ContiguousGrad.apply(k.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad))
    vl = _ContiguousGrad.apply(v.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad))
    _, q_off = compute_local_shape_and_global_offset(q.shape, mesh, q_pl)
    _, kv_off = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)
    # host index arithmetic (no device sync; meta tensors hold no values)
    heads = (q_off[2] + torch.arange(ql.shape[2])) // g - kv_off[2]
    if kl.shape[2] * g != ql.shape[2] or not torch.equal(
            heads, torch.arange(kl.shape[2]).repeat_interleave(g)):
        idx = heads.to(kl.device)
        kl, vl = kl[:, :, idx], vl[:, :, idx]           # one KV head per query head
    if mask is not None:
        if is_dtensor(mask):
            mask = mask.full_tensor()
        if mask.shape[0] > 1:
            mask = mask[q_off[0]:q_off[0] + ql.shape[0]]
        mask = mask[:, q_off[1]:q_off[1] + ql.shape[1]]
    # contiguous: the DTensor's strides are a contiguous tensor's
    out = _sdpa(ql, kl, vl, mask, precision).contiguous()
    return DTensor.from_local(out, mesh, q_pl, run_check=False, shape=(b, s, h * dh),
                              stride=(s * h * dh, h * dh, 1))


def _sdpa(q, k, v, mask, precision: Optional[PrecisionConfig] = None):
    """Naive grouped attention. q (B,S,H,D), k/v (B,S',KVH,D) in bf16;
    mask broadcast (B,S,S') or None.  Under `precision.quantize_attention`
    q, k and v are QDQ'd in 1x128 tiles along D (one tile, zero-padded,
    at D 80) and so is the normalized P (`_qdq_probs`), as the reference's
    jnp branch does.  DTensors go through `_sdpa_sharded`."""
    if is_dtensor(q):
        return _sdpa_sharded(q, k, v, mask, precision)
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    fp8 = precision is not None and precision.quantize_attention
    if fp8:
        q, k, v = qdq(q), qdq(k), qdq(v)
    if _impl() == "repeat" and g > 1:
        # flat-head attention: K/V repeated across the group so the scores
        # keep one head axis that the model axis divides
        k = constrain(torch.repeat_interleave(k, g, dim=2), "act_qkv")
        v = constrain(torch.repeat_interleave(v, g, dim=2), "act_qkv")
        scores = torch.einsum("bshd,bthd->bhst", q, k).float() * (dh ** -0.5)
        if mask is not None:
            scores = torch.where(mask[:, None], scores, _NEG_INF)
        p = torch.softmax(scores, dim=-1)
        if fp8:
            p = _qdq_probs(p)
        out = torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)
        return out.reshape(b, s, h * dh)
    qg = q.reshape(b, s, kvh, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * (dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if fp8:
        p = _qdq_probs(p)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    return out.reshape(b, s, h * dh)


# ---------------------------------------------------------------------------
# attention implementation selector (the reference's `attention_impl`)
# ---------------------------------------------------------------------------

_IMPL_CTX = threading.local()


@contextlib.contextmanager
def attention_impl(name: str):
    """naive — the full (S, S') scores, (KVH, G)-grouped (the default);
    chunked — online softmax over KV chunks, for prompts whose naive
    scores would not fit (B 1, S 32768: 137 GB of f32 scores naive, 4.3 GB
    per chunk); repeat — K/V repeated to the H flat heads before the
    scores: the (KVH, G) reshape cannot be head-sharded when KVH < tp, a
    flat head axis can."""
    if name not in ("naive", "chunked", "repeat"):
        raise ValueError(f"attention impl {name!r}: the port has naive, chunked and repeat")
    prev = getattr(_IMPL_CTX, "impl", "naive")
    _IMPL_CTX.impl = name
    try:
        yield
    finally:
        _IMPL_CTX.impl = prev


def _impl() -> str:
    return getattr(_IMPL_CTX, "impl", "naive")


def _sdpa_chunked(q, k, v, *, lengths=None, kv_chunk: int = 1024,
                  precision: Optional[PrecisionConfig] = None, prefix_len: int = 0):
    """Online-softmax attention over KV chunks (causal [+ a fully visible
    prefix of `prefix_len` keys] [+ lengths]);
    q (B,S,H,D), k/v (B,S',KVH,D) bf16 -> (B,S,H*D).  Equal to
    the naive path up to f32 accumulation order; scores exist only at
    (..., S, C) per chunk.  The last chunk may be short (the reference
    pads it with masked zeros, which adds exact zeros).  Under
    `precision.quantize_attention` q, k and v are QDQ'd as in `_sdpa`, and
    each chunk's *unnormalized* P = exp(s - m) after the row sum (its
    tiles start at the chunk's first key)."""
    b, s, h, dh = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    fp8 = precision is not None and precision.quantize_attention
    if fp8:
        q, k, v = qdq(q), qdq(k), qdq(v)
    c = min(kv_chunk, s_kv)
    qg = q.reshape(b, s, kvh, g, dh)
    q_pos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, kvh, g, s, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, g, s, 1), device=q.device)
    acc = torch.zeros((b, kvh, g, s, dh), device=q.device)
    for t0 in range(0, s_kv, c):
        k_blk, v_blk = k[:, t0:t0 + c], v[:, t0:t0 + c]
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k_blk).float() * (dh ** -0.5)
        k_pos = t0 + torch.arange(k_blk.shape[1], device=q.device)[None, :]
        mask = k_pos <= q_pos                                      # (S, C)
        if prefix_len:
            mask = mask | (k_pos < prefix_len)
        mask = mask[None]                                          # (1, S, C)
        if lengths is not None:
            mask = mask & (k_pos[None] < lengths[:, None, None])   # (B, S, C)
        mask = mask[:, None, None]
        scores = torch.where(mask, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(scores - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if fp8:
            p = _qdq_probs(p)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v_blk.dtype), v_blk)
        acc = acc * alpha + pv.float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h * dh).to(q.dtype)


def causal_mask(s: int, device=None) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def attention_forward(x, params, cfg, precision: Optional[PrecisionConfig], *,
                      positions=None, mask=None, causal: bool = True, kv_src=None,
                      use_rope: bool = True, prefix_len: int = 0, lengths=None):
    """Full-sequence attention with no cache (training / scoring / the
    encoder): q from x, k and v from x or the cross-attention source
    `kv_src`, RoPE at `positions` (0..S-1 when None; never for a cross
    source), then the naive `_sdpa` under `mask` (B or 1, S, S'), causal
    when no mask is given and `causal` — or, for causal self-attention
    under `attention_impl("chunked")`, `_sdpa_chunked` masked causally,
    past `lengths` and with the first `prefix_len` keys visible to all.
    Differentiable: every op is autograd's."""
    s = x.shape[1]
    q, k, v = _project_qkv(x, params, cfg, precision, kv_src)
    if use_rope and kv_src is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if _impl() == "chunked" and causal and kv_src is None:
        out = _sdpa_chunked(q, k, v, lengths=lengths, precision=precision,
                            prefix_len=prefix_len)
    else:
        if mask is None and causal and kv_src is None:
            mask = causal_mask(s, x.device)[None]
        out = _sdpa(q, k, v, mask, precision)
    out = constrain(out, "act_btd")
    return linear(out, params["wo"], precision=precision)


def _quantize_kv(k, v, cache, precision: PrecisionConfig,
                 recalibrate: bool):
    """Fresh K/V in the cache dtype.  recalibrate=True (prefill) sets the
    layer's scales from this tensor's amax x 1.05 — over the whole padded
    (B, S) prompt, padding rows included, as the reference does."""
    if not cache.quantized:
        return k.to(cache.k.dtype), v.to(cache.v.dtype)
    if recalibrate and precision.calculate_kv_scales:
        cache.k_scale.copy_(calibrate_scale(k.float().abs().amax(), margin=1.05))
        cache.v_scale.copy_(calibrate_scale(v.float().abs().amax(), margin=1.05))
    kq = quantize_per_tensor(k, cache.k_scale, cache.k.dtype)
    vq = quantize_per_tensor(v, cache.v_scale, cache.v.dtype)
    return kq, vq


def attention_prefill(x, params, cfg, cache, precision: PrecisionConfig, *,
                      lengths, positions, block_tables=None):
    """Causal attention over the prompt; writes the layer's cache at
    positions [0, S): a contiguous `KVCache` takes all S rows, padding
    included, as the reference's `dynamic_update_slice` does; a pool takes
    them through `block_tables` (padding past `lengths` goes to the trash
    row).  Attention is the naive `_sdpa`, or `_sdpa_chunked` under
    `attention_impl("chunked")`."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, params, cfg, precision)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    kq, vq = _quantize_kv(k, v, cache, precision, recalibrate=True)
    if isinstance(cache, KVCache) and is_dtensor(cache.k):
        _write_sharded(cache, kq, vq, None)
    elif isinstance(cache, KVCache):
        cache.k[:, :s] = kq
        cache.v[:, :s] = vq
    else:
        pos = torch.broadcast_to(positions, (b, s))
        valid = pos < lengths[:, None]
        paged_write(cache, block_tables, pos, valid, kq, vq)

    # attend over what the cache holds, so prefill numerics match decode's
    if cache.quantized:
        k_use = dequantize_per_tensor(kq, cache.k_scale, x.dtype)
        v_use = dequantize_per_tensor(vq, cache.v_scale, x.dtype)
    else:
        k_use, v_use = k, v
    if _impl() == "chunked":
        out = _sdpa_chunked(q, k_use, v_use, lengths=lengths, precision=precision)
    else:
        ar = torch.arange(s, device=x.device)
        mask = (ar[None, :] <= ar[:, None])[None]                    # causal
        mask = mask & (ar[None, :] < lengths[:, None])[:, None, :]   # (B, S, S)
        out = _sdpa(q, k_use, v_use, mask, precision)
    return linear(out, params["wo"], precision=precision)


def attention_prefill_chunk(x, params, cfg, cache: PagedKVCache,
                            precision: PrecisionConfig, *, start, lengths,
                            block_tables, live_blocks: int,
                            use_kernel: bool = False):
    """Chunked-prefill attention: write C prompt tokens at positions
    [start, start + C) through the block table, then attend each over
    everything reachable so far.  `start` (B,) counts the tokens already
    in the cache, `lengths` (B,) the valid tokens after the chunk (device
    int tensors); positions at or past `lengths` scatter to the trash row
    and their outputs are never read.  `live_blocks` is
    `_live_blocks(min(start + C, lengths), W, BS)` from the caller's host
    ints.  With `use_kernel` the chunk attends through kernel 5, which
    reads the pool in place; otherwise through the reference's gather of
    the live leading blocks."""
    b, c, _ = x.shape
    q, k, v = _project_qkv(x, params, cfg, precision)
    positions = start[:, None] + torch.arange(c, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    kq, vq = _quantize_kv(k, v, cache, precision, recalibrate=True)
    valid = positions < lengths[:, None]
    paged_write(cache, block_tables, positions, valid, kq, vq)

    bs, kvh, dh = cache.block_size, cache.k.shape[-2], cfg.d_head
    phys = _paged_physical(cache, block_tables)
    if use_kernel:
        out = ops.fp8_paged_prefill_attention(
            q.reshape(b, c, kvh, cfg.n_heads // kvh, dh).to(torch.bfloat16)
            .contiguous(), cache.k, cache.v, cache.k_scale, cache.v_scale,
            phys, start.to(torch.int32), lengths.to(torch.int32),
        ).reshape(b, c, cfg.n_heads * dh).to(x.dtype)
    else:
        k_all, v_all = _gather_live(cache, phys[:, :live_blocks], x.dtype)
        k_pos = torch.arange(live_blocks * bs, device=x.device)[None, None, :]
        mask = (k_pos <= positions[:, :, None]) \
            & (k_pos < lengths[:, None, None])                 # (B, C, S')
        out = _sdpa(q, k_all, v_all, mask, precision)
    return linear(out, params["wo"], precision=precision)


def attention_decode(x, params, cfg, cache, lengths,
                     precision: PrecisionConfig, *, block_tables=None,
                     use_kernel: Optional[bool] = None,
                     live_blocks: Optional[int] = None):
    """One decode step: append K/V at `lengths` (device ints, each below
    S_max for a contiguous cache), attend over [0, lengths].  A contiguous
    `KVCache` attends through kernel 6, or (use_kernel=False) through the
    reference's dequantized full-S_max `_sdpa`; a pool through kernel 4,
    or through the gather of the first `live_blocks` table entries (all of
    them when None).  `use_kernel=None` is the port's default, resolved by
    `KernelConfig.resolve`: the kernel, or under `quantize_attention` the
    reference's default jnp branch with its QDQ."""
    if use_kernel is None:
        use_kernel = KernelConfig.resolve(None, precision).decode
    b = x.shape[0]
    q, k, v = _project_qkv(x, params, cfg, precision)
    pos = lengths[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    kq, vq = _quantize_kv(k, v, cache, precision, recalibrate=False)
    if isinstance(cache, KVCache) and is_dtensor(cache.k):
        _write_sharded(cache, kq, vq, lengths)
        return _contiguous_attention(x, q, cache, lengths + 1, params,
                                     precision, use_kernel=use_kernel)
    if isinstance(cache, KVCache):
        rows = torch.arange(b, device=x.device)
        cache.k[rows, lengths.long()] = kq[:, 0]
        cache.v[rows, lengths.long()] = vq[:, 0]
        return _contiguous_attention(x, q, cache, lengths + 1, params,
                                     precision, use_kernel=use_kernel)
    paged_write(cache, block_tables, pos,
                torch.ones((b, 1), dtype=torch.bool, device=x.device), kq, vq)
    return _paged_attention_over_table(x, q, cache, block_tables, lengths + 1,
                                       params, precision, use_kernel=use_kernel,
                                       live_blocks=live_blocks)


def _contiguous_attention(x, q, cache: KVCache, new_lengths, params, precision,
                          *, use_kernel: bool):
    """Attend one query token over a contiguous cache: kernel 6, or the
    reference's dequantized full-S_max copy through `_sdpa`."""
    b, _, h, dh = q.shape
    kvh = cache.k.shape[-2]
    if use_kernel and is_dtensor(q):
        out = _decode_kernel_sharded(q, cache, new_lengths).to(x.dtype)
    elif use_kernel:
        out = ops.fp8_decode_attention(
            q.reshape(b, kvh, h // kvh, dh).to(torch.bfloat16).contiguous(),
            cache.k, cache.v, cache.k_scale, cache.v_scale,
            new_lengths.to(torch.int32),
        ).reshape(b, 1, h * dh).to(x.dtype)
    else:
        # reshard the fp8 payload (not the dequantized copy) when the
        # attention math needs the cache replicated over tp
        k_raw = constrain(cache.k, "kv_gather")
        v_raw = constrain(cache.v, "kv_gather")
        if cache.quantized:
            k_all = dequantize_per_tensor(k_raw, cache.k_scale, x.dtype)
            v_all = dequantize_per_tensor(v_raw, cache.v_scale, x.dtype)
        else:
            k_all, v_all = k_raw, v_raw
        k_pos = torch.arange(cache.max_len, device=x.device)
        mask = (k_pos[None, :] < new_lengths[:, None])[:, None, :]
        out = _sdpa(q, k_all, v_all, mask, precision)
    return linear(out, params["wo"], precision=precision)


def _local(t):
    """A DTensor's local tensor (a replicated scale's is the scale)."""
    return t.to_local() if is_dtensor(t) else t


def _write_sharded(cache: KVCache, kq, vq, pos) -> None:
    """Write K/V into a sharded contiguous layer cache (DTensors laid out
    by `ShardingRules.cache_spec`), each rank into its own shard with no
    collective beyond laying kq/vq out as the cache is: rows [0, s) of the
    sequence (prefill, `pos` None) or one row per sequence at `pos` (B,)
    (decode; plain lengths, every rank's the same).  Where the cache
    shards the sequence (a B=1 cell), a rank writes only the positions it
    holds."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = cache.k.device_mesh
    dst_pl = list(cache.k.placements)
    src_pl = [Replicate() if p == Shard(1) else p for p in dst_pl]
    _, off = compute_local_shape_and_global_offset(cache.k.shape, mesh, dst_pl)
    for dst, src in ((cache.k, kq), (cache.v, vq)):
        dl = dst.to_local()
        sl = redistribute(src, src_pl).to_local()
        s_lo, s_len = off[1], dl.shape[1]
        if pos is None:
            a, e = max(s_lo, 0), min(sl.shape[1], s_lo + s_len)
            if e > a:
                dl[:, a - s_lo:e - s_lo] = sl[:, a:e]
            continue
        rows = torch.arange(dl.shape[0], device=dl.device)
        p = _local(pos)[off[0]:off[0] + dl.shape[0]].long() - s_lo
        if s_len == dst.shape[1]:
            dl[rows, p] = sl[:, 0]
            continue
        inside = ((p >= 0) & (p < s_len))[:, None, None]
        p = p.clamp(0, s_len - 1)
        raw = dl.view(torch.uint8)     # fp8 takes no where: select bytes
        raw[rows, p] = torch.where(inside, sl[:, 0].view(torch.uint8), raw[rows, p])


def _decode_kernel_sharded(q, cache: KVCache, new_lengths):
    """Kernel 6 over each rank's local KV heads: q (B, 1, H, D) keeps its
    batch and head shards; the cache keeps q's batch shards and its KV
    heads where they split as q's heads do, and is gathered over the mesh
    dims that shard it otherwise (the head dim, or the sequence of a B=1
    cell).  A local query head whose KV head is not laid out beside it
    (uneven groups) takes its own copy of that head's cache (G = 1).
    Returns (B, 1, H*D) laid out as q."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = q.device_mesh
    b, _, h, dh = q.shape
    kvh = cache.k.shape[-2]
    g = h // kvh
    q_pl = [p if p in (Shard(0), Shard(2)) else Replicate() for p in q.placements]
    kv_pl, kv_split = [], 1
    for i, p in enumerate(q_pl):
        if p == Shard(2) and kvh % (kv_split * mesh.size(i)) == 0:
            kv_split *= mesh.size(i)
            kv_pl.append(p)
        else:
            kv_pl.append(p if p == Shard(0) else Replicate())
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = redistribute(cache.k, kv_pl).to_local()
    vl = redistribute(cache.v, kv_pl).to_local()
    _, q_off = compute_local_shape_and_global_offset(q.shape, mesh, q_pl)
    _, kv_off = compute_local_shape_and_global_offset(cache.k.shape, mesh, kv_pl)
    bl, hl = ql.shape[0], ql.shape[2]
    heads = (q_off[2] + torch.arange(hl)) // g - kv_off[2]
    if kl.shape[2] * g == hl and torch.equal(
            heads, torch.arange(kl.shape[2]).repeat_interleave(g)):
        ql = ql.reshape(bl, kl.shape[2], g, dh)
    else:       # one KV head per query head
        idx = heads.to(kl.device)
        kl, vl = (t.view(torch.uint8)[:, :, idx].contiguous().view(t.dtype) for t in (kl, vl))
        ql = ql.reshape(bl, hl, 1, dh)
    lens = _local(new_lengths)[q_off[0]:q_off[0] + bl].to(torch.int32).contiguous()
    out = ops.fp8_decode_attention(ql.to(torch.bfloat16).contiguous(), kl, vl,
                                   _local(cache.k_scale), _local(cache.v_scale), lens)
    out = out.reshape(bl, 1, hl * dh).contiguous()
    return DTensor.from_local(out, mesh, q_pl, run_check=False, shape=(b, 1, h * dh),
                              stride=(h * dh, h * dh, 1))


def _gather_live(cache: PagedKVCache, phys, dtype):
    """The reference's gather: pool rows `phys` (B, W_live) as contiguous
    (B, W_live * BS, KVH, D) K/V in logical order, dequantized like
    `dequantize_per_tensor`."""
    b, w_live = phys.shape
    bs, kvh, dh = cache.k.shape[-3:]
    k_raw = cache.k[phys.long()].reshape(b, w_live * bs, kvh, dh)
    v_raw = cache.v[phys.long()].reshape(b, w_live * bs, kvh, dh)
    if not cache.quantized:
        return k_raw, v_raw
    return (dequantize_per_tensor(k_raw, cache.k_scale, dtype),
            dequantize_per_tensor(v_raw, cache.v_scale, dtype))


def _paged_attention_over_table(x, q, cache: PagedKVCache, block_tables,
                                new_lengths, params, precision, *,
                                use_kernel: bool, live_blocks: Optional[int]):
    """Attend one query token over the K/V reachable through the table.
    The kernel reads only each slot's live leading entries; unmapped
    entries are mapped to the trash row first."""
    b, _, h, dh = q.shape
    kvh = cache.k.shape[-2]
    phys = _paged_physical(cache, block_tables)
    if use_kernel:
        out = ops.fp8_paged_decode_attention(
            q.reshape(b, kvh, h // kvh, dh).to(torch.bfloat16).contiguous(),
            cache.k, cache.v, cache.k_scale, cache.v_scale, phys,
            new_lengths.to(torch.int32),
        ).reshape(b, 1, h * dh).to(x.dtype)
    else:
        w_live = phys.shape[1] if live_blocks is None else live_blocks
        k_all, v_all = _gather_live(cache, phys[:, :w_live], x.dtype)
        k_pos = torch.arange(w_live * cache.block_size, device=x.device)
        mask = (k_pos[None, :] < new_lengths[:, None])[:, None, :]
        out = _sdpa(q, k_all, v_all, mask, precision)
    return linear(out, params["wo"], precision=precision)


# ---------------------------------------------------------------------------
# cross-attention KV (enc-dec): static per request, quantized once at prefill
# ---------------------------------------------------------------------------

def cross_attention_cache(enc_out, params, cfg, precision: PrecisionConfig,
                          cache: KVCache) -> KVCache:
    """Project the encoder output (B, S_src, D) to cross K/V and quantize
    them once into `cache` (one layer's (B, S_src, KVH, D) `KVCache`, a
    view of the model cache's), in place.  The cache's scales seed the
    quantization: with
    `calculate_kv_scales` on they are recalibrated from these K/V's amax
    x 1.05, otherwise the seeded (pool-wide, calibrated) ones are kept —
    the reference's `cross_attention_cache(k_scale=, v_scale=)`.  Returns
    the cache."""
    b, s, _ = enc_out.shape
    kvh, dh = cfg.n_kv_heads, cfg.d_head
    k, v = linears(enc_out, (params["wk"], params["wv"]), precision=precision)
    k = k.reshape(b, s, kvh, dh)
    v = v.reshape(b, s, kvh, dh)
    if cache.max_len != s:
        raise ValueError(f"{s} source positions for a cross cache of {cache.max_len}")
    kq, vq = _quantize_kv(k, v, cache, precision, recalibrate=True)
    cache.k.copy_(kq)
    cache.v.copy_(vq)
    return cache


def cross_attention_decode(x, params, cfg, cross_cache: KVCache, src_lengths,
                           precision: PrecisionConfig):
    """Attend x (B, T, D) over a layer's cross K/V, dequantized as
    `dequantize_per_tensor` does, keys at or past `src_lengths` (B,)
    masked, through the naive `_sdpa` (QDQ'd under
    `quantize_attention`)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    q = linear(x, params["wq"], precision=precision).reshape(b, s, h, dh)
    if cross_cache.quantized:
        k = dequantize_per_tensor(cross_cache.k, cross_cache.k_scale, x.dtype)
        v = dequantize_per_tensor(cross_cache.v, cross_cache.v_scale, x.dtype)
    else:
        k, v = cross_cache.k, cross_cache.v
    k_pos = torch.arange(k.shape[1], device=x.device)
    mask = (k_pos[None, :] < src_lengths.to(x.device)[:, None])[:, None, :]
    out = _sdpa(q, k, v, mask, precision)
    return linear(out, params["wo"], precision=precision)
