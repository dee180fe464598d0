"""Public wrappers around the port's kernels (port of `repro.kernels.ops`).

Responsibilities, as in the reference:
  * dispatch — a CUDA tensor goes to the hand-written kernel (or the call
    raises: there is no fallback), a CPU tensor to the kernel's plain
    PyTorch version;
  * shape normalization — flatten leading dims, pad K (and N) to tile
    multiples, slice the result back;
  * plumbing between `QuantizedTensor` and the raw kernel signatures.

Launch counts are kept per kernel in `build.LAUNCHES`.

A "meta" tensor (the dry run's, `launch.dryrun`) takes a meta route: each
wrapper returns empty outputs of its kernel's shapes and dtypes, and
neither the kernel nor its plain version runs.  Every wrapper reports its
kernel's work (FLOPs and bytes, from its shapes, by the formulas of the
phase-6 bounds in `chip_smoke.py`) to an active
`roofline.analysis.count_step` (`COST_COUNTERS`), which does not count
the aten ops the wrapper runs inside itself: the same work counts the
same whether the kernel, its plain version or the meta route computes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.precision import E4M3, ScaleFormat
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import fp8_gemm as _gemm
from repro_torch.kernels import fp8_kv_attention as _attn
from repro_torch.kernels import fp8_quant as _quant


def _route(t: torch.Tensor, kernel, plain):
    """The kernel for a CUDA tensor, the plain version for a CPU one, the
    kernel's empty outputs (`_META`) for a meta one."""
    if t.is_cuda:
        return kernel
    if t.device.type == "cpu":
        return plain
    if t.is_meta and kernel in _META:
        return _META[kernel]
    raise ValueError(f"no kernel for device {t.device}")


# counters of `roofline.analysis.count_step`, innermost last; each has
# `kernel(name, flops, nbytes)` and a `hidden` depth
COST_COUNTERS: list = []


def _counted(name: str, cost, fn, *args):
    """fn(*args); while a count is active, kernel `name`'s work (`cost()`
    -> (flops, bytes)) is reported to it and fn's own aten ops are hidden
    from it.  One list check otherwise (the wrappers' host path)."""
    if not COST_COUNTERS:
        return fn(*args)
    counter = COST_COUNTERS[-1]
    counter.hidden += 1
    try:
        counter.kernel(name, *cost())
        return fn(*args)
    finally:
        counter.hidden -= 1


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _meta_quant_act(x2, fp8_dtype=E4M3, scale_format=ScaleFormat.FP32):
    m, k = x2.shape
    return (torch.empty((m, k), dtype=fp8_dtype, device=x2.device),
            torch.empty((m, k // 128), dtype=torch.float32, device=x2.device))


def _meta_quant_weight(w, fp8_dtype=E4M3, scale_format=ScaleFormat.FP32):
    *lead, k, n = w.shape
    q = torch.empty((*lead, n, k), dtype=fp8_dtype, device=w.device)
    return q.transpose(-1, -2), torch.empty((*lead, k // 128, n // 128), dtype=torch.float32,
                                            device=w.device)


def _meta_gemm(a, w, a_s, w_s, out_dtype=torch.bfloat16):
    return torch.empty((*a.shape[:-1], w.shape[-1]), dtype=out_dtype, device=a.device)


def _meta_attention(q, *args, **kwargs):
    return torch.empty_like(q)


# each kernel's meta route
_META = {_quant.quantize_activation_kernel: _meta_quant_act,
         _quant.quantize_weight_kernel: _meta_quant_weight,
         _gemm.fp8_gemm: _meta_gemm, _gemm.fp8_gemm_batched: _meta_gemm,
         _attn.fp8_paged_decode_attention: _meta_attention,
         _attn.fp8_paged_prefill_attention: _meta_attention,
         _attn.fp8_decode_attention: _meta_attention}


def _pad_to(x: torch.Tensor, mults: tuple) -> torch.Tensor:
    pads = []
    for dim, m in zip(reversed(x.shape), reversed(mults)):
        pads.extend((0, (-dim) % m))
    if not any(pads):
        return x
    if x.element_size() == 1:   # fp8: pad the raw bytes (0x00 is +0.0)
        return F.pad(x.view(torch.uint8), pads).view(x.dtype)
    return F.pad(x, pads)


def quantize_activation(x: torch.Tensor, fp8_dtype=E4M3,
                        scale_format: ScaleFormat = ScaleFormat.FP32
                        ) -> QuantizedTensor:
    """Dynamic activation quantization in 1x128 tiles (kernel 1).

    Any rank; leading dims are flattened into rows.  K is padded to a 128
    multiple (zeros never win the amax).  A contiguous, 16-byte aligned x
    with K % 128 == 0 (every qwen3-8b linear input) goes to the kernel as
    a view, with no pad, copy or slice: this runs once per distinct linear
    input, on a host-bound step.
    """
    def cost():
        k = x.shape[-1]
        m, kp = x.numel() // max(k, 1), -(-k // 128) * 128
        return 6 * m * kp, m * kp * (x.element_size() + 1) + m * kp // 128 * 4
    return _counted("quant_act", cost, _quantize_activation, x, fp8_dtype, scale_format)


def _quantize_activation(x, fp8_dtype, scale_format):
    shape = x.shape
    k = shape[-1]
    block = (1,) * (len(shape) - 1) + (128,)
    fn = _route(x, _quant.quantize_activation_kernel, _quant.quantize_activation_ref)
    if k % 128 == 0 and x.is_contiguous() and (x.is_meta or x.data_ptr() % 16 == 0):
        q, s = fn(x.view(-1, k), fp8_dtype, scale_format)
        return QuantizedTensor(q.view(shape), s.view(shape[:-1] + (k // 128,)), block)
    x2 = _pad_to(x.reshape(-1, k), (1, 128)).contiguous()
    if not x2.is_meta and x2.data_ptr() % 16:      # kernel 1 loads 16-byte vectors
        x2 = x2.clone()
    q, s = fn(x2, fp8_dtype, scale_format)
    q = q[:, :k].reshape(shape)
    s = s.reshape(shape[:-1] + (-1,))
    return QuantizedTensor(q, s, block)


def quantize_weight(w: torch.Tensor, fp8_dtype=E4M3,
                    scale_format: ScaleFormat = ScaleFormat.FP32
                    ) -> QuantizedTensor:
    """Static weight quantization in 128x128 blocks over the last two dims
    (kernel 2); layer-stacked (L, K, N) weights take one launch.

    The payload is stored K-major, (..., N_pad, K_pad) contiguous with K
    and N padded to 128 multiples (zeros): the layout kernel 3 streams.
    `data` is its (..., K, N) transposed view; values and scales are the
    reference's."""
    def cost():
        *_, k, n = w.shape
        numel = -(-k // 128) * 128 * -(-n // 128) * 128 * (w.numel() // max(k * n, 1))
        return 6 * numel, numel * (w.element_size() + 1) + numel // 16384 * 4
    return _counted("quant_weight", cost, _quantize_weight, w, fp8_dtype, scale_format)


def _quantize_weight(w, fp8_dtype, scale_format):
    *lead, k, n = w.shape
    wp = _pad_to(w, (128, 128)).contiguous()
    fn = _route(w, _quant.quantize_weight_kernel, _quant.quantize_weight_ref)
    q, s = fn(wp, fp8_dtype, scale_format)
    if q.device.type == "cpu":   # the plain version is row-major: copy the raw bytes
        q = q.view(torch.uint8).transpose(-1, -2).contiguous().view(q.dtype)
        q = q.transpose(-1, -2)
    return QuantizedTensor(q[..., :k, :n], s, (1,) * len(lead) + (128, 128))


def _gemm_weight(w: torch.Tensor) -> torch.Tensor:
    """The (K_pad, N_pad) operand of kernel 3 for a (K, N) weight — or the
    (E, K_pad, N_pad) one for an MoE layer's stacked (E, K, N) experts —
    without a copy where `w` is a view of `quantize_weight`'s padded
    K-major storage (every weight the sync makes); any other layout is
    padded, which copies it (the CUDA kernel then refuses a row-major
    result)."""
    *lead, k, n = w.shape
    kp, np_ = -(-k // 128) * 128, -(-n // 128) * 128
    if w.is_meta:       # no storage to address: the operand's shape only
        return w.new_empty((*lead, np_, kp)).transpose(-1, -2)
    size = w.untyped_storage().nbytes() // w.element_size()
    if not lead:
        if w.stride() == (1, kp) and w.storage_offset() + np_ * kp <= size:
            return w.as_strided((kp, np_), (1, kp))
        return _pad_to(w, (128, 128))
    (e,) = lead
    se = w.stride(0)
    if (w.stride()[1:] == (1, kp) and (e == 1 or se >= np_ * kp)
            and w.storage_offset() + (e - 1) * se + np_ * kp <= size):
        return w.as_strided((e, kp, np_), (se, 1, kp))
    return _pad_to(w, (1, 128, 128))


def k_major(w: torch.Tensor) -> torch.Tensor:
    """A (..., K, N) fp8 weight in kernel 3's layout: the (..., K, N) view
    of zero-padded (..., N_pad, K_pad) storage, as `quantize_weight` makes
    it (a copy of the raw bytes; `w` itself on meta).  A sharded step's
    gathered weight shards are row-major and take this copy."""
    if w.is_meta:
        return w
    *lead, k, n = w.shape
    kp, np_ = -(-k // 128) * 128, -(-n // 128) * 128
    store = torch.zeros((*lead, np_, kp), dtype=torch.uint8, device=w.device)
    store[..., :n, :k] = w.view(torch.uint8).transpose(-1, -2)
    return store.view(w.dtype).transpose(-1, -2)[..., :k, :n]


def fp8_matmul(x_q: QuantizedTensor, w_q: QuantizedTensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = dequant(x_q) @ dequant(w_q) by the blockwise GEMM (kernel 3).

    x_q: activations in 1x128 tiles, any leading rank.  w_q: (K, N)
    weights in 128x128 blocks, K-major as `quantize_weight` stores them
    (the kernel reads that storage in place, padding included).  K is
    padded to a 128 multiple in the activations; M needs no padding (the
    kernel masks its edge rows).  A stacked (E, K, N) w_q (an MoE layer's
    experts) takes x_q (E, ..., K) and runs the expert-batched kernel 3,
    one launch for all E.
    """
    batched = w_q.data.dim() == 3

    def cost():
        *lead, k, n = w_q.data.shape
        e = lead[0] if lead else 1
        m, kp = x_q.data.numel() // max(k, 1) // e, -(-k // 128) * 128
        out_bytes = torch.empty((), dtype=out_dtype).element_size()
        return (2 * e * m * n * kp,
                e * (m * kp + kp * n + m * (kp // 128) * 4 + (kp // 128) * -(-n // 128) * 4
                     + m * n * out_bytes))
    return _counted("fp8_gemm_batched" if batched else "fp8_gemm", cost,
                    _fp8_matmul_batched if batched else _fp8_matmul, x_q, w_q, out_dtype)


def _fp8_matmul(x_q: QuantizedTensor, w_q: QuantizedTensor, out_dtype) -> torch.Tensor:
    xshape = x_q.data.shape
    k = xshape[-1]
    kw, n = w_q.data.shape
    assert k == kw, (xshape, w_q.data.shape)
    a = x_q.data.reshape(-1, k)
    if k % 128 or not a.is_contiguous():
        a = _pad_to(a, (1, 128)).contiguous()
    a_s = x_q.scales.reshape(a.shape[0], -1).contiguous()
    w = _gemm_weight(w_q.data)
    w_s = w_q.scales.contiguous()
    fn = _route(x_q.data, _gemm.fp8_gemm, _gemm.fp8_gemm_ref)
    y = fn(a, w, a_s, w_s, out_dtype)
    if n % 128:
        y = y[:, :n]
    return y.reshape(xshape[:-1] + (n,))


def _fp8_matmul_batched(x_q: QuantizedTensor, w_q: QuantizedTensor,
                        out_dtype) -> torch.Tensor:
    """`fp8_matmul` over E experts: x_q (E, ..., K) @ w_q (E, K, N) ->
    (E, ..., N), one launch (the weights a view of the sync's storage)."""
    e, kw, n = w_q.data.shape
    xshape = x_q.data.shape
    k = xshape[-1]
    assert k == kw and xshape[0] == e, (xshape, w_q.data.shape)
    a = x_q.data.reshape(e, -1, k)
    if k % 128 or not a.is_contiguous():
        a = _pad_to(a, (1, 1, 128)).contiguous()
    a_s = x_q.scales.reshape(e, a.shape[1], -1).contiguous()
    w = _gemm_weight(w_q.data)
    w_s = w_q.scales.contiguous()
    fn = _route(x_q.data, _gemm.fp8_gemm_batched, _gemm.fp8_gemm_batched_ref)
    y = fn(a, w, a_s, w_s, out_dtype)
    if n % 128:
        y = y[..., :n]
    return y.reshape(xshape[:-1] + (n,))


def fp8_paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, lengths):
    """Paged decode attention over an fp8 (or bf16) pool (kernel 4).

    `block_tables` must hold *physical* pool rows (the models layer maps
    unmapped -1 entries to the trash row first); entries at or past each
    slot's live block count are never read.
    """
    def cost():
        b, kvh, g, d = q.shape
        bs = k_pool.shape[-3]
        live = _attn.live_block_counts(lengths, bs, block_tables.shape[1]) * bs
        ctx = int(torch.minimum(lengths.long(), live).sum()) if not q.is_meta \
            else b * block_tables.shape[1] * bs
        return (4 * ctx * kvh * g * d,
                2 * ctx * kvh * d * k_pool.element_size() + 2 * _nbytes(q)
                + _nbytes(block_tables, lengths))
    fn = _route(q, _attn.fp8_paged_decode_attention, _attn.fp8_paged_decode_attention_ref)
    return _counted("paged_decode", cost, fn, q, k_pool, v_pool, k_scale, v_scale,
                    block_tables, lengths)


def fp8_paged_prefill_attention(q, k_pool, v_pool, k_scale, v_scale,
                                block_tables, start, lengths):
    """Chunked-prefill attention over an fp8 (or bf16) pool (kernel 5).

    q (B, C, KVH, G, D) at absolute positions [start, start + C);
    `block_tables` holds *physical* pool rows; `lengths` counts each
    slot's valid tokens after the chunk (rows at or past it are zeros).
    Entries at or past ceil(min(start + C, lengths) / BS) are never read.
    """
    def cost():
        b, c, kvh, g, d = q.shape
        bs = k_pool.shape[-3]
        if q.is_meta:   # no values: every table entry live, every key attended
            live = b * block_tables.shape[1] * bs
            keys = c * live
        else:   # causal keys of the valid rows; the live blocks each row reads
            st, ln = start.long().cpu(), lengths.long().cpu()
            end = torch.minimum(st + c, ln)
            keys = int(((end * (end + 1) - st * (st + 1)) // 2).clamp(min=0).sum())
            live = int((-(-end.clamp(min=1) // bs) * bs).sum())
        return (4 * keys * kvh * g * d,
                2 * live * kvh * d * k_pool.element_size() + 2 * _nbytes(q)
                + _nbytes(block_tables, start, lengths))
    fn = _route(q, _attn.fp8_paged_prefill_attention, _attn.fp8_paged_prefill_attention_ref)
    return _counted("paged_prefill", cost, fn, q, k_pool, v_pool, k_scale, v_scale,
                    block_tables, start, lengths)


DECODE_BS = 512     # the reference's `fp8_kv_attention.DEFAULT_BS`


def _decode_tile(s: int, bs: int) -> int:
    """The reference wrapper's S tile for a cache of `s` positions
    (repro/kernels/ops.py:134-148; its Pallas call clamps it to the padded
    S); S is then padded to a multiple of it."""
    bs = min(bs, max(128, 1 << (s - 1).bit_length()))
    while s % bs and bs > 128:
        bs //= 2
    if s % bs:
        bs = min(bs, 1 << (s - 1).bit_length())
    return min(bs, -(-s // bs) * bs)


def fp8_decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths,
                         bs: int = DECODE_BS):
    """Decode attention over one layer's contiguous fp8 (or bf16) cache
    (kernel 6); positions at or past `lengths` are masked.

    CPU tensors take the reference's tile choice and pad S to it, so the
    plain version sums in the reference's tile order.  CUDA tensors are
    never padded (at S 524289 a padded copy would be 1 GiB per layer per
    step): the kernel masks the ragged tail itself."""
    def cost():
        b, kvh, g, d = q.shape
        s_max = k_cache.shape[1]
        ctx = b * s_max if q.is_meta else int(lengths.long().clamp(max=s_max).sum())
        return (4 * ctx * kvh * g * d,
                2 * ctx * kvh * d * k_cache.element_size() + 2 * _nbytes(q) + 4 * b)
    return _counted("decode", cost, _decode_attention, q, k_cache, v_cache, k_scale,
                    v_scale, lengths, bs)


def _decode_attention(q, k_cache, v_cache, k_scale, v_scale, lengths, bs):
    fn = _route(q, _attn.fp8_decode_attention, _attn.fp8_decode_attention_ref)
    if q.device.type != "cpu":
        return fn(q, k_cache, v_cache, k_scale, v_scale, lengths)
    bs = _decode_tile(k_cache.shape[1], bs)
    k_cache = _pad_to(k_cache, (1, bs, 1, 1))
    v_cache = _pad_to(v_cache, (1, bs, 1, 1))
    return fn(q, k_cache, v_cache, k_scale, v_scale, lengths, bs=bs)
