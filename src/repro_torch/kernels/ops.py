"""Public wrappers around the port's kernels (port of `repro.kernels.ops`).

Responsibilities, as in the reference:
  * dispatch — a CUDA tensor goes to the hand-written kernel (or the call
    raises: there is no fallback), a CPU tensor to the kernel's plain
    PyTorch version;
  * shape normalization — flatten leading dims, pad K (and N) to tile
    multiples, slice the result back;
  * plumbing between `QuantizedTensor` and the raw kernel signatures.

Launch counts are kept per kernel in `build.LAUNCHES`.
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
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if t.is_cuda:
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for device {t.device}")


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
    shape = x.shape
    k = shape[-1]
    block = (1,) * (len(shape) - 1) + (128,)
    fn = _route(x, _quant.quantize_activation_kernel, _quant.quantize_activation_ref)
    if k % 128 == 0 and x.is_contiguous() and x.data_ptr() % 16 == 0:
        q, s = fn(x.view(-1, k), fp8_dtype, scale_format)
        return QuantizedTensor(q.view(shape), s.view(shape[:-1] + (k // 128,)), block)
    x2 = _pad_to(x.reshape(-1, k), (1, 128)).contiguous()
    if x2.data_ptr() % 16:      # kernel 1 loads 16-byte vectors
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
    *lead, k, n = w.shape
    wp = _pad_to(w, (128, 128)).contiguous()
    fn = _route(w, _quant.quantize_weight_kernel, _quant.quantize_weight_ref)
    q, s = fn(wp, fp8_dtype, scale_format)
    if not q.is_cuda:   # the plain version is row-major: copy the raw bytes
        q = q.view(torch.uint8).transpose(-1, -2).contiguous().view(q.dtype)
        q = q.transpose(-1, -2)
    return QuantizedTensor(q[..., :k, :n], s, (1,) * len(lead) + (128, 128))


def _gemm_weight(w: torch.Tensor) -> torch.Tensor:
    """The (K_pad, N_pad) operand of kernel 3 for a (K, N) weight, without
    a copy where `w` is a view of `quantize_weight`'s padded K-major
    storage (every weight the sync makes); any other layout is padded,
    which copies it (the CUDA kernel then refuses a row-major result)."""
    k, n = w.shape
    kp, np_ = -(-k // 128) * 128, -(-n // 128) * 128
    if (w.stride() == (1, kp) and w.storage_offset() + np_ * kp
            <= w.untyped_storage().nbytes() // w.element_size()):
        return w.as_strided((kp, np_), (1, kp))
    return _pad_to(w, (128, 128))


def fp8_matmul(x_q: QuantizedTensor, w_q: QuantizedTensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = dequant(x_q) @ dequant(w_q) by the blockwise GEMM (kernel 3).

    x_q: activations in 1x128 tiles, any leading rank.  w_q: (K, N)
    weights in 128x128 blocks, K-major as `quantize_weight` stores them
    (the kernel reads that storage in place, padding included).  K is
    padded to a 128 multiple in the activations; M needs no padding (the
    kernel masks its edge rows).
    """
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


def fp8_paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, lengths):
    """Paged decode attention over an fp8 (or bf16) pool (kernel 4).

    `block_tables` must hold *physical* pool rows (the models layer maps
    unmapped -1 entries to the trash row first); entries at or past each
    slot's live block count are never read.
    """
    fn = _route(q, _attn.fp8_paged_decode_attention,
                _attn.fp8_paged_decode_attention_ref)
    return fn(q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths)


def fp8_paged_prefill_attention(q, k_pool, v_pool, k_scale, v_scale,
                                block_tables, start, lengths):
    """Chunked-prefill attention over an fp8 (or bf16) pool (kernel 5).

    q (B, C, KVH, G, D) at absolute positions [start, start + C);
    `block_tables` holds *physical* pool rows; `lengths` counts each
    slot's valid tokens after the chunk (rows at or past it are zeros).
    Entries at or past ceil(min(start + C, lengths) / BS) are never read.
    """
    fn = _route(q, _attn.fp8_paged_prefill_attention,
                _attn.fp8_paged_prefill_attention_ref)
    return fn(q, k_pool, v_pool, k_scale, v_scale, block_tables, start,
              lengths)


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
    fn = _route(q, _attn.fp8_decode_attention, _attn.fp8_decode_attention_ref)
    if q.is_cuda:
        return fn(q, k_cache, v_cache, k_scale, v_scale, lengths)
    bs = _decode_tile(k_cache.shape[1], bs)
    k_cache = _pad_to(k_cache, (1, bs, 1, 1))
    v_cache = _pad_to(v_cache, (1, bs, 1, 1))
    return fn(q, k_cache, v_cache, k_scale, v_scale, lengths, bs=bs)
