"""FP8 linear layers, rollout path (port of `repro.core.fp8_linear`).

W8A8 rollout (paper §2.1): weights were quantized at weight-sync time
(128x128 E4M3 blocks); activations are quantized per call (1x128 E4M3
tiles) by kernel 1 and multiplied by kernel 3 (`kernels.ops`).  Unlike the
reference's CPU default (a QDQ matmul of dequantized bf16 operands), the
port never materialises dequantized operands: its GEMM takes the fp8
payloads and applies the block scales to each slab's f32 partial, which is
what the reference's TPU kernel computes.  The bf16 `_dot` is also the
trainer's linear and differentiates on the card.

End-to-end FP8 training (paper §2.4): `fp8_dot` is a dot with its own
backward (the reference's `custom_vjp`).  Its forward quantizes x to E4M3
in 1x128 tiles and w in 128x128 blocks and multiplies the dequantized
bf16 operands; its backward quantizes the incoming gradient to the
recipe's format (E5M2 hybrid, E4M3 for the pure-E4M3 ablation) in 1x128
tiles along each GEMM's contraction dim.  The quantizations go through
kernels 1 and 2 on the card (their plain versions on the CPU); the three
GEMMs are `_dot`s of the dequantized bf16 operands with f32 sums, as the
reference's run in XLA.
`linear` takes it for a bf16 weight under `precision.fp8_training`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import E4M3, E5M2, Fp8Recipe, PrecisionConfig, ScaleFormat
from repro_torch.core.quant import QuantizedTensor, dequantize
from repro_torch.kernels import ops


class _MmF32(torch.autograd.Function):
    """x2 (M, K) @ w (K, N) as one GEMM of the operands as they are, with
    f32 sums and an f32 result (`aten::mm.dtype`, CUDA and meta).  That op
    has no derivative of its own; the backward is the same GEMM twice,
    dx = g @ w^T and dw = x^T @ g, on operands in the forward's dtype, f32
    sums, each rounded once to its operand's dtype.  `g` arrives as f32
    widened from x.dtype (the gradient of `_dot`'s final cast), so casting
    it back is exact."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.t(), out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x2.t(), g, out_dtype=torch.float32).to(w.dtype)
        return dx, dw


class _BmmF32(torch.autograd.Function):
    """`_MmF32` over a batch of experts: x3 (E, M, K) @ w (E, K, N) as one
    batched GEMM with f32 sums and an f32 result (`aten::bmm.dtype`, CUDA
    and meta); the backward is the same batched GEMM twice."""

    @staticmethod
    def forward(ctx, x3, w):
        ctx.save_for_backward(x3, w)
        return torch.bmm(x3, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x3, w = ctx.saved_tensors
        g = g.to(x3.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(g, w.transpose(1, 2), out_dtype=torch.float32).to(x3.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(x3.transpose(1, 2), g, out_dtype=torch.float32).to(w.dtype)
        return dx, dw


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, output in x.dtype (the reference's
    `preferred_element_type=f32` dot).

    On the card (and on "meta", which stands in for it) the operands go
    into one GEMM as they are, which sums in f32 and writes f32
    (`_MmF32`), rounded to x.dtype once: no widened copy of w and no
    reduced-precision split-K sum; its backward is the same kind of GEMM.
    On the CPU the operands are widened to f32, as before.  A stacked
    (E, K, N) w (an MoE layer's experts, which the reference vmaps over)
    takes x (E, ..., K) and one batched GEMM (`_BmmF32`; `aten::bmm.dtype`
    has no CPU kernel, so the CPU widens as for one matrix)."""
    if w.dim() == 3:
        x3 = x.reshape(w.shape[0], -1, x.shape[-1])
        if x.is_cuda or x.is_meta:
            out = _BmmF32.apply(x3, w)
        else:
            out = torch.matmul(x3.float(), w.float())
        return out.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])
    if x.is_cuda or x.is_meta:
        out = _MmF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def fp8_linear_rollout(x: torch.Tensor, w_q: QuantizedTensor, *,
                       scale_format: ScaleFormat = ScaleFormat.FP32
                       ) -> torch.Tensor:
    """W8A8 blockwise FP8 linear, inference only (kernels 1 and 3)."""
    x_q = ops.quantize_activation(x, scale_format=scale_format)
    return ops.fp8_matmul(x_q, w_q, out_dtype=x.dtype)


def linear(x: torch.Tensor, w, *, precision: Optional[PrecisionConfig] = None,
           quantized: bool = True) -> torch.Tensor:
    """Precision-dispatching linear: `w` is a bf16 tensor (bf16 path or an
    excluded layer) or a `QuantizedTensor` (rollout path after sync).  A
    stacked (E, K, N) w (an MoE layer's experts) takes x (E, M, K) and
    gives (E, M, N) on every branch: kernel 1 once over all E·M rows then
    the expert-batched kernel 3; one batched bf16 GEMM; or `fp8_dot` per
    expert under `fp8_training`."""
    if isinstance(w, QuantizedTensor):
        if not quantized:  # excluded layer got a quantized weight: dequant
            return _dot(x, dequantize(w, x.dtype))
        fmt = precision.scale_format if precision else ScaleFormat.FP32
        return fp8_linear_rollout(x, w, scale_format=fmt)
    if precision is not None and precision.fp8_training and quantized:
        if w.dim() == 3:
            return torch.stack([fp8_dot(x[e], w[e], precision.recipe,
                                        precision.scale_format)
                                for e in range(w.shape[0])])
        return fp8_dot(x, w, precision.recipe, precision.scale_format)
    return _dot(x, w.to(x.dtype))


def linears(x: torch.Tensor, ws, *, precision: Optional[PrecisionConfig] = None
            ) -> list:
    """`linear(x, w)` for each of `ws`, with one activation quantization
    (kernel 1) for all of them when every weight is a `QuantizedTensor`
    (the rollout path after sync): the same function on the same tensor,
    so the outputs are bit-identical to separate calls.  Otherwise (bf16
    weights, `BF16_ROLLOUT`, excluded layers) each goes through `linear`."""
    if all(isinstance(w, QuantizedTensor) for w in ws):
        fmt = precision.scale_format if precision else ScaleFormat.FP32
        x_q = ops.quantize_activation(x, scale_format=fmt)
        return [ops.fp8_matmul(x_q, w, out_dtype=x.dtype) for w in ws]
    return [linear(x, w, precision=precision) for w in ws]


# ---------------------------------------------------------------------------
# End-to-end FP8 training path
# ---------------------------------------------------------------------------

def _qdq_tiles(x: torch.Tensor, fp8_dtype, scale_format) -> torch.Tensor:
    """QDQ of a 2-D x in 1x128 tiles along its last dim through kernel 1
    (its plain version on the CPU): the reference's `qdq`, dequantized in
    f32 and rounded once to x.dtype."""
    return dequantize(ops.quantize_activation(x, fp8_dtype, scale_format), x.dtype)


class _Fp8Dot(torch.autograd.Function):
    """The reference's `fp8_dot` custom_vjp on 2-D x (M, K), w (K, N)."""

    @staticmethod
    def forward(ctx, x2, w, recipe, scale_format):
        x_f = _qdq_tiles(x2, E4M3, scale_format)
        w_f = dequantize(ops.quantize_weight(w, E4M3, scale_format), x2.dtype)
        ctx.save_for_backward(x_f, w_f)
        ctx.grad_fmt = E5M2 if recipe == Fp8Recipe.HYBRID else E4M3
        ctx.scale_format = scale_format
        return _dot(x_f, w_f)

    @staticmethod
    def backward(ctx, g):
        x_f, w_f = ctx.saved_tensors
        g = g.to(x_f.dtype)
        # one quantization of g per contraction layout (DeepGEMM's dgrad /
        # wgrad pair): tiles over N for dx, over M for dw
        g_dx = _qdq_tiles(g, ctx.grad_fmt, ctx.scale_format)
        dx = _dot(g_dx, w_f.t())
        g_dw = _qdq_tiles(g.t().contiguous(), ctx.grad_fmt, ctx.scale_format).t()
        dw = _dot(x_f.t(), g_dw)
        return dx, dw, None, None


def fp8_dot(x: torch.Tensor, w: torch.Tensor,
            recipe: Fp8Recipe = Fp8Recipe.HYBRID,
            scale_format: ScaleFormat = ScaleFormat.FP32) -> torch.Tensor:
    """Quantized dot with a recipe-controlled backward (paper §2.4.3).

    forward : E4M3(x, 1x128) @ E4M3(w, 128x128), f32 sums, in x.dtype
    backward: the gradient QDQ'd to E5M2 (hybrid) or E4M3 (pure-E4M3
              ablation) before the dgrad (g @ w_f^T, tiles over N) and the
              wgrad (x_f^T @ g, tiles over the M rows), each in f32 and
              rounded to its operand's dtype.
    x: (..., K), any leading rank; w: (K, N) bf16."""
    y = _Fp8Dot.apply(x.reshape(-1, x.shape[-1]), w, recipe, scale_format)
    return y.reshape(*x.shape[:-1], w.shape[-1])
