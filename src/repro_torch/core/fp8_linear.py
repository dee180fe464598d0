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

Sharded W8A8 (a `QuantizedTensor` of DTensors, laid out by
`distributed.ShardingRules`, in a sharded prefill or serve step): kernels
1 and 3 run on each rank's local shards (`_sharded_linears`).  Per mesh
dim, a weight sharded where x is split by data (ZeRO) is gathered first;
then a column-parallel weight (N sharded) takes x replicated there and
gives y sharded on N, a row-parallel one (K sharded) takes x sharded on K
and its local products are summed over that mesh dim in f32 (within one
bf16 rounding of one process: each partial is rounded to bf16 first), an
expert-parallel one (E sharded) takes x sharded on E.  A shard of K or N
that is not a multiple of 128 would split a 128x128 scale block (and for
K a 1x128 activation tile): such a weight is gathered over those mesh
dims and the linear runs replicated there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import is_dtensor
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
        if _nested_rows(x):
            out = _MmF32.apply(_flatten_rows(x), w)
            return _unflatten_rows(out.to(x.dtype), x)
        out = _MmF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _nested_rows(x) -> bool:
    """A DTensor whose batch dim several mesh dims shard (("pod", "data")
    on the multi-pod mesh) and no other leading dim: DTensor cannot
    unflatten such rows again after a 2-D GEMM."""
    if not is_dtensor(x) or x.dim() <= 2:
        return False
    lead = [p.dim for p in x.placements if p.is_shard() and p.dim < x.dim() - 1]
    return len(lead) > 1 and set(lead) == {0}


def _flatten_rows(x):
    """x (*lead, K) -> (M, K), rank by rank (so that the gradient is
    unflattened rank by rank too)."""
    from torch.distributed.tensor import DTensor, Shard

    local = x.to_local()
    places = [Shard(1) if p.is_shard(x.dim() - 1) else p for p in x.placements]
    shape = (math.prod(x.shape[:-1]), x.shape[-1])
    return DTensor.from_local(local.reshape(-1, local.shape[-1]), x.device_mesh, places,
                              run_check=False, shape=shape, stride=(shape[1], 1))


def _unflatten_rows(out, x):
    """`out` (M, N), the GEMM of x's flattened rows, back to (*lead, N)
    rank by rank: laid out with x's batch shards (the GEMM's strategy may
    have split the rows otherwise), each rank's rows are then its own
    rows of x, in order."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    target = [Shard(0) if p.is_shard(0) else q if q.is_shard(1) or not q.is_shard()
              else Replicate() for p, q in zip(x.placements, out.placements)]
    out = out.redistribute(out.device_mesh, target)
    local = out.to_local()
    local = local.reshape(*x.to_local().shape[:-1], local.shape[-1])
    places = [Shard(x.dim() - 1) if q.is_shard(1) else q for q in target]
    shape = (*x.shape[:-1], out.shape[-1])
    return DTensor.from_local(local, x.device_mesh, places, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


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
        if is_dtensor(w.data):
            return _sharded_linears(x, [w], fmt)[0]
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
        if any(is_dtensor(w.data) for w in ws):
            return _sharded_linears(x, ws, fmt)
        x_q = ops.quantize_activation(x, scale_format=fmt)
        return [ops.fp8_matmul(x_q, w, out_dtype=x.dtype) for w in ws]
    return [linear(x, w, precision=precision) for w in ws]


def _sharded_plan(x, w):
    """(payload placements, x placements, y placements, mesh dims to sum
    over) of the sharded W8A8 linear x @ w (the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = w.data.device_mesh
    nd = w.data.dim()
    k_dim, n_dim = nd - 2, nd - 1
    xk = x.dim() - 1
    w_pl, x_pl, y_pl, reduce = list(w.data.placements), [], [], []
    for i, pw in enumerate(w_pl):
        px = x.placements[i]
        if not isinstance(pw, Shard) or not isinstance(px, Shard):
            continue
        if nd == 3 and pw.dim == 0:
            keep = px.dim == 0          # experts split as x's
        else:
            keep = px.dim == xk         # x split by data there: ZeRO
        if not keep:
            w_pl[i] = Replicate()
    for d in (k_dim, n_dim):            # a shard that splits a 128-block
        on = [i for i, p in enumerate(w_pl) if p == Shard(d)]
        local = w.data.shape[d] // math.prod(mesh.size(i) for i in on)
        if on and local % 128:
            for i in on:
                w_pl[i] = Replicate()
    for i, pw in enumerate(w_pl):
        px = x.placements[i]
        if isinstance(px, Partial) or px == Shard(xk):
            px = Replicate()
        if pw == Shard(k_dim):
            x_pl.append(Shard(xk))
            y_pl.append(Replicate())
            reduce.append(i)
        elif pw == Shard(n_dim):
            x_pl.append(Replicate())
            y_pl.append(Shard(xk))
        elif nd == 3 and pw == Shard(0):
            x_pl.append(Shard(0))
            y_pl.append(Shard(0))
        else:
            x_pl.append(px)
            y_pl.append(px)
    return w_pl, x_pl, y_pl, reduce


def _local_blocks(w, w_pl):
    """This rank's payload of `w` under placements `w_pl` and the scale
    blocks that cover it (each kept shard of K or N is whole 128-blocks)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.models.common import redistribute

    mesh = w.data.device_mesh
    data = redistribute(w.data, w_pl).to_local()
    s_pl = [p if p == q and isinstance(p, Shard) else Replicate()
            for p, q in zip(w_pl, w.scales.placements)]
    scales = w.scales.redistribute(mesh, s_pl).to_local()
    _, off = compute_local_shape_and_global_offset(w.data.shape, mesh, w_pl)
    _, s_off = compute_local_shape_and_global_offset(w.scales.shape, mesh, s_pl)
    for d, blk in enumerate(w.block):
        start = off[d] // blk - s_off[d]
        n = -(-data.shape[d] // blk)
        if (start, n) != (0, scales.shape[d]):
            scales = scales.narrow(d, start, n)
    return ops.k_major(data), scales.contiguous()


def _sharded_linears(x, ws, fmt) -> list:
    """W8A8 linears of x against `QuantizedTensor`s of DTensors on each
    rank's shards (the module docstring): one kernel-1 call per distinct
    local input, one kernel-3 call per weight; DTensors out."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.common import replicate_like

    mesh = ws[0].data.device_mesh
    if not is_dtensor(x):
        x = replicate_like(x, ws[0].data)
    quantized, outs = {}, []
    for w in ws:
        w_pl, x_pl, y_pl, reduce = _sharded_plan(x, w)
        key = tuple(x_pl)
        if key not in quantized:
            xl = x.redistribute(mesh, x_pl).to_local().contiguous()
            quantized[key] = ops.quantize_activation(xl, scale_format=fmt)
        data, scales = _local_blocks(w, w_pl)
        y = ops.fp8_matmul(quantized[key], QuantizedTensor(data, scales, w.block[-2:]
                                                           if data.dim() == 2 else w.block),
                           out_dtype=x.dtype)
        if reduce:      # row-parallel: the partial products summed in f32
            c10d = torch.ops._c10d_functional
            y = y.float()
            for i in reduce:
                y = c10d.wait_tensor(c10d.all_reduce(y, "sum", mesh.get_group(i).group_name))
            y = y.to(x.dtype)
        shape = (*x.shape[:-1], w.data.shape[-1])
        outs.append(DTensor.from_local(y.contiguous(), mesh, y_pl, run_check=False,
                                       shape=shape,
                                       stride=torch.empty(shape, device="meta").stride()))
    return outs


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
