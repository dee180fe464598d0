"""Fused blockwise FP8 quantization: kernels 1 and 2 of the port.

Port of `repro.kernels.fp8_quant` (the TPU kernels) and of its oracles
`repro.kernels.ref.quantize_activation_ref` / `quantize_weight_ref`.

* `quantize_activation_kernel` replaces `quantize_activation_kernel`
  (repro/kernels/fp8_quant.py:55): 1x128 row tiles -> q (M, K) fp8 and
  scales (M, K/128).  It runs before every W8A8 linear, at prefill and at
  every decode step.
* `quantize_weight_kernel` replaces `quantize_weight_kernel`
  (repro/kernels/fp8_quant.py:90): 128x128 blocks -> q (K, N) fp8 and
  scales (K/128, N/128).  It runs over every linear weight at every weight
  sync; the CUDA kernel takes layer-stacked (L, K, N) weights in one launch
  and stores q K-major, (N, K): the layout kernel 3 reads.

Both are bound by bytes on the H100 (one read of the source, one write of
the payload); `csrc/fp8_quant.cu` says how the design follows from that.
The plain PyTorch versions (`*_ref`) compute the same function; the CPU
path and the on-card comparisons use them, the card's main path never
does.  Scales: max(amax, 1e-12) * f32(1/fp8_max) (the compiled reference
folds its division by the constant into that multiply), or UE8M0
exp(ln2 * ceil(log2 s)) (the reference's `exp2`); payload: clip(x / scale)
with an IEEE divide, then a round-to-nearest-even cast.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import E4M3, E5M2, FP8_MAX, ScaleFormat
from repro_torch.core.quant import RECIP_FP8_MAX, exp2_like_reference
from repro_torch.kernels import build

_EPS = 1e-12
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, E4M3: 2, E5M2: 3}


def _scale(amax: torch.Tensor, fp8_dtype, scale_format: ScaleFormat):
    scale = torch.clamp_min(amax, _EPS) * RECIP_FP8_MAX[fp8_dtype]
    if scale_format == ScaleFormat.UE8M0:
        scale = exp2_like_reference(torch.ceil(torch.log2(scale)))
    return scale


def quantize_activation_ref(x: torch.Tensor, fp8_dtype=E4M3,
                            scale_format: ScaleFormat = ScaleFormat.FP32):
    """Plain version of kernel 1: x (M, K), K % 128 == 0 -> (q, scales)."""
    m, k = x.shape
    xf = x.float().reshape(m, k // 128, 128)
    scale = _scale(xf.abs().amax(dim=2), fp8_dtype, scale_format)
    fmax = FP8_MAX[fp8_dtype]
    q = torch.clamp(xf / scale[:, :, None], -fmax, fmax)
    return q.to(fp8_dtype).reshape(m, k), scale


def quantize_weight_ref(w: torch.Tensor, fp8_dtype=E4M3,
                        scale_format: ScaleFormat = ScaleFormat.FP32):
    """Plain version of kernel 2: w (..., K, N), K and N % 128 == 0 ->
    (q (..., K, N) row-major, scales (..., K/128, N/128))."""
    *lead, k, n = w.shape
    kb, nb = k // 128, n // 128
    wf = w.float().reshape(-1, kb, 128, nb, 128)
    scale = _scale(wf.abs().amax(dim=(2, 4)), fp8_dtype, scale_format)
    fmax = FP8_MAX[fp8_dtype]
    q = torch.clamp(wf / scale[:, :, None, :, None], -fmax, fmax)
    return q.to(fp8_dtype).reshape(*lead, k, n), scale.reshape(*lead, kb, nb)


def _check(x: torch.Tensor, fp8_dtype) -> None:
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("the CUDA quantizer takes a contiguous CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported input dtype {x.dtype}")
    if fp8_dtype not in (E4M3, E5M2):
        raise ValueError(f"unsupported fp8 dtype {fp8_dtype}")


def quantize_activation_kernel(x: torch.Tensor, fp8_dtype=E4M3,
                               scale_format: ScaleFormat = ScaleFormat.FP32):
    """Kernel 1 on the card: x (M, K) bf16/f32 CUDA, K % 128 == 0, 16-byte
    aligned (the kernel loads 16-byte vectors)."""
    _check(x, fp8_dtype)
    m, k = x.shape
    if k % 128:
        raise ValueError(f"K={k} must be a multiple of 128 (pad first)")
    if x.data_ptr() % 16:
        raise ValueError("kernel 1 reads x in 16-byte vectors: x must be 16-byte aligned")
    q = torch.empty((m, k), dtype=fp8_dtype, device=x.device)
    s = torch.empty((m, k // 128), dtype=torch.float32, device=x.device)
    build.launch("quant_act", "fp8rl_quant_act", x.device,
                 x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
                 DTYPE_CODE[x.dtype], DTYPE_CODE[fp8_dtype],
                 int(scale_format == ScaleFormat.UE8M0))
    return q, s


def quantize_weight_kernel(w: torch.Tensor, fp8_dtype=E4M3,
                           scale_format: ScaleFormat = ScaleFormat.FP32):
    """Kernel 2 on the card: w (K, N) or stacked (L, K, N) bf16/f32 CUDA,
    K and N % 128 == 0; one launch for all L slices.  The payload is
    stored (..., N, K), kernel 3's layout; q is its (..., K, N) transposed
    view, so its values are the plain version's."""
    _check(w, fp8_dtype)
    *lead, k, n = w.shape
    if k % 128 or n % 128:
        raise ValueError(f"(K, N)=({k}, {n}) must be multiples of 128")
    layers = 1
    for d in lead:
        layers *= d
    q = torch.empty((*lead, n, k), dtype=fp8_dtype, device=w.device)
    s = torch.empty((*lead, k // 128, n // 128), dtype=torch.float32,
                    device=w.device)
    if layers:
        build.launch("quant_weight", "fp8rl_quant_weight", w.device,
                     w.data_ptr(), q.data_ptr(), s.data_ptr(), layers, k, n,
                     DTYPE_CODE[w.dtype], DTYPE_CODE[fp8_dtype],
                     int(scale_format == ScaleFormat.UE8M0))
    return q.transpose(-1, -2), s
