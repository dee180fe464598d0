"""Blockwise-scaled FP8 GEMM: kernel 3 of the port.

Port of `repro.kernels.fp8_gemm.fp8_gemm` (repro/kernels/fp8_gemm.py:72,
the DeepGEMM analogue) and of its oracle `repro.kernels.ref.fp8_gemm_ref`:

    out (M, N) = sum_kb (A_kb @ W_kb) * (a_s[:, kb] * w_s[kb, n // 128])

with A (M, K) e4m3 in 1x128 tiles, W (K, N) e4m3 in 128x128 blocks
(stored K-major, as the weight sync writes it), each
128-wide K slab's partial product taken in f32 and accumulated in f32.
It runs in every W8A8 linear.  On the H100 it is bound by the weight
bytes at decode (M = 8) and by the tensor cores at prefill (M = 1024);
`csrc/fp8_gemm.cu` gives the design.  `fp8_gemm_ref` is the plain
version: the CPU path and the on-card comparisons use it, the card's main
path never does.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import E4M3
from repro_torch.kernels import build

BK = 128   # one K step per scale slab
# kernel 3 launches as a programmatic dependent (its weight stream starts
# before the kernel ahead of it ends) when the port's last launch was one
# of these: they never write W or w_s, which the GEMM reads before its
# grid-dependency wait.  Kernel 2, the sync, writes them: a GEMM right
# behind it waits for it whole.
PDL_AFTER = ("quant_act", "fp8_gemm")


def fp8_gemm_ref(a, w, a_scales, w_scales, out_dtype=torch.bfloat16):
    """Plain version of kernel 3 (same slab order as the kernel).

    a (M, K) fp8, w (K, N) fp8 in any layout, a_scales (M, K/128),
    w_scales (K/128, ceil(N/128)); K % 128 == 0.  Each slab is made
    row-major before its product, so the result does not depend on w's
    layout.
    """
    m, k = a.shape
    n = w.shape[1]
    ws_full = torch.repeat_interleave(w_scales.float(), 128, dim=1)[:, :n]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for kb in range(k // BK):
        sl = slice(kb * BK, (kb + 1) * BK)
        partial = a[:, sl].float() @ w[sl].float().contiguous()
        acc = acc + partial * (a_scales[:, kb, None].float() * ws_full[kb])
    return acc.to(out_dtype)


def fp8_gemm(a: torch.Tensor, w: torch.Tensor, a_scales: torch.Tensor,
             w_scales: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel 3 on the card -> (M, N) bf16.  w is K-major: a (K, N) view
    with strides (1, ldw), ldw >= K (the `ops.quantize_weight` storage; a
    row-major w raises).  K and N must be multiples of 128 (the
    `ops.fp8_matmul` wrapper hands over the padded storage); any M."""
    tensors = (a, w, a_scales, w_scales)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("fp8_gemm takes CUDA tensors")
    if out_dtype != torch.bfloat16:
        raise ValueError("the CUDA fp8 GEMM writes bf16")
    m, k = a.shape
    k2, n = w.shape
    if k != k2 or k % 128 or n % 128:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ {tuple(w.shape)}")
    if a.dtype != E4M3 or w.dtype != E4M3:
        raise ValueError("fp8_gemm takes e4m3 operands")
    if a_scales.shape != (m, k // 128) or w_scales.shape != (k // 128, n // 128):
        raise ValueError(f"bad scale shapes {tuple(a_scales.shape)}, "
                         f"{tuple(w_scales.shape)}")
    ldw = w.stride(1)
    if w.stride(0) != 1 or ldw < k or ldw % 16:
        raise ValueError(f"fp8_gemm takes a K-major weight, strides (1, ldw) with "
                         f"ldw >= K and ldw % 16 == 0; got strides {w.stride()}")
    if not all(t.is_contiguous() for t in (a, a_scales, w_scales)):
        raise ValueError("fp8_gemm takes contiguous activations and scales")
    if a_scales.dtype != torch.float32 or w_scales.dtype != torch.float32:
        raise ValueError("fp8_gemm takes f32 scales")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fp8_gemm operands must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    build.launch("fp8_gemm", "fp8rl_gemm", a.device, a.data_ptr(),
                 w.data_ptr(), a_scales.data_ptr(), w_scales.data_ptr(),
                 out.data_ptr(), m, n, k, ldw, int(build.LAST_LAUNCH in PDL_AFTER))
    return out
