"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block (port of
`repro.models.ssm`).

Chunked SSD for training and prefill (an intra-chunk quadratic term and
an inter-chunk state recurrence) and an O(1) recurrent decode step.
Heads share one B/C group (ngroups=1), with a scalar decay per head.

The in/out projections are W8A8 linears like any other (kernels 1 and 3
on the card); the recurrent state h (f32) and the conv tail (the model
dtype) are never quantized.  The SSD scan is plain PyTorch, as the
reference's is plain jnp (no Pallas kernel exists for it).  Its cast
points mirror the reference's: the intra-chunk (B, nc, H, Q, Q) tensors
and the chunk inputs are rounded to the model dtype before their
f32-summed product, everything else is f32.  The reference's 3- and
4-operand einsums are written as explicit products whose intermediates
are no larger than their operands (a left-to-right `torch.einsum` would
build (B, nc, Q, N, H) tensors).

State layout: `SSMState` holds one layer's h (B, H, P, N) and conv tail
(B, W-1, C), or all R layers' stacked on a leading axis; the model writes
each layer's new state into the cache in place.

Sharded (x a DTensor, in a `distributed.ShardingRules` step) each rank
runs the plain mixer on its own rows of the batch: sequences are
independent, so only the params (and the rank's rows of the state) are
gathered; the output and the new state come back split by batch, and
`SSMState.copy_` lays the new state out as the cache holds it (the
rules keep it replicated, as the reference's spec does: a gather).
DTensor has no strategies for the scan's splits, gathers and per-chunk
loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import is_dtensor
from repro_torch.core.fp8_linear import _BmmF32, linear
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.common import redistribute, rms_norm

CHUNK = 64


@dataclasses.dataclass
class SSMState:
    """Recurrent state of one SSM layer, or of R layers stacked."""

    h: torch.Tensor       # (B, H, P, N) f32, (R, B, H, P, N) stacked
    conv: torch.Tensor    # (B, W-1, C) model dtype, (R, B, W-1, C) stacked

    def layer(self, r: int) -> "SSMState":
        """Layer `r` of a stacked state; views, so writes land in it."""
        return SSMState(self.h[r], self.conv[r])

    def rows(self, start: int, stop: int) -> "SSMState":
        """Batch rows [start, stop) of a stacked state (views)."""
        return SSMState(self.h[:, start:stop], self.conv[:, start:stop])

    def copy_(self, other: "SSMState") -> None:
        """Write `other` into this state; into a sharded (DTensor) state
        each rank writes its shard of `other` laid out as this state is."""
        for dst, src in ((self.h, other.h), (self.conv, other.conv)):
            if is_dtensor(dst):
                dst.to_local().copy_(redistribute(src, dst.placements).to_local())
            else:
                dst.copy_(src)


def _gathered(t):
    """A DTensor (or a `QuantizedTensor` of DTensors, its payload in kernel
    3's layout) whole on every rank, as a plain tensor; `t` otherwise."""
    from torch.distributed.tensor import Replicate

    from repro_torch.kernels import ops

    if isinstance(t, QuantizedTensor):
        if not is_dtensor(t.data):
            return t
        return QuantizedTensor(ops.k_major(_gathered(t.data)), _gathered(t.scales), t.block)
    if not is_dtensor(t):
        return t
    return redistribute(t, [Replicate()] * t.device_mesh.ndim).to_local()


def _batch_local(fn, x, params, state, lengths=None):
    """`fn(x, params, state, lengths)`, the plain mixer, of a DTensor x on
    this rank's rows of the batch (split as x's is, over the mesh dims
    that split it evenly), with the params and the state's rows gathered.
    Returns the output and the new state (None without one) as DTensors
    split by batch the same way."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    if x.shape[0] % math.prod(mesh.size(i) for i in on):
        on = []
    pl = [Shard(0) if i in on else Replicate() for i in range(mesh.ndim)]
    (b, *_), (start, *_) = compute_local_shape_and_global_offset(x.shape, mesh, pl)

    def rows(t):
        return None if t is None else _gathered(t)[start:start + b]

    def spread(t):
        shape = (x.shape[0], *t.shape[1:])
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    params = {k: _gathered(v) for k, v in params.items()}
    if state is not None:
        state = SSMState(rows(state.h), rows(state.conv))
    out, new = fn(redistribute(x, pl).to_local(), params, state, rows(lengths))
    return spread(out), None if new is None else SSMState(spread(new.h), spread(new.conv))


def conv_channels(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_ssm_params(dense, ones, cfg, repeats: int, device):
    """The reference's `init_ssm_params` stacked over `repeats` layers:
    yields (name, leaf) in its order.  `dense(shape, fan_in, dtype=None)`
    draws normal x fan_in^-0.5 in the model dtype, `ones(*shape)` a scale
    of ones; conv_b is zeros in the model dtype, dt_bias zeros, a_log
    log(linspace(1, 16, H)) and D ones, the last three f32."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w, cc = cfg.ssm_conv, conv_channels(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    yield "w_in", dense((repeats, d, 2 * di + 2 * n + h), d)
    yield "conv_w", dense((repeats, w, cc), w)
    yield "conv_b", ones(repeats, cc).zero_()
    yield "dt_bias", torch.zeros((repeats, h), **f32)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32))
    yield "a_log", a_log.to(device).expand(repeats, h).clone()
    yield "D", torch.ones((repeats, h), **f32)
    yield "gate_norm_scale", ones(repeats, di)
    yield "w_out", dense((repeats, di, d), di)
    yield "norm_scale", ones(repeats, d)


def init_ssm_state(batch: int, cfg, *, repeats: int, device,
                   dtype=torch.bfloat16) -> SSMState:
    """Zero state of R stacked layers: h f32, conv tail in `dtype`."""
    return SSMState(
        h=torch.zeros((repeats, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((repeats, batch, cfg.ssm_conv - 1, conv_channels(cfg)),
                         dtype=dtype, device=device),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, logaddexp(x, 0) for every x (torch's softplus
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_in_proj(proj: torch.Tensor, cfg):
    """Gate z (.., di), conv input (.., di + 2n), dt (.., h): views of
    `proj`, which may itself be a strided view (kernel 3's padded N)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [di, di + 2 * n, h], dim=-1)


def _causal_conv(xbc: torch.Tensor, conv_w, conv_b, tail: Optional[torch.Tensor],
                 lengths: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time: xbc (B, T, C), tail (B, W-1, C) or
    None (zeros).  Returns (silu(conv) (B, T, C) in xbc's dtype, new tail
    (B, W-1, C)).  With `lengths` (valid tokens per right-padded row) the
    tail ends at each row's last valid token, so a later chunk or decode
    step continues from real history, not from PAD embeddings."""
    w = conv_w.shape[0]
    b, t, c = xbc.shape
    if tail is None:
        tail = torch.zeros((b, w - 1, c), dtype=xbc.dtype, device=xbc.device)
    full = torch.cat([tail.to(xbc.dtype), xbc], dim=1)          # (B, T+W-1, C)
    out = torch.zeros((b, t, c), dtype=torch.float32, device=xbc.device)
    for i in range(w):
        out = out + full[:, i:i + t].float() * conv_w[i].float()
    out = out + conv_b.float()
    if lengths is None:
        new_tail = full[:, t:]
    else:
        # token j sits at index W-1+j of `full`: the W-1 entries ending at
        # the last valid token span [n, n+W-1)
        n = torch.clamp(lengths.to(xbc.device).long(), 0, t)
        idx = n[:, None] + torch.arange(w - 1, device=xbc.device)[None, :]
        new_tail = torch.gather(full, 1, idx[:, :, None].expand(b, w - 1, c))
    return F.silu(out).to(xbc.dtype), new_tail


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q): sum_{r=s+1..t} a_r on the lower
    triangle, -inf above it."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]                 # t, s
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` and widened back to f32: a product of such
    operands summed in f32 is the reference's `preferred_element_type=f32`
    product of model-dtype operands."""
    return x.to(dtype).float()


def _chunk_product(m: torch.Tensor, x_t: torch.Tensor, dtype) -> torch.Tensor:
    """m (..., Q, Q) @ x_t (..., Q, P), both rounded to `dtype`, with f32
    sums and an f32 result.  On the card (and "meta") the rounded operands
    go into one batched GEMM as they are (`_BmmF32`), with no f32 copy of
    the (B, nc, H, Q, Q) operand; on the CPU they are widened to f32."""
    if dtype == torch.float32 or not (m.is_cuda or m.is_meta):
        return torch.matmul(_rounded(m, dtype), _rounded(x_t, dtype))
    lead = m.shape[:-2]
    out = _BmmF32.apply(m.to(dtype).reshape(-1, *m.shape[-2:]),
                        x_t.to(dtype).reshape(-1, *x_t.shape[-2:]))
    return out.reshape(*lead, *out.shape[-2:])


def ssd_scan(xh, dt, a_head, bmat, cmat, chunk: int = CHUNK,
             h0: Optional[torch.Tensor] = None):
    """Chunked SSD.  xh (B, T, H, P); dt (B, T, H) f32 (post-softplus);
    a_head (H,) f32 (negative); bmat, cmat (B, T, N).  T must be a multiple
    of the chunk.  Returns y (B, T, H, P) f32 and the final state (B, H, P,
    N) f32."""
    b, t, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, t)
    assert t % q == 0, (t, q)
    nc = t // q
    cd = xh.dtype
    xc = xh.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()
    a_t = (dtc * a_head).permute(0, 1, 3, 2)                     # (B, nc, H, Q)
    dt_t = dtc.permute(0, 1, 3, 2)                               # (B, nc, H, Q)
    x_t = xc.permute(0, 1, 3, 2, 4)                              # (B, nc, H, Q, P)

    # intra-chunk (quadratic within a chunk)
    scores = torch.matmul(cc, bc.transpose(-1, -2))              # (B, nc, Q, Q)
    m = scores[:, :, None] * torch.exp(_segsum(a_t))             # (B, nc, H, Q, Q)
    m = m * dt_t[:, :, :, None, :]
    y_intra = _chunk_product(m, x_t, cd)                         # (B, nc, H, Q, P)
    del m

    # chunk summaries: s_c = sum_k decay_to_end_k dt_k x_k (x) B_k
    cum = torch.cumsum(a_t, dim=-1)
    a_sum = a_t.sum(dim=-1)                                      # (B, nc, H)
    wk = torch.exp(a_sum[..., None] - cum) * dt_t                # (B, nc, H, Q)
    s_chunk = torch.matmul((x_t * wk[..., None]).transpose(-1, -2),
                           bc[:, :, None])                       # (B, nc, H, P, N)

    # inter-chunk recurrence: the state entering each chunk
    hprev = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.float()
    decay = torch.exp(a_sum)                                     # (B, nc, H)
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * decay[:, c, :, None, None] + s_chunk[:, c]
    h_in = torch.stack(h_in, dim=1)                              # (B, nc, H, P, N)

    y_inter = torch.matmul(cc[:, :, None], h_in.transpose(-1, -2)) \
        * torch.exp(cum)[..., None]                              # (B, nc, H, Q, P)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, t, h, p)
    return y, hprev


def _gated_out(y, z, x_dtype, params, cfg, precision):
    """rms_norm(y * silu(z)) through w_out, y (B, T, di) f32."""
    y = y.to(x_dtype)
    y = rms_norm(y * F.silu(z.float()).to(x_dtype), params["gate_norm_scale"], cfg.norm_eps)
    return linear(y, params["w_out"], precision=precision)


def ssm_forward(x: torch.Tensor, params: dict, cfg,
                precision: Optional[PrecisionConfig] = None,
                state: Optional[SSMState] = None, return_state: bool = False,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full-sequence SSD pass over x (B, T, D), from `state` (zeros when
    None).  With `lengths` (B,), positions at or past each row's length
    get dt = 0, which makes them exact state no-ops, and the conv tail
    ends at the last valid token: the returned state is a function of the
    valid tokens only (chunked and padded prefills hand decode the state a
    one-shot unpadded pass would).  Outputs at invalid positions are
    garbage the caller masks.  Returns (out (B, T, D), new state or None).
    A DTensor x runs on each rank's rows (the module docstring)."""
    if is_dtensor(x):
        return _batch_local(
            lambda x, p, s, n: ssm_forward(x, p, cfg, precision, state=s,
                                           return_state=return_state, lengths=n),
            x, params, state, lengths)
    b, t, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = linear(x, params["w_in"], precision=precision)
    z, xbc, dt_raw = _split_in_proj(proj, cfg)
    tail = state.conv if state is not None else None
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"], tail,
                                 lengths=lengths)
    xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    xh = xs.reshape(b, t, h, p)
    dt = softplus(dt_raw.float() + params["dt_bias"])
    if lengths is not None:
        valid = torch.arange(t, device=x.device)[None, :] < lengths.to(x.device)[:, None]
        dt = torch.where(valid[:, :, None], dt, 0.0)
    a_head = -torch.exp(params["a_log"])

    # pad T to a chunk multiple (prefill lengths are arbitrary)
    q = min(CHUNK, max(t, 1))
    pad = (-t) % q
    xp, bp, cp = xh, bmat, cmat
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bp = F.pad(bmat, (0, 0, 0, pad))
        cp = F.pad(cmat, (0, 0, 0, pad))
    h0 = state.h if state is not None else None
    y, h_last = ssd_scan(xp, dt, a_head, bp, cp, chunk=q, h0=h0)
    y = y[:, :t] + xh * params["D"][None, None, :, None]
    out = _gated_out(y.reshape(b, t, di), z, x.dtype, params, cfg, precision)
    if return_state:
        return out, SSMState(h=h_last, conv=new_tail)
    return out, None


def ssm_decode(x: torch.Tensor, params: dict, cfg, state: SSMState,
               precision: Optional[PrecisionConfig] = None
               ) -> Tuple[torch.Tensor, SSMState]:
    """O(1) recurrent step on x (B, 1, D): h <- h exp(a dt) + dt x (x) B,
    y = C.h + D x.  Returns (out (B, 1, D), new state).  A DTensor x runs on
    each rank's rows (the module docstring)."""
    if is_dtensor(x):
        return _batch_local(lambda x, p, s, n: ssm_decode(x, p, cfg, s, precision),
                            x, params, state)
    b = x.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = linear(x, params["w_in"], precision=precision)
    z, xbc, dt_raw = _split_in_proj(proj, cfg)
    full = torch.cat([state.conv.to(xbc.dtype), xbc], dim=1)    # (B, W, C)
    conv = (full.float() * params["conv_w"].float()).sum(dim=1)
    conv = F.silu(conv + params["conv_b"].float())
    xs, bvec, cvec = torch.split(conv, [di, n, n], dim=-1)
    xh = xs.reshape(b, h, p)
    dt = softplus(dt_raw[:, 0].float() + params["dt_bias"])
    decay = torch.exp(-torch.exp(params["a_log"]) * dt)           # (B, H)
    hnew = state.h * decay[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * bvec[:, None, None, :]
    y = torch.matmul(hnew, cvec[:, None, :, None])[..., 0]       # (B, H, P)
    y = y + xh * params["D"][None, :, None]
    out = _gated_out(y.reshape(b, 1, di), z, x.dtype, params, cfg, precision)
    return out, SSMState(h=hnew, conv=full[:, 1:].to(state.conv.dtype))
