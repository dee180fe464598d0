"""Model assembly: init / cache / prefill / decode for the dense decoder
(port of `repro.models.transformer`, rollout half).

`Transformer` holds the configuration and the device; the parameters are
a nested dict with the reference's key names and layer-stacked leaves
(`blocks/s0/attn/wq` is (R, K, N)), so `bridge.params_from_numpy` maps a
reference pytree onto it one to one and `core.fp8_params` selects the
same leaves to quantize.  The reference's `lax.scan` over the R repeats is
a Python loop over per-layer views here.  The cache is updated in place
and returned.  Its default layout is contiguous (one (B, S_max) region
per layer, decode through kernel 6); with `page_size` it is a paged pool
(kernel 4).  `prefill_chunk` and the `use_kernel` switch of
`decode_step` serve the continuous-batching engine (`repro_torch.
serving`).  On the "meta" device the model builds shapes only
(`launch.steps` specs).  `forward_train` / `token_logprobs` are the
trainer's differentiable teacher-forced pass (no cache, each layer
recomputed in the backward as the reference's `jax.checkpoint` does).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.fp8_linear import linear
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.common import dense_init, embed_init, pad_rows, rms_norm


def _layer(tree, r: int):
    """Layer `r` of a stacked param tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.layer(r)
    return tree[r]


class Transformer(nn.Module):
    """Dense decoder-only transformer on one device (CUDA by default)."""

    def __init__(self, cfg, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.pattern = blocks_mod.layer_pattern(cfg)
        for spec in self.pattern:
            blocks_mod.check_supported(spec)
        self.repeats = blocks_mod.n_repeats(cfg)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def init_params(self, seed: int = 0) -> dict:
        """Random weights drawn from a seeded `torch.Generator` on the
        model's device (normal x fan_in^-0.5; x 0.02 for the embedding;
        ones for norm scales).  They cannot equal the reference's
        `jax.random` draws: tests bridge the reference's params instead.
        A "meta" model returns the shapes and dtypes only."""
        cfg, r, dt, dev = self.cfg, self.repeats, self.dtype, self.device
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        gen.manual_seed(seed)
        d, h, kvh, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, cfg.d_ff)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def dense(shape, fan_in):
            return dense_init(gen, shape, fan_in, dt, dev)

        params = {"emb": embed_init(gen, (cfg.vocab_size, d), dt, dev)}
        blocks = {}
        for j, _ in enumerate(self.pattern):
            attn = {
                "wq": dense((r, d, h * dh), d),
                "wk": dense((r, d, kvh * dh), d),
                "wv": dense((r, d, kvh * dh), d),
                "wo": dense((r, h * dh, d), h * dh),
                "norm_scale": ones(r, d),
            }
            if cfg.qk_norm:
                attn["q_norm_scale"] = ones(r, dh)
                attn["k_norm_scale"] = ones(r, dh)
            mlp = {"wg": dense((r, d, f), d),
                   "wd": dense((r, f, d), f),
                   "norm_scale": ones(r, d)}
            if cfg.mlp_gated:
                mlp["wu"] = dense((r, d, f), d)
            blocks[f"s{j}"] = {"attn": attn, "mlp": mlp}
        params["blocks"] = blocks
        params["final_norm_scale"] = ones(d)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense((d, cfg.vocab_size), d)
        return params

    def init_cache(self, batch: int, max_len: int, precision: PrecisionConfig,
                   *, page_size: Optional[int] = None,
                   num_pages: Optional[int] = None) -> dict:
        """Rollout cache.  Default layout: one contiguous (B, max_len)
        region per sequence and layer (`attention.KVCache`), plus
        "max_length", the host's bound on the lengths (see `decode_step`).
        With `page_size`: per-layer pools of `num_pages` blocks of
        `page_size` tokens (+ the trash row) and a (B, W) block table,
        W = ceil(max_len / page_size); without `num_pages` each sequence
        owns a contiguous run of blocks (identity tables), with it the
        tables start unmapped (-1) for an external allocator."""
        cfg = self.cfg
        lengths = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        if page_size is None:
            slots = {f"s{j}": {"kv": attn_mod.init_kv_cache(
                batch, max_len, cfg.n_kv_heads, cfg.d_head, precision,
                repeats=self.repeats, device=self.device, dtype=self.dtype)}
                for j, _ in enumerate(self.pattern)}
            return {"slots": slots, "lengths": lengths, "max_length": 0}
        pages_per_seq = -(-max_len // page_size)
        self_owned = num_pages is None
        if self_owned:
            num_pages = batch * pages_per_seq
        slots = {f"s{j}": {"kv": attn_mod.init_paged_kv_cache(
            num_pages, page_size, cfg.n_kv_heads, cfg.d_head, precision,
            repeats=self.repeats, device=self.device, dtype=self.dtype)}
            for j, _ in enumerate(self.pattern)}
        if self_owned:
            tables = torch.arange(batch * pages_per_seq, dtype=torch.int32,
                                  device=self.device).reshape(batch, pages_per_seq)
        else:
            tables = torch.full((batch, pages_per_seq), -1, dtype=torch.int32,
                                device=self.device)
        return {"slots": slots, "lengths": lengths, "block_tables": tables}

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------

    def _unembed(self, params, x, precision):
        x = rms_norm(x, params["final_norm_scale"], self.cfg.norm_eps)
        head = params["emb"].T if self.cfg.tie_embeddings else params["lm_head"]
        # the lm_head is never quantized (paper §2.1.1); logits are rounded
        # to the activation dtype (bf16), then widened to f32.  Rows are
        # padded to ROW_FLOOR (models.common) for row-count-independent sums.
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        logits = linear(pad_rows(x2), head, precision=precision, quantized=False)
        return logits[: x2.shape[0]].reshape(lead + (-1,)).float()

    @staticmethod
    def _max_len(cache) -> int:
        """S_max of a contiguous cache."""
        return next(iter(cache["slots"].values()))["kv"].max_len

    def _layers(self, params, cache):
        for r in range(self.repeats):
            slot_params = _layer(params["blocks"], r)
            for j, spec in enumerate(self.pattern):
                name = f"s{j}"
                yield spec, slot_params[name], cache["slots"][name]["kv"].layer(r)

    # ------------------------------------------------------------------
    # prefill / decode
    # ------------------------------------------------------------------

    def prefill(self, params, inputs: dict, cache: dict,
                precision: PrecisionConfig):
        """Process right-padded prompts `inputs["tokens"]` (B, T) with
        lengths `inputs["lengths"]` (B,), fill the cache, return the logits
        at each last valid position (B, V) f32 and the cache.  A contiguous
        cache takes T <= S_max and records max(lengths) on the host (one
        device sync when the lengths are a CUDA tensor)."""
        tokens = inputs["tokens"].to(self.device)
        lengths = inputs["lengths"].to(self.device, torch.int32)
        b, t = tokens.shape
        contiguous = "block_tables" not in cache
        if contiguous:
            s_max = self._max_len(cache)
            if t > s_max:
                raise ValueError(f"prompts of {t} positions exceed the cache's {s_max}")
        x = params["emb"][tokens.long()]
        positions = torch.arange(t, device=self.device)[None, :]
        for spec, p, kv in self._layers(params, cache):
            x = blocks_mod.apply_slot_full(
                x, p, spec, self.cfg, precision, kv_cache=kv,
                positions=positions, lengths=lengths,
                block_tables=cache.get("block_tables"))
        cache["lengths"] = lengths
        if contiguous:
            cache["max_length"] = int(inputs["lengths"].max()) if b else 0
        idx = torch.clamp(lengths.long() - 1, 0, t - 1)
        x_last = x[torch.arange(b, device=self.device), idx]
        return self._unembed(params, x_last, precision), cache

    def prefill_chunk(self, params, tokens, start, chunk_lengths, cache: dict,
                      precision: PrecisionConfig, *, use_kernel: bool = False,
                      want_all_logits: bool = False):
        """One chunk of prompt tokens (B, C) of a *paged* cache: write the
        chunk's K/V at [start, start + chunk_lengths) and attend each
        position over everything reachable so far — through kernel 5 with
        `use_kernel`, else through the reference's table gather.  `start`
        and `chunk_lengths` (B,) are host ints (they size the gather with
        no device sync).  Returns the logits at each row's last valid
        position (B, V) f32 — or at every chunk position (B, C, V) with
        `want_all_logits` (the speculative verifier) — and the cache, whose
        "lengths" become start + chunk_lengths."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, c = tokens.shape
        start_h = np.asarray(start, np.int64).reshape(b)
        n_h = np.asarray(chunk_lengths, np.int64).reshape(b)
        new_h = start_h + n_h
        tables = cache["block_tables"]
        pools = next(iter(cache["slots"].values()))["kv"]
        live = attn_mod._live_blocks(np.minimum(start_h + c, new_h),
                                     tables.shape[1], pools.block_size)
        start_t = torch.as_tensor(start_h, dtype=torch.int32, device=self.device)
        lengths_t = torch.as_tensor(new_h, dtype=torch.int32, device=self.device)
        x = params["emb"][tokens.long()]
        for spec, p, kv in self._layers(params, cache):
            x = blocks_mod.apply_slot_full(
                x, p, spec, self.cfg, precision, kv_cache=kv,
                lengths=lengths_t, block_tables=tables, chunk_start=start_t,
                use_kernel=use_kernel, live_blocks=live)
        cache["lengths"] = lengths_t
        if want_all_logits:
            return self._unembed(params, x, precision), cache
        idx = np.clip(n_h - 1, 0, c - 1)
        x_last = x[torch.arange(b, device=self.device),
                   torch.as_tensor(idx, device=self.device)]
        return self._unembed(params, x_last, precision), cache

    def decode_step(self, params, tokens: torch.Tensor, cache: dict,
                    precision: PrecisionConfig, *,
                    use_kernel: Optional[bool] = None,
                    live_blocks: Optional[int] = None):
        """One autoregressive step on (B,) tokens -> (logits (B, V), cache).
        A contiguous cache attends through kernel 6, or with
        `use_kernel=False` through the reference's full-S_max path (the
        default None takes the kernel, except under `quantize_attention`:
        `kernels.config.KernelConfig.resolve`); it
        raises a `ValueError` before any write when the host's bound on
        the lengths ("max_length") has reached S_max — the reference's XLA
        scatter drops such a write, a CUDA index past the cache would kill
        the context.  A paged cache attends through kernel 4, or with
        `use_kernel=False` through the gather of the first `live_blocks`
        table entries (the caller's `attention._live_blocks` over
        lengths + 1; all entries when None)."""
        contiguous = "block_tables" not in cache
        if contiguous and cache["max_length"] >= self._max_len(cache):
            raise ValueError(
                f"decode step past the cache: a length reaches {cache['max_length']}"
                f" and the cache holds {self._max_len(cache)} positions")
        lengths = cache["lengths"]
        x = params["emb"][tokens.to(self.device).long()][:, None, :]
        for spec, p, kv in self._layers(params, cache):
            x = blocks_mod.apply_slot_decode(
                x, p, spec, self.cfg, precision, kv_cache=kv,
                lengths=lengths, block_tables=cache.get("block_tables"),
                use_kernel=use_kernel, live_blocks=live_blocks)
        cache["lengths"] = lengths + 1
        if contiguous:
            cache["max_length"] += 1
        return self._unembed(params, x[:, 0], precision), cache


# ---------------------------------------------------------------------------
# training / scoring forward
# ---------------------------------------------------------------------------

def _unbind_layers(tree, repeats: int) -> list:
    """The R per-layer trees of a stacked param tree.  A stacked leaf is
    unbound once, so the backward stacks the layers' gradients in one op
    (indexing it per layer would build a full-size zero gradient per
    layer and add them up)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_layers(v, repeats) for k, v in tree.items()}
        return [{k: v[r] for k, v in per_key.items()} for r in range(repeats)]
    if isinstance(tree, QuantizedTensor):
        return [tree.layer(r) for r in range(repeats)]
    return list(tree.unbind(0))


def _train_mask(t: int, lengths, device) -> torch.Tensor:
    """(1, T, T) causal, or (B, T, T) with keys past `lengths` masked."""
    mask = attn_mod.causal_mask(t, device)[None]
    if lengths is not None:
        valid = torch.arange(t, device=device)[None] < lengths.to(device)[:, None]
        mask = mask & valid[:, None, :]
    return mask


def forward_train(params: dict, inputs: dict, cfg,
                  precision: Optional[PrecisionConfig] = None):
    """Full teacher-forced forward over `inputs["tokens"]` (B, T), keys
    masked causally and past `inputs["lengths"]` when given.  Returns
    (logits (B, T, V) f32, aux); aux has the reference's keys ("moe" is
    empty: the port's models are dense).  Runs on the params' device.
    While autograd records, each layer runs under
    `torch.utils.checkpoint` and is recomputed in the backward (the
    reference's `jax.checkpoint`)."""
    model = Transformer(cfg, params["emb"].device)
    dev = model.device
    tokens = inputs["tokens"].to(dev).long()
    lengths = inputs.get("lengths")
    t = tokens.shape[1]
    mask = _train_mask(t, lengths, dev)
    positions = torch.arange(t, device=dev)[None, :]

    def body(h, slot_params):
        for j, spec in enumerate(model.pattern):
            h = blocks_mod.apply_slot_full(
                h, slot_params[f"s{j}"], spec, cfg, precision,
                positions=positions, mask=mask, lengths=lengths)
        return h

    x = params["emb"][tokens]
    remat = torch.is_grad_enabled()
    for slot_params in _unbind_layers(params["blocks"], model.repeats):
        x = checkpoint(body, x, slot_params, use_reentrant=False) if remat \
            else body(x, slot_params)
    return model._unembed(params, x, precision), {"moe": {}}


def token_logprobs(params: dict, inputs: dict, cfg,
                   precision: Optional[PrecisionConfig] = None):
    """log p(token_t | tokens_<t) for t >= 1, (B, T-1) f32 — the
    trainer-side scoring pass behind the TIS ratios and the mismatch KL
    (paper §2.1.3).  Returns (logprobs, aux)."""
    logits, aux = forward_train(params, inputs, cfg, precision)
    tokens = inputs["tokens"].to(logits.device).long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None])[..., 0], aux
