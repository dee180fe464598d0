"""Model assembly: init / cache / prefill / decode for the dense, MoE, SSM
and hybrid decoders (port of `repro.models.transformer`).

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
With MoE layers, `prefill`, `prefill_chunk`, `decode_step` and
`forward_train` return the routing on request (`want_routing`: each MoE
slot's top-k expert indices stacked over the R repeats, as the
reference's scan stacks them) and `forward_train` takes a routing to
replay (`forced_routing`).  SSM layers (mamba2, jamba's hybrid pattern)
keep their recurrent state slot-indexed in the cache ("ssm", an
`ssm.SSMState` stacked over the R repeats) in either layout; a paged cache
of an attention-free model has no pool and no block tables.  An enc-dec
model (seamless) runs a bidirectional encoder over projected frames
(`_encode`); its decoder slots attend over it, in training directly and
in rollout through per-layer cross caches ("cross", a contiguous
`attention.KVCache` over the source, slot-indexed in either layout, and
the cache's "src_lengths"), which `prefill` fills once per request.  A
VLM (pixtral) projects its patches with `frontend/w_patch` into a prefix
ahead of the text (`_decoder_inputs`): fully visible in `forward_train`
(the prefix-LM mask), causal in `prefill`, as in the reference.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import is_dtensor, resolve_device
from repro_torch.core.fp8_linear import linear
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blocks_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    activation_sharding,
    active_rules,
    constrain,
    dense_init,
    embed_init,
    pad_rows,
    replicate_like,
    rms_norm,
    zero_gather,
)


def _layer(tree, r: int):
    """Layer `r` of a stacked param tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.layer(r)
    return tree[r]


def _set(tree: dict, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _first_kv(cache):
    """The first attention slot's KV cache (all share the geometry), or
    None for an attention-free model."""
    return next((sd["kv"] for sd in cache["slots"].values() if "kv" in sd), None)


def _stack_routing(per_layer: dict) -> dict:
    """{slot: [R x (B, T, K)]} -> {slot: (R, B, T, K)}."""
    return {name: torch.stack(idx) for name, idx in per_layer.items()}


def _enc_pattern(cfg):
    """The encoder's slots: the decoder's pattern over `n_enc_layers`,
    without cross attention."""
    return tuple(blocks_mod.SlotSpec(mixer=s.mixer, ffn=s.ffn, cross=False)
                 for s in blocks_mod.layer_pattern(cfg, decoder=False))


class Transformer(nn.Module):
    """Dense, MoE, SSM, hybrid, enc-dec or VLM decoder on one device
    (CUDA by default)."""

    def __init__(self, cfg, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.pattern = blocks_mod.layer_pattern(cfg)
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
        params = {}
        for path, leaf in self.iter_params(seed):
            _set(params, path, leaf)
        return params

    def iter_params(self, seed: int = 0):
        """`init_params(seed)`'s leaves as (key path, leaf), drawn one at a
        time in the same order: a caller can quantize and drop each bf16
        leaf before the next exists (a full-width MoE model's bf16 tree
        and its rollout copy do not fit one card together)."""
        cfg, r, dt, dev = self.cfg, self.repeats, self.dtype, self.device
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        gen.manual_seed(seed)
        d, h, kvh, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, cfg.d_ff)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def dense(shape, fan_in, dtype=None):
            return dense_init(gen, shape, fan_in, dtype or dt, dev)

        def attn_leaves(prefix, r, cross=False):
            yield prefix + ("wq",), dense((r, d, h * dh), d)
            yield prefix + ("wk",), dense((r, d, kvh * dh), d)
            yield prefix + ("wv",), dense((r, d, kvh * dh), d)
            yield prefix + ("wo",), dense((r, h * dh, d), h * dh)
            yield prefix + ("norm_scale",), ones(r, d)
            if cfg.qk_norm and not cross:
                yield prefix + ("q_norm_scale",), ones(r, dh)
                yield prefix + ("k_norm_scale",), ones(r, dh)

        def stack_leaves(prefix, pattern, r):
            for j, spec in enumerate(pattern):
                slot = prefix + (f"s{j}",)
                if spec.mixer == "ssm":
                    for name, leaf in ssm_mod.init_ssm_params(dense, ones, cfg, r, dev):
                        yield slot + ("ssm", name), leaf
                        del leaf
                else:
                    yield from attn_leaves(slot + ("attn",), r)
                if spec.cross:
                    yield from attn_leaves(slot + ("cross",), r, cross=True)
                if spec.ffn is None:
                    continue
                if spec.ffn == "moe":
                    for name, leaf in moe_mod.init_moe_params(dense, ones, cfg, r):
                        yield slot + ("moe", name), leaf
                        del leaf    # held here, it would outlive the caller's copy
                    continue
                mlp = slot + ("mlp",)
                yield mlp + ("wg",), dense((r, d, f), d)
                yield mlp + ("wd",), dense((r, f, d), f)
                yield mlp + ("norm_scale",), ones(r, d)
                if cfg.mlp_gated:
                    yield mlp + ("wu",), dense((r, d, f), d)

        yield ("emb",), embed_init(gen, (cfg.vocab_size, d), dt, dev)
        yield from stack_leaves(("blocks",), self.pattern, r)
        yield ("final_norm_scale",), ones(d)
        if not cfg.tie_embeddings:
            yield ("lm_head",), dense((d, cfg.vocab_size), d)
        if cfg.is_encdec:
            yield from stack_leaves(("enc", "blocks"), _enc_pattern(cfg),
                                    blocks_mod.n_repeats(cfg, decoder=False))
            yield ("enc", "final_norm_scale"), ones(d)
        if cfg.frontend is not None:
            yield ("frontend", "w_patch"), dense((d, d), d)

    def init_cache(self, batch: int, max_len: int, precision: PrecisionConfig,
                   *, page_size: Optional[int] = None,
                   num_pages: Optional[int] = None, src_len: int = 0) -> dict:
        """Rollout cache.  Default layout: one contiguous (B, max_len)
        region per sequence and layer (`attention.KVCache`), plus
        "max_length", the host's bound on the lengths (see `decode_step`).
        With `page_size`: per-layer pools of `num_pages` blocks of
        `page_size` tokens (+ the trash row) and a (B, W) block table,
        W = ceil(max_len / page_size); without `num_pages` each sequence
        owns a contiguous run of blocks (identity tables), with it the
        tables start unmapped (-1) for an external allocator.  SSM slots
        hold zero (R, B, ...) recurrent state ("ssm") in either layout; an
        attention-free paged cache has no block tables.  An enc-dec
        decoder's slots hold cross caches ("cross", contiguous (R, B,
        max(src_len, 1), KVH, D) in either layout) and the cache
        "src_lengths" (B,), all max(src_len, 1) until a prefill sets
        them."""
        cfg = self.cfg
        lengths = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        paged = page_size is not None
        if paged:
            pages_per_seq = -(-max_len // page_size)
            self_owned = num_pages is None
            if self_owned:
                num_pages = batch * pages_per_seq
        kv_geo = dict(repeats=self.repeats, device=self.device, dtype=self.dtype)
        slots = {}
        for j, spec in enumerate(self.pattern):
            if spec.mixer == "ssm":
                slot = {"ssm": ssm_mod.init_ssm_state(batch, cfg, **kv_geo)}
            elif paged:
                slot = {"kv": attn_mod.init_paged_kv_cache(
                    num_pages, page_size, cfg.n_kv_heads, cfg.d_head, precision, **kv_geo)}
            else:
                slot = {"kv": attn_mod.init_kv_cache(
                    batch, max_len, cfg.n_kv_heads, cfg.d_head, precision, **kv_geo)}
            if spec.cross:
                slot["cross"] = attn_mod.init_kv_cache(
                    batch, max(src_len, 1), cfg.n_kv_heads, cfg.d_head, precision, **kv_geo)
            slots[f"s{j}"] = slot
        cache = {"slots": slots, "lengths": lengths}
        if cfg.is_encdec:
            cache["src_lengths"] = torch.full((batch,), max(src_len, 1), dtype=torch.int32,
                                              device=self.device)
        if not paged:
            cache["max_length"] = 0
        elif not cfg.attention_free:
            if self_owned:
                cache["block_tables"] = torch.arange(
                    batch * pages_per_seq, dtype=torch.int32,
                    device=self.device).reshape(batch, pages_per_seq)
            else:
                cache["block_tables"] = torch.full((batch, pages_per_seq), -1,
                                                   dtype=torch.int32, device=self.device)
        return cache

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------

    def _unembed(self, params, x, precision):
        x = rms_norm(x, params["final_norm_scale"], self.cfg.norm_eps)
        head = params["emb"].T if self.cfg.tie_embeddings else params["lm_head"]
        # ZeRO-3 gathers the head over the data axes before its GEMM, so the
        # logits come out batch- and vocab-sharded (never partial sums)
        head = zero_gather(head)
        # the lm_head is never quantized (paper §2.1.1); logits are rounded
        # to the activation dtype (bf16), then widened to f32.  Rows are
        # padded to ROW_FLOOR (models.common) for row-count-independent sums.
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        # a DTensor's rows are each rank's own: no padding
        logits = linear(x2 if is_dtensor(x2) else pad_rows(x2), head, precision=precision,
                        quantized=False)
        # logits are the biggest activation (B, T, V f32): the rules shard T
        # over the model axis so the CE stays local
        return constrain(logits[: x2.shape[0]].reshape(lead + (-1,)).float(), "logits")

    def _layers(self, params, cache):
        """(slot name, spec, layer params, layer cache) for every layer, the
        layer cache {"kv_cache": ...} or {"ssm_state": ...}, with
        {"cross_cache": ..., "src_lengths": ...} for an enc-dec decoder
        (views)."""
        for r in range(self.repeats):
            slot_params = _layer(params["blocks"], r)
            for j, spec in enumerate(self.pattern):
                name = f"s{j}"
                sd = cache["slots"][name]
                sc = {"ssm_state": sd["ssm"].layer(r)} if "ssm" in sd else \
                    {"kv_cache": sd["kv"].layer(r)}
                if "cross" in sd:
                    sc.update(cross_cache=sd["cross"].layer(r),
                              src_lengths=cache["src_lengths"])
                yield name, spec, slot_params[name], sc

    def _fill_cross(self, params, inputs, cache, precision):
        """Enc-dec prefill: encode `inputs["frames"]` (masked by
        `inputs["src_lengths"]` when given, which then become the cache's)
        and quantize every decoder layer's cross K/V into the cache's
        cross caches in place, their current scales seeding the
        quantization (`attention.cross_attention_cache`)."""
        src_lengths = inputs.get("src_lengths")
        if src_lengths is not None:
            src_lengths = src_lengths.to(self.device, torch.int32)
        enc_out = _encode(params, inputs["frames"].to(self.device, self.dtype), self.cfg,
                          precision, src_lengths)
        if src_lengths is not None:
            cache["src_lengths"].copy_(src_lengths)
        for r in range(self.repeats):
            slot_params = _layer(params["blocks"], r)
            for j, spec in enumerate(self.pattern):
                if spec.cross:
                    attn_mod.cross_attention_cache(
                        enc_out, slot_params[f"s{j}"]["cross"], self.cfg, precision,
                        cache["slots"][f"s{j}"]["cross"].layer(r))

    # ------------------------------------------------------------------
    # prefill / decode
    # ------------------------------------------------------------------

    def prefill(self, params, inputs: dict, cache: dict,
                precision: PrecisionConfig, *, want_routing: bool = False):
        """Process right-padded prompts `inputs["tokens"]` (B, T) with
        lengths `inputs["lengths"]` (B,), fill the cache, return the logits
        at each last valid position (B, V) f32 and the cache — and with
        `want_routing` the routing, {MoE slot: (R, B, T, K)}.  A VLM's
        `inputs["patches"]` (B, P, D) go ahead of the text (P + T
        positions, attended causally as in the reference; the lengths
        become lengths + P).  An enc-dec model first encodes
        `inputs["frames"]` (B, S_src, D), S_src the cross caches' length,
        into its cross caches (`_fill_cross`).  A contiguous cache takes
        P + T <= S_max and records max(lengths) + P on the host (one device
        sync when the lengths are a CUDA tensor).  SSM slots run from the
        cache's state (zeros in a fresh cache) and leave the state at each
        row's last valid token in it."""
        if self.cfg.is_encdec:
            self._fill_cross(params, inputs, cache, precision)
        x, prefix_len = _decoder_inputs(params, inputs, self.cfg, precision, self.device)
        lengths = inputs["lengths"].to(self.device, torch.int32) + prefix_len
        b, t = x.shape[:2]
        kv0 = _first_kv(cache)
        contiguous = "max_length" in cache
        if isinstance(kv0, attn_mod.KVCache) and t > kv0.max_len:
            raise ValueError(f"prompts of {t} positions exceed the cache's {kv0.max_len}")
        positions = torch.arange(t, device=self.device)[None, :]
        routing = {}
        for name, spec, p, sc in self._layers(params, cache):
            x, aux = blocks_mod.apply_slot_full(
                x, p, spec, self.cfg, precision, positions=positions,
                lengths=lengths, block_tables=cache.get("block_tables"), **sc)
            if aux:
                routing.setdefault(name, []).append(aux["topk_idx"])
        cache["lengths"] = lengths
        if contiguous:
            # meta lengths (the dry run) hold no values: the padded length bounds them
            cache["max_length"] = 0 if not b else t if lengths.is_meta \
                else int(inputs["lengths"].max()) + prefix_len
        idx = torch.clamp(lengths.long() - 1, 0, t - 1)
        logits = self._unembed(params, _rows_at(x, idx), precision)
        if want_routing:
            return logits, cache, _stack_routing(routing)
        return logits, cache

    def prefill_chunk(self, params, tokens, start, chunk_lengths, cache: dict,
                      precision: PrecisionConfig, *, use_kernel: bool = False,
                      want_all_logits: bool = False, want_routing: bool = False):
        """One chunk of prompt tokens (B, C) of a *paged* cache: write the
        chunk's K/V at [start, start + chunk_lengths) and attend each
        position over everything reachable so far — through kernel 5 with
        `use_kernel`, else through the reference's table gather.  `start`
        and `chunk_lengths` (B,) are host ints (they size the gather with
        no device sync).  Returns the logits at each row's last valid
        position (B, V) f32 — or at every chunk position (B, C, V) with
        `want_all_logits` (the speculative verifier) — and the cache, whose
        "lengths" become start + chunk_lengths; with `want_routing` also
        the chunk's routing, {MoE slot: (R, B, C, K)}.  SSM slots carry
        their state from chunk to chunk (a ragged last chunk's padded
        positions are state no-ops), so an attention-free cache (no block
        tables) streams through here too."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, c = tokens.shape
        start_h = np.asarray(start, np.int64).reshape(b)
        n_h = np.asarray(chunk_lengths, np.int64).reshape(b)
        new_h = start_h + n_h
        tables = cache.get("block_tables")
        live = None
        if tables is not None:
            live = attn_mod._live_blocks(np.minimum(start_h + c, new_h),
                                         tables.shape[1], _first_kv(cache).block_size)
        start_t = torch.as_tensor(start_h, dtype=torch.int32, device=self.device)
        lengths_t = torch.as_tensor(new_h, dtype=torch.int32, device=self.device)
        x = params["emb"][tokens.long()]
        routing = {}
        for name, spec, p, sc in self._layers(params, cache):
            x, aux = blocks_mod.apply_slot_full(
                x, p, spec, self.cfg, precision, lengths=lengths_t,
                block_tables=tables, chunk_start=start_t,
                use_kernel=use_kernel, live_blocks=live, **sc)
            if aux:
                routing.setdefault(name, []).append(aux["topk_idx"])
        cache["lengths"] = lengths_t
        if not want_all_logits:
            idx = np.clip(n_h - 1, 0, c - 1)
            x = x[torch.arange(b, device=self.device),
                  torch.as_tensor(idx, device=self.device)]
        logits = self._unembed(params, x, precision)
        if want_routing:
            return logits, cache, _stack_routing(routing)
        return logits, cache

    def decode_step(self, params, tokens: torch.Tensor, cache: dict,
                    precision: PrecisionConfig, *,
                    use_kernel: Optional[bool] = None,
                    live_blocks: Optional[int] = None,
                    want_routing: bool = False):
        """One autoregressive step on (B,) tokens -> (logits (B, V), cache),
        and with `want_routing` the reference's aux, {"routing": {MoE slot:
        (R, B, 1, K)}}, third.
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
        lengths + 1; all entries when None).  SSM slots advance their
        recurrent state in place (every row's; O(1) per token, no bound)."""
        kv0 = _first_kv(cache)
        contiguous = "max_length" in cache
        if isinstance(kv0, attn_mod.KVCache) and cache["max_length"] >= kv0.max_len:
            raise ValueError(
                f"decode step past the cache: a length reaches {cache['max_length']}"
                f" and the cache holds {kv0.max_len} positions")
        lengths = cache["lengths"]
        x = _embed(params["emb"], tokens.to(self.device).long())[:, None, :]
        routing = {}
        for name, spec, p, sc in self._layers(params, cache):
            x, aux = blocks_mod.apply_slot_decode(
                x, p, spec, self.cfg, precision, lengths=lengths,
                block_tables=cache.get("block_tables"),
                use_kernel=use_kernel, live_blocks=live_blocks, **sc)
            if aux:
                routing.setdefault(name, []).append(aux["topk_idx"])
        cache["lengths"] = lengths + 1
        if contiguous:
            cache["max_length"] += 1
        logits = self._unembed(params, x[:, 0], precision)
        if want_routing:
            return logits, cache, {"routing": _stack_routing(routing)}
        return logits, cache


# ---------------------------------------------------------------------------
# training / scoring forward
# ---------------------------------------------------------------------------

def _remat_context():
    """`checkpoint`'s context_fn: the recompute, which autograd may run on
    another thread (a CUDA backward does), sees the forward's
    activation-sharding rules and attention impl."""
    rules, impl = active_rules(), attn_mod._impl()

    @contextlib.contextmanager
    def recompute():
        with activation_sharding(rules), attn_mod.attention_impl(impl):
            yield

    return contextlib.nullcontext(), recompute()


def _checkpoint(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_remat_context)


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


class _SumOverGroup(torch.autograd.Function):
    """Sum over a process group (the functional all-reduce); the gradient
    passes through, since every rank holds the whole sum's gradient."""

    @staticmethod
    def forward(ctx, x, group_name):
        c10d = torch.ops._c10d_functional
        return c10d.wait_tensor(c10d.all_reduce(x.contiguous(), "sum", group_name))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _embed(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """emb[tokens].  A DTensor table is looked up vocab-parallel (Megatron's
    embedding; DTensor's strategies for sharded index ops differ between
    torch releases): each rank gathers its vocab rows at full width, looks
    up the tokens that fall in them (zeros for the others), and the
    lookups are summed over the vocab mesh dims; the rows' gradients come
    back as partial sums over the token shards."""
    if not is_dtensor(emb):
        return emb[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = emb.device_mesh
    if not is_dtensor(tokens):
        tokens = replicate_like(tokens, emb)
    vocab = [i for i, p in enumerate(emb.placements) if p == Shard(0)]
    table_pl = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    tok_pl = [Replicate() if i in vocab else p for i, p in enumerate(tokens.placements)]
    table = emb.redistribute(mesh, table_pl).to_local(grad_placements=[
        p if i in vocab else Replicate() if tok_pl[i] == Replicate() else Partial()
        for i, p in enumerate(table_pl)])
    _, offset = compute_local_shape_and_global_offset(emb.shape, mesh, table_pl)
    rows = tokens.redistribute(mesh, tok_pl).to_local() - offset[0]
    hit = (rows >= 0) & (rows < table.shape[0])
    x = table[rows.clamp(0, table.shape[0] - 1)] * hit[..., None].to(table.dtype)
    for i in vocab:
        x = _SumOverGroup.apply(x, mesh.get_group(i).group_name)
    shape = (*tokens.shape, emb.shape[-1])
    return DTensor.from_local(x, mesh, tok_pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, T, D)[arange(B), idx] -> (B, D).  A DTensor x keeps its batch
    and feature shards (a sharded sequence is gathered first); `idx` is a
    plain (B,) tensor, the same on every rank."""
    if not is_dtensor(x):
        return x[torch.arange(x.shape[0], device=idx.device), idx]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = x.device_mesh
    x_pl = [Replicate() if p in (Shard(1),) or not isinstance(p, (Shard, Replicate))
            else p for p in x.placements]
    xl = x.redistribute(mesh, x_pl).to_local()
    _, off = compute_local_shape_and_global_offset(x.shape, mesh, x_pl)
    rows = idx[off[0]:off[0] + xl.shape[0]]
    out = xl[torch.arange(xl.shape[0], device=xl.device), rows.to(xl.device)]
    shape = (x.shape[0], x.shape[2])
    return DTensor.from_local(out.contiguous(), mesh,
                              [Shard(1) if p == Shard(2) else p for p in x_pl],
                              run_check=False, shape=shape, stride=(shape[1], 1))


def _decoder_inputs(params, inputs: dict, cfg, precision, device):
    """(x (B, T, D), prefix_len): the token embeddings, after a VLM's
    patches (B, P, D) projected by `frontend/w_patch` (P positions of
    prefix; taken in the embedding's dtype, bf16, as the reference's specs
    and engine give them)."""
    x = _embed(params["emb"], inputs["tokens"].to(device).long())
    if cfg.frontend != "vision_patches":
        return x, 0
    patches = inputs["patches"].to(device, x.dtype)
    proj = linear(patches, params["frontend"]["w_patch"], precision=precision)
    return torch.cat([proj, x], dim=1), patches.shape[1]


def _encode(params, frames, cfg, precision, src_lengths=None, remat: bool = False):
    """The bidirectional encoder over frames (B, S_src, D) (projected by
    `frontend/w_patch` for audio frames), keys and queries past
    `src_lengths` masked, then its final norm.  With `remat` each layer
    runs under `torch.utils.checkpoint`."""
    x = frames
    if cfg.frontend == "audio_frames":
        x = linear(x, params["frontend"]["w_patch"], precision=precision)
    mask = None
    if src_lengths is not None:
        valid = torch.arange(x.shape[1], device=x.device)[None] \
            < src_lengths.to(x.device)[:, None]
        mask = valid[:, None, :] & valid[:, :, None]
    pattern = _enc_pattern(cfg)

    def body(h, slot_params):
        for j, spec in enumerate(pattern):
            h, _ = blocks_mod.apply_slot_full(h, slot_params[f"s{j}"], spec, cfg, precision,
                                              mask=mask, causal=False)
        return h

    enc = params["enc"]
    for slot_params in _unbind_layers(enc["blocks"], blocks_mod.n_repeats(cfg, decoder=False)):
        x = _checkpoint(body, x, slot_params) if remat else body(x, slot_params)
    return rms_norm(x, enc["final_norm_scale"], cfg.norm_eps)


def _train_mask(t: int, lengths, device, prefix_len: int = 0) -> torch.Tensor:
    """(1, T, T) causal (the first `prefix_len` keys visible to every
    query: the prefix-LM mask of a VLM), or (B, T, T) with keys past
    `lengths` masked."""
    mask = attn_mod.causal_mask(t, device)[None]
    if prefix_len:
        mask = mask | (torch.arange(t, device=device) < prefix_len)[None, None, :]
    if lengths is not None:
        valid = torch.arange(t, device=device)[None] < lengths.to(device)[:, None]
        mask = mask & valid[:, None, :]
    return mask


def forward_train(params: dict, inputs: dict, cfg,
                  precision: Optional[PrecisionConfig] = None, *,
                  forced_routing: Optional[dict] = None,
                  want_routing: bool = False):
    """Full teacher-forced forward over `inputs["tokens"]` (B, T), keys
    masked causally and past `inputs["lengths"]` when given; a VLM's
    `inputs["patches"]` (B, P, D) form a fully visible prefix (logits over
    P + T positions, aux["prefix_len"] = P), an enc-dec model's decoder
    attends over the encoded `inputs["frames"]` (masked past
    `inputs["src_lengths"]`).  Returns
    (logits (B, T, V) f32, aux); aux has the reference's keys: "moe",
    {MoE slot: {"router_entropy", "dropped_frac", "aux_loss",
    "router_logits_amax"}, each (R,) over the repeats} (empty for a
    dense model), and with `want_routing` "routing", {MoE slot: (R, B,
    T, K)}.  `forced_routing` ({MoE slot: (R, B, T, K)}) replays a
    routing (RRR).  Runs on the params' device.  While autograd records,
    each layer runs under `torch.utils.checkpoint` and is recomputed in
    the backward (the reference's `jax.checkpoint`); the MoE layer's ops
    are deterministic, so the recompute routes as the forward did."""
    model = Transformer(cfg, params["emb"].device)
    dev = model.device
    lengths = inputs.get("lengths")
    src_lengths = inputs.get("src_lengths")
    if is_dtensor(src_lengths):     # whole on every rank: plain masks
        src_lengths = src_lengths.full_tensor()
    remat = torch.is_grad_enabled()
    enc_out = None
    if cfg.is_encdec:
        enc_out = _encode(params, inputs["frames"].to(dev, params["emb"].dtype), cfg,
                          precision, src_lengths, remat=remat)
    x, prefix_len = _decoder_inputs(params, inputs, cfg, precision, dev)
    x = constrain(x, "act_btd")
    t = x.shape[1]
    mask = _train_mask(t, lengths, dev, prefix_len)
    positions = torch.arange(t, device=dev)[None, :]

    def body(h, slot_params, forced):
        auxes = {}
        for j, spec in enumerate(model.pattern):
            name = f"s{j}"
            h, aux = blocks_mod.apply_slot_full(
                h, slot_params[name], spec, cfg, precision,
                positions=positions, mask=mask, lengths=lengths, prefix_len=prefix_len,
                forced_topk=forced.get(name) if forced else None,
                enc_out=enc_out, src_lengths=src_lengths)
            if aux:
                auxes[name] = aux
        return h, auxes

    per_layer = []
    for r, slot_params in enumerate(_unbind_layers(params["blocks"], model.repeats)):
        forced = None if forced_routing is None else \
            {name: idx[r] for name, idx in forced_routing.items()}
        x, auxes = _checkpoint(body, x, slot_params, forced) if remat \
            else body(x, slot_params, forced)
        per_layer.append(auxes)
    moe, routing = {}, {}
    for name in per_layer[0] if per_layer else ():
        stacked = {k: torch.stack([a[name][k] for a in per_layer]) for k in per_layer[0][name]}
        routing[name] = stacked.pop("topk_idx")
        moe[name] = stacked
    aux = {"moe": moe}
    if want_routing:
        aux["routing"] = routing
    if prefix_len:
        aux["prefix_len"] = prefix_len
    return model._unembed(params, x, precision), aux


def token_logprobs(params: dict, inputs: dict, cfg,
                   precision: Optional[PrecisionConfig] = None, **kw):
    """log p(token_t | tokens_<t) for t >= 1, (B, T-1) f32 — the
    trainer-side scoring pass behind the TIS ratios and the mismatch KL
    (paper §2.1.3).  Returns (logprobs, aux); `kw` goes to
    `forward_train` (`forced_routing`, `want_routing`).  A VLM's prefix
    positions are sliced off first."""
    logits, aux = forward_train(params, inputs, cfg, precision, **kw)
    tokens = inputs["tokens"].to(logits.device).long()
    logits = logits[:, aux.get("prefix_len", 0):]
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None])[..., 0], aux
