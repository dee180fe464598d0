"""Step builders and input specs for training, prefill and decode (port
of `repro.launch.steps`).

    train_step(params, opt_state, batch) -> (params, opt_state, loss)
    prefill_step(params, batch)          -> (last_logits, cache)
    serve_step(params, tokens, cache)    -> (logits, cache)

The train step is the learner-side LM step: `forward_train`, the mean
next-token CE over the text positions (after a VLM's prefix), plus
`moe_aux_coef` x the mean of each MoE layer's aux loss, its gradient,
then `optim.adamw.update` (in place).  With `rules`
(`distributed.ShardingRules` on a `DeviceMesh`) the same step runs
sharded: params and moments are DTensors laid out by `rules.params`
(`distributed.distribute`), the batch is laid out by `rules.batch_spec`,
the model's `constrain` calls take the rules' activation layouts, and
DTensor's sharding propagation inserts the collectives (the reference's
GSPMD).

Both run the contiguous-cache path of `models.Transformer` on CUDA unless
given a device: the prefill fills a cache of seq_len + 1 positions and
returns only the last-position logits; each serve step appends one token
and attends through kernel 6 (`fp8_decode_attention`).  They are eager,
like the paged path (no `torch.compile`, no CUDA graph).  A serve step
whose write would land past the cache raises a `ValueError` on the host
before any launch (the reference's XLA scatter drops it silently).  With
`rules` they run sharded too: W8A8 params as DTensors, the batch by
`rules.batch_spec`, the cache by `rules.cache_spec` (`shard_cache`, each
rank allocating its own shards), kernels 1 and 3 on each rank's weight
shards (`core.fp8_linear`) and kernel 6 over its local KV heads.

`input_specs`, `cache_specs` and `param_specs` are the counterpart of the
reference's `ShapeDtypeStruct` stand-ins: tensors on the "meta" device,
with shapes and dtypes and no storage.  An SSM layer's cache is its O(1)
recurrent state (h f32, conv tail bf16), so jamba's LONG_500K cache holds
dense KV in only its attention layers and mamba2's none.  The frontends
are stubs, as in the reference: a VLM's inputs are precomputed patch
embeddings (B, P, D), P = min(frontend_len, S // 2), ahead of S - P text
tokens; an enc-dec model's are frames (B, S, D) with `src_lengths`, and
its cache holds cross K/V over S source positions.  `make_opt_specs`
gives the AdamW state of `param_specs` on meta (f32 or fp8 moments).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import is_dtensor, resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import fp8_params
from repro_torch.core.precision import E4M3, PrecisionConfig, RouterDtype
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.common import activation_sharding
from repro_torch.models.transformer import Transformer, forward_train
from repro_torch.optim import adamw

META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Model inputs of one cell as meta tensors: train and prefill take
    tokens (B, S) (prefill also lengths (B,)) — a VLM patches (B, P, D)
    bf16 and tokens (B, S - P), P = min(frontend_len, S // 2), an enc-dec
    model also frames (B, S, D) bf16 and src_lengths (B,); decode takes
    one token (B,) against a cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    bf16 = dict(dtype=torch.bfloat16, device=META)
    if shape.kind == "decode":
        return {"tokens": torch.empty((b,), **i32)}
    specs = {"tokens": torch.empty((b, s), **i32)}
    if shape.kind == "prefill":
        specs["lengths"] = torch.empty((b,), **i32)
    if cfg.frontend == "vision_patches":
        p = min(cfg.frontend_len, s // 2)
        specs["patches"] = torch.empty((b, p, cfg.d_model), **bf16)
        specs["tokens"] = torch.empty((b, s - p), **i32)
    elif cfg.is_encdec:
        specs["frames"] = torch.empty((b, s, cfg.d_model), **bf16)
        specs["src_lengths"] = torch.empty((b,), **i32)
    return specs


def cache_specs(cfg: ArchConfig, shape: ShapeConfig,
                precision: PrecisionConfig) -> dict:
    """The contiguous rollout cache of a cell (S_max = seq_len) on meta:
    KV for the attention layers, the recurrent state for the SSM ones, and
    an enc-dec decoder's cross K/V over seq_len source positions."""
    return Transformer(cfg, META).init_cache(
        shape.global_batch, shape.seq_len, precision,
        src_len=shape.seq_len if cfg.is_encdec else 0)


def param_specs(cfg: ArchConfig, precision: Optional[PrecisionConfig] = None) -> dict:
    """Param shapes on meta; with `precision`, the rollout tree that
    `core.fp8_params.quantize_params` makes: the linears it quantizes
    (E4M3 payload, f32 scales per 128x128 block) when `precision`
    quantizes them, and an MoE router in the router dtype (E4M3 blocks
    under the FP8 router)."""
    specs = Transformer(cfg, META).init_params(0)
    if precision is None:
        return specs

    def blocks(leaf):
        *lead, k, n = leaf.shape
        scales = torch.empty((*lead, -(-k // 128), -(-n // 128)), dtype=torch.float32,
                             device=META)
        return QuantizedTensor(torch.empty(leaf.shape, dtype=E4M3, device=META), scales,
                               (1,) * len(lead) + (128, 128))

    def rollout(path, leaf):
        if "router" in path:
            if precision.router_dtype == RouterDtype.FP8:
                return blocks(leaf)
            dtype = torch.float32 if precision.router_dtype == RouterDtype.FP32 \
                else torch.bfloat16
            return torch.empty(leaf.shape, dtype=dtype, device=META)
        if precision.quantize_linears and fp8_params.default_quant_filter(path, leaf):
            return blocks(leaf)
        return leaf

    return fp8_params._map_with_path(rollout, specs)


def _sharded_device(device, rules):
    """The device of a sharded step's local tensors: `device`, else the
    mesh's (the current CUDA device for a "cuda" mesh)."""
    return resolve_device(device if device is not None else rules.mesh.device_type)


def shard_cache(cfg: ArchConfig, batch: int, max_len: int, precision: PrecisionConfig,
                rules, *, src_len: int = 0, device=None) -> dict:
    """`Transformer.init_cache`'s contiguous cache laid out by
    `rules.cache_spec` on `rules.mesh`: each tensor a DTensor of which
    this rank allocates only its own shard, at the init values (zeros;
    ones for the KV scales).  The lengths (B,) stay plain tensors, whole
    on every rank, and "max_length" a host int.  On `device` ("meta" for
    the dry run), else the mesh's."""
    import dataclasses

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.distributed.sharding import placements

    dev = _sharded_device(device, rules)
    mesh = rules.mesh
    meta = Transformer(cfg, META).init_cache(batch, max_len, precision, src_len=src_len)

    def build(tree, spec, key):
        if isinstance(tree, dict):
            return {k: build(v, spec[k], k) for k, v in tree.items()}
        if dataclasses.is_dataclass(tree):
            return type(tree)(**{f.name: build(getattr(tree, f.name), getattr(spec, f.name),
                                               f.name)
                                 for f in dataclasses.fields(tree)})
        if not isinstance(tree, torch.Tensor):
            return tree
        value = max(src_len, 1) if key == "src_lengths" else 1 if "scale" in key else 0
        if key in ("lengths", "src_lengths"):
            return torch.full(tree.shape, value, dtype=tree.dtype, device=dev)
        places = placements(mesh, spec)
        local_shape, _ = compute_local_shape_and_global_offset(tree.shape, mesh, places)
        local = torch.zeros(local_shape, dtype=tree.dtype, device=dev)
        if value:
            local.fill_(value)
        return DTensor.from_local(local, mesh, places, run_check=False, shape=tree.shape,
                                  stride=tree.stride())

    return build(meta, rules.cache_spec(meta), "")


def _shard_batch(batch: dict, rules, dev) -> dict:
    """The batch on `dev`, its token, patch and frame tensors laid out by
    `rules.batch_spec` (the lengths stay plain, whole on every rank)."""
    from repro_torch.distributed.sharding import distribute, register_dtensor_ops

    register_dtensor_ops()
    batch = {k: v.to(dev) for k, v in batch.items()}
    split = {k: v for k, v in batch.items() if k in ("tokens", "patches", "frames")}
    return {**batch, **distribute(split, rules.batch_spec(split), rules.mesh)}


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig,
                      precision: PrecisionConfig, device=None, *, rules=None):
    """Prompt processing into a fresh contiguous cache of seq_len + 1
    positions (and zero SSM state; cross caches over seq_len source
    positions for an enc-dec model, whose batch carries frames of
    seq_len); returns only the last-position logits (B, V) f32 and the
    cache.  With `rules` (`distributed.ShardingRules` on a mesh) the step
    runs sharded: params are DTensors (`distributed.distribute(params,
    rules.params(params), mesh)`, W8A8 payloads and scales included, each
    linear through kernels 1 and 3 on the local shards), the batch is laid
    out by `rules.batch_spec`, the cache by `rules.cache_spec`
    (`shard_cache`), and the logits come back as a DTensor."""
    b, s = shape.global_batch, shape.seq_len
    src = s if cfg.is_encdec else 0
    if rules is not None:
        dev = _sharded_device(device, rules)
        model = Transformer(cfg, dev)

        def sharded_prefill_step(params, batch):
            batch = _shard_batch(batch, rules, dev)
            cache = shard_cache(cfg, b, s + 1, precision, rules, src_len=src, device=dev)
            with activation_sharding(rules):
                return model.prefill(params, batch, cache, precision)

        return sharded_prefill_step
    model = Transformer(cfg, device)

    def prefill_step(params, batch):
        cache = model.init_cache(b, s + 1, precision, src_len=src)
        return model.prefill(params, batch, cache, precision)

    return prefill_step


def make_serve_step(cfg: ArchConfig, precision: PrecisionConfig, device=None, *,
                    rules=None):
    """One decode token (B,) against an existing contiguous cache, through
    kernel 6 on the card (its plain version on the CPU) in the attention
    layers and the recurrent step in the SSM ones.  With `rules` the step
    runs sharded, as `make_prefill_step`'s: the tokens laid out by
    `rules.batch_spec`, the cache a `shard_cache` (or a sharded prefill's),
    kernel 6 over each rank's local KV heads."""
    if rules is not None:
        dev = _sharded_device(device, rules)
        model = Transformer(cfg, dev)

        def sharded_serve_step(params, tokens, cache):
            tokens = _shard_batch({"tokens": tokens}, rules, dev)["tokens"]
            with activation_sharding(rules):
                return model.decode_step(params, tokens, cache, precision)

        return sharded_serve_step
    model = Transformer(cfg, device)

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache, precision)

    return serve_step


def _lm_loss(params, batch, cfg, precision, moe_aux_coef):
    logits, aux = forward_train(params, batch, cfg, precision)
    tokens = batch["tokens"]
    logits = logits[:, aux.get("prefix_len", 0):]
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ce = -torch.mean(torch.gather(lp, -1, tokens[:, 1:, None].long()))
    if is_dtensor(ce):
        # the loss is a plain scalar, the same on every rank (a sharded MoE
        # layer's aux losses are plain: it routes replicated)
        ce = ce.full_tensor()
    if aux["moe"]:
        ce = ce + moe_aux_coef * sum(v["aux_loss"].mean() for v in aux["moe"].values())
    return ce


def make_loss_and_grads(cfg: ArchConfig, precision: Optional[PrecisionConfig] = None,
                        moe_aux_coef: float = 1e-2, *, device=None, rules=None):
    """The train step's loss and gradient: (params, batch) -> (loss,
    grads), grads a tree like params (DTensors with `rules`, in the
    layouts autograd left them).  Devices and layouts as in
    `make_train_step`."""
    dev = None if rules is not None else resolve_device(device)

    def loss_and_grads(params, batch):
        leaves = list(fp8_params.tree_leaves(params))
        if rules is None:
            batch = {k: v.to(dev) for k, v in batch.items()}
        else:
            from repro_torch.distributed.sharding import distribute, register_dtensor_ops

            register_dtensor_ops()
            mesh = leaves[0].device_mesh
            batch = {k: v if v.is_meta else v.to(mesh.device_type) for k, v in batch.items()}
            batch = distribute(batch, rules.batch_spec(batch), mesh)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with activation_sharding(rules), torch.enable_grad():
                loss = _lm_loss(params, batch, cfg, precision, moe_aux_coef)
                grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), fp8_params.tree_fill(params, grads)

    return loss_and_grads


def make_train_step(cfg: ArchConfig, precision: Optional[PrecisionConfig] = None,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    moe_aux_coef: float = 1e-2, *, device=None, rules=None):
    """Learner-side LM training step (forward + backward + AdamW), params
    and moments updated in place.  One device (CUDA unless `device` says
    otherwise; params and moments on it, the batch moved there), or with
    `rules` sharded over `rules.mesh`: params and moments are DTensors
    (`distributed.distribute(params, rules.params(params), mesh)`, then
    `adamw.init`), each rank hands the whole batch and keeps its
    `rules.batch_spec` shard, and the loss comes back replicated."""
    if opt_cfg is None:
        opt_cfg = adamw.AdamWConfig()
    loss_and_grads = make_loss_and_grads(cfg, precision, moe_aux_coef,
                                         device=device, rules=rules)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state, _ = adamw.update(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    return train_step


def make_opt_specs(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig) -> adamw.AdamWState:
    """The AdamW state of `param_specs(cfg)` on meta: step (), and f32
    moments or `QuantizedTensor` ones (E4M3 payload, f32 scales per 128
    elements of the last axis) under `opt_cfg.fp8_moments`."""
    return adamw.init(param_specs(cfg), opt_cfg)
