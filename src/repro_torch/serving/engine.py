"""Serving engine: the execution mechanism over a paged FP8/BF16 KV pool
(port of `repro.serving.engine`: dense, MoE, SSM, hybrid and enc-dec
decoders).

Every admission / eviction / growth / chunking decision lives in the
ported `Scheduler`; the engine runs the device work of each planned step,
in plan order:

    decision = scheduler.step(engine)   # policy + host bookkeeping
    engine.execute(decision)            # device work, in plan order

What it does, as the reference does:

* Paged KV: one pool of fixed-size blocks per attention layer (stacked
  over the layers, `models.attention.PagedKVCache`), per-slot block
  tables, a trash row for padding and masked writes.  A block is
  `block_size` bf16-KV tokens' worth of bytes, so FP8 KV holds 2x the
  tokens per block (`BlockManager`).
* Prefill one-shot (`prefill_chunk=None`: the whole prompt through one
  `prompt_pad`-wide batch-1 trace) or chunked (`Transformer.
  prefill_chunk`, C tokens at a time between decode steps; a prompt whose
  leading full blocks hit the prefix index starts past them).  The first
  quantized prefill calibrates the pool's KV scales as ONE full-width
  chunk; later ones reuse the locked scales, which survive swaps.
* `KernelConfig` ("off" / "decode" / "prefill" / "all"): chunks and
  speculative verifies through kernel 5 (`fp8_paged_prefill_attention`),
  the fused decode through kernel 4 (`fp8_paged_decode_attention`), or
  either through the reference's table gather.  The port defaults to
  "all" ("off" is the reference's default), except under
  `quantize_attention`, where its default is the reference's "off" with
  the QDQ'd attention (`KernelConfig.resolve`); an explicit "all" keeps
  the kernels there, which skip the QDQ as the reference's do.
* Prefix sharing with refcounts and copy-on-write (`paged_copy_rows`).
* Preemption as allocator demote/promote: a victim's valid blocks go to a
  host tier of CPU tensors and come back into fresh pool rows; nothing is
  recomputed, and restored tokens count as `wasted_tokens`.
* Speculative decoding (n-gram drafts, one verify chunk, rejection
  sampling, KV rewind by a length truncation).
* The fused decode runs every slot's row; mid-prefill slots have their
  table rows masked to the trash row for it and restored afterwards, and
  their lengths restored.
* SSM slot state (mamba2, jamba's hybrid pattern): each SSM layer's h and
  conv tail live slot-indexed in the cache, not in the pool.  A fresh
  admission zeroes the slot's rows; a swap-out copies them to the host
  with the victim's blocks and a swap-in restores them into whichever
  slot it resumes in, charging `state_swap_tokens` as wasted; the fused
  decode writes back the rows of the slots it masks, so a mid-prefill
  slot's recurrence never absorbs a decode token.  The per-request state
  (`request_state_bytes`) is priced into the budget as `state_blocks`
  block-equivalents; an attention-free model has no pool and no tables
  and is bounded by it alone.  Its state cannot be rewound or shared, so
  speculation and the shared-prefix compute skip are off for any SSM
  pattern.
* Enc-dec slot state (seamless): each request carries `frames` through
  `submit()` (at most `max_src_len` of them); its one-shot prefill
  encodes them padded to `max_src_len` (`src_lengths` masks the padding)
  and quantizes every decoder layer's cross K/V once into the slot's rows
  of the cross caches, with the pool-wide per-layer cross scales (set by
  the first prefill's calibration, then kept).  The cross rows and the
  slot's source length go to the host with a swap-out and come back with
  the swap-in, charged like SSM state; `request_state_bytes(src_len)`
  prices the cross KV into the budget.  Decoder KV depends on the
  frames, so prefix sharing, the shared-prefix skip, speculation and
  chunked prefill are off for enc-dec.

Where the reference updates its pools functionally (`.at[].set`), the
port updates them in place.  Host-side state mirrors the reference:
`self._lengths` holds every slot's KV length on the host (the device
copy is uploaded before each fused decode), so sizing a gather never
waits for the device.  The RNG is a `torch.Generator` seeded from `seed`
on the engine's device.

Observability: one tracer per engine (`obs.tracer`); every site is one
``if self.tracer.enabled:`` branch, so with `NULL_TRACER` the engine does
exactly what it did without one.  The fleet front-end over N replicas is
`serving.frontend`.

A VLM (pixtral) is refused: the reference's engine has no patch input
(its one-shot prefill never passes `patches`), so no engine run of the
reference exists to port.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.sampling import rejection_sample, sample
from repro_torch.data import tasks
from repro_torch.kernels.config import KernelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blocks_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.transformer import Transformer
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.block_manager import BlockManager
from repro_torch.serving.faults import NULL_INJECTOR
from repro_torch.serving.scheduler import (
    Admit,
    Cow,
    Draft,
    Grow,
    Prefill,
    ScheduleDecision,
    Scheduler,
    StepBudget,
    SwapOut,
    Verify,
)
from repro_torch.serving.spec_decode import SpecConfig


def kv_bytes_per_token(cfg, precision: PrecisionConfig) -> int:
    """Self-attention KV bytes one token occupies across all attention
    layers (scales amortize to ~0)."""
    if cfg.attention_free:
        return 0
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    elem = 1 if precision.kv_quantized else 2
    return n_attn * 2 * cfg.n_kv_heads * cfg.d_head * elem


def request_state_bytes(cfg, precision: PrecisionConfig, src_len: int = 0) -> int:
    """Constant per-request slot-state bytes beyond the paged KV blocks:
    the SSM recurrent state, h f32 + the conv tail bf16 per SSM layer,
    never quantized, and the cross-attention KV an enc-dec decoder holds
    over `src_len` encoder positions (quantized once at prefill, so FP8
    halves it); 0 for dense and MoE decoders (routing carries no state
    between steps)."""
    total = 0
    repeats = blocks_mod.n_repeats(cfg)
    for spec in blocks_mod.layer_pattern(cfg):
        if spec.mixer == "ssm":
            h = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            conv = (cfg.ssm_conv - 1) * ssm_mod.conv_channels(cfg) * 2
            total += repeats * (h + conv)
        if spec.cross:
            elem = 1 if precision.kv_quantized else 2
            total += repeats * 2 * src_len * cfg.n_kv_heads * cfg.d_head * elem
    return total


def _weak_hook(method):
    """An engine's bound `method` as a callback that holds no reference
    to the engine.  The allocator the engine owns keeps its hooks; a bound
    method there would close a reference cycle (engine -> allocator ->
    method -> engine), and a dropped engine, device pool included, would
    wait for `gc.collect()` instead of being freed by its refcount."""
    ref = weakref.WeakMethod(method)
    return lambda *args: ref()(*args)


def _to_host(rows: torch.Tensor) -> torch.Tensor:
    """A host-tier copy of pool rows: always a copy, never a view of the
    pool (on a CPU engine `.cpu()` would return the pool's own storage)."""
    return rows.to("cpu", copy=True)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) unpadded
    max_new: int
    frames: Optional[np.ndarray] = None   # (S_src, D) enc-dec source frames
    generated: List[int] = dataclasses.field(default_factory=list)
    # parallel to `generated`: the weight version live when each token was
    # sampled, and its logprob (only with want_logps=True)
    token_versions: List[int] = dataclasses.field(default_factory=list)
    token_logps: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    wasted_tokens: int = 0       # tokens re-restored after preemption
    prefilled: int = 0           # prompt tokens whose KV is (being) computed
    cached_tokens: int = 0       # valid KV rows in the pool (host truth)
    last_used: int = 0           # scheduler tick last scheduled (lru)


@dataclasses.dataclass
class ServeReport:
    completed: List[Request]
    steps: int
    preemptions: int
    wasted_tokens: int
    emitted_tokens: int
    mean_occupancy: float
    budget_tokens: int
    swap_outs: int = 0
    swap_ins: int = 0
    peak_blocks_in_use: int = 0
    prefix_hit_blocks: int = 0     # block allocations avoided by sharing
    cow_copies: int = 0            # shared blocks privatized before a write
    prefill_chunks: int = 0        # chunked-prefill traces executed
    spec_steps: int = 0            # speculative verify traces executed
    draft_tokens: int = 0          # tokens proposed across all verifies
    accepted_tokens: int = 0       # draft tokens accepted by rejection
    # True when run() stopped without finishing the submitted work (the
    # schedule went empty, or the runaway guard tripped)
    stalled: bool = False
    kv_pressure: float = 0.0
    latency: Optional[dict] = None  # with a recording tracer only
    gauges: Optional[dict] = None

    @property
    def useful_token_rate(self) -> float:
        """Useful tokens per decode step."""
        return self.emitted_tokens / max(self.steps, 1)

    @property
    def spec_tokens_per_step(self) -> float:
        """Tokens emitted per speculative verify step."""
        return (self.accepted_tokens + self.spec_steps) / \
            max(self.spec_steps, 1)


class ServingEngine:
    def __init__(self, params, cfg, precision: PrecisionConfig, *,
                 max_slots: int = 8, max_seq_len: int = 64,
                 kv_budget_bytes: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 prompt_pad: int = 16, block_size: int = 4,
                 admission: str = "reserve", prefix_sharing: bool = True,
                 eviction: str = "youngest",
                 prefill_chunk: Optional[int] = None,
                 step_budget: Optional[StepBudget] = None,
                 kernel_config=None,
                 eos_id: Optional[int] = tasks.EOS,
                 spec: Optional[SpecConfig] = None,
                 proposer=None,
                 want_logps: bool = False,
                 weight_version: int = 0,
                 host_kv_blocks: int = 0,
                 tracer=None,
                 faults=None,
                 replica_index: int = 0,
                 max_src_len: int = 8,
                 device=None):
        if admission not in ("reserve", "ondemand"):
            raise ValueError(f"unknown admission {admission!r}")
        if cfg.frontend == "vision_patches":
            raise NotImplementedError(
                "the serving engine takes no patch input: the reference's engine "
                "never passes `patches` to its prefill, so a VLM has no engine path "
                "to port (serve it through rl.generate or launch.steps)")
        if prefill_chunk is not None and cfg.is_encdec:
            raise ValueError(
                "enc-dec requests prefill one-shot (the encoder pass over frames is "
                "not chunkable); leave prefill_chunk unset")
        self.model = Transformer(cfg, resolve_device(device))
        self.device = self.model.device
        # an attention-free model takes no attention kernels (raises when
        # one is asked for, as the reference asserts)
        self.kernels = KernelConfig.resolve(kernel_config, precision,
                                            attention_free=cfg.attention_free)
        self.prompt_pad = prompt_pad   # one-shot prefill width
        self.params = params
        self.cfg = cfg
        self.precision = precision
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.temperature = temperature
        self.top_k = top_k
        self.want_logps = want_logps
        self.weight_version = weight_version
        # one tracer per engine; NULL_TRACER keeps every instrumentation
        # site at a single `if self.tracer.enabled` branch when disabled
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.faults = faults if faults is not None else NULL_INJECTOR
        self.replica_index = replica_index
        self._staged_weights = None     # (params, version) for next step()
        self._executing = False         # install_weights boundary guard
        self.admission = admission
        self.eos_id = eos_id           # None = decode max_new tokens always
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.scheduler = Scheduler(eviction=eviction,
                                   prefill_chunk=prefill_chunk,
                                   budget=step_budget,
                                   spec=spec, proposer=proposer)
        self.src_pad = max_src_len     # enc-dec frames capacity per slot
        # speculation's rewind and the shared-prefix compute skip are sound
        # only where the paged KV is the whole carried state: an attention-
        # only pattern (SSM state advances in place and cannot be rewound
        # or shared, cross KV is the frames'); the scheduler reads these
        attention_only = not cfg.is_encdec and all(
            s.mixer == "attn" and not s.cross for s in blocks_mod.layer_pattern(cfg))
        self._spec_ok = attention_only
        self._chunk_skip_ok = attention_only
        if spec is not None and not self._spec_ok:
            raise ValueError(
                "speculative decoding needs an attention-only decoder (paged "
                "KV is the only state the rewind can truncate); this config "
                "has SSM or cross state")
        # prefix sharing keys blocks by prompt tokens; an enc-dec decoder's
        # self-KV also depends on the frames
        prefix_sharing = prefix_sharing and not cfg.is_encdec
        # per-request constant footprint beyond the paged KV (SSM state,
        # cross KV), priced into the byte budget as block-equivalents
        self.state_bytes = request_state_bytes(
            cfg, precision, src_len=max_src_len if cfg.is_encdec else 0)

        per_tok = max(kv_bytes_per_token(cfg, precision), 1)
        if kv_budget_bytes is None:
            kv_budget_bytes = per_tok * max_slots * max_seq_len \
                + max_slots * self.state_bytes
        # a block is `block_size` tokens at bf16 KV width, so fp8 KV doubles
        # the tokens each block holds (the block-capacity mechanism)
        per_tok_bf16 = max(kv_bytes_per_token(
            cfg, precision.replace(kv_cache_dtype="bf16")), 1)
        self._bm_init = dict(
            budget_bytes=kv_budget_bytes,
            block_bytes=block_size * per_tok_bf16, per_tok=per_tok,
            prefix_sharing=prefix_sharing, host_blocks=host_kv_blocks)
        self._fresh_pool()
        # block-equivalents one admitted request's slot state pins against
        # the budget, and the token-units a swap of it costs
        self.state_blocks = -(-self.state_bytes // max(self.block_mgr.block_bytes, 1)) \
            if self.state_bytes else 0
        self.state_swap_tokens = self.state_blocks * self.block_mgr.block_size
        self.done: List[Request] = []
        self._next_rid = 0
        self.stats = dict(preemptions=0, wasted_tokens=0, emitted=0,
                          steps=0, occupancy=0.0, swap_outs=0, swap_ins=0,
                          peak_blocks=0, prefix_hits=0, cow_copies=0,
                          prefill_chunks=0, spec_steps=0, draft_tokens=0,
                          accepted_tokens=0, demoted_blocks=0,
                          promoted_blocks=0)

    def _fresh_pool(self):
        """Allocator, device pool, slots, queue and host tier, empty (at
        construction and at a cold rejoin)."""
        bm = self._bm_init
        self.block_mgr = BlockManager.from_byte_budget(
            bm["budget_bytes"], bm["block_bytes"], bm["per_tok"],
            enable_prefix_sharing=bm["prefix_sharing"],
            host_blocks=bm["host_blocks"])
        self.block_mgr.set_host_callbacks(
            demote_copy=_weak_hook(self._host_copy_out_block),
            host_drop=_weak_hook(self._host_drop_block))
        # mutable token-denominated budget; shrinking it lowers the
        # effective block limit below the physical pool size
        self.budget_tokens = self.block_mgr.capacity_tokens
        self.cache = self.model.init_cache(
            self.max_slots, self.max_seq_len, self.precision,
            page_size=self.block_mgr.block_size,
            num_pages=self.block_mgr.num_blocks,
            src_len=self.src_pad if self.cfg.is_encdec else 0)
        self.has_paged_kv = "block_tables" in self.cache
        self._lengths = np.zeros((self.max_slots,), np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.max_slots
        self.queue: List[Request] = []
        self.pending_tok = np.zeros((self.max_slots,), np.int32)
        # host tier: host block id -> {layer-stack name: (k, v)} CPU rows
        # over the R layers; rid -> {"state": the slot's SSM and cross rows
        # or None, "pending": token} while swapped out
        self.host_pool: Dict[int, Dict[str, tuple]] = {}
        self._host_state: Dict[int, dict] = {}
        # host ids retired before their swap-out copy ran (a same-plan
        # swap-out -> re-admit); `_exec_swap_out` skips writing them
        self._host_dead_on_arrival: set = set()
        self._scales_calibrated = False

    # ------------------------------------------------------------------
    def submit(self, prompt_ids, max_new: int, rid: Optional[int] = None,
               frames=None):
        """Queue a request; an enc-dec model needs its `frames` (S_src,
        d_model), S_src <= `max_src_len`."""
        prompt = np.asarray(prompt_ids, np.int32)
        if self.scheduler.prefill_chunk is None and \
                len(prompt) > self.prompt_pad:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds prompt_pad="
                f"{self.prompt_pad}; enable chunked prefill "
                f"(prefill_chunk=...) to serve long prompts")
        if len(prompt) + max_new > self.max_seq_len:
            # a decode write past the table width would land in the
            # wrong block
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"max_seq_len={self.max_seq_len}")
        if self.cfg.is_encdec:
            if frames is None:
                raise ValueError(
                    "encoder-decoder serving needs frames=(S_src, d_model) "
                    "source embeddings per request")
            frames = np.asarray(frames, np.float32)
            if frames.ndim != 2 or frames.shape[1] != self.cfg.d_model:
                raise ValueError(
                    f"frames must be (S_src, d_model={self.cfg.d_model}); "
                    f"got {frames.shape}")
            if frames.shape[0] > self.src_pad:
                raise ValueError(
                    f"{frames.shape[0]} frames exceed max_src_len={self.src_pad}")
        elif frames is not None:
            raise ValueError("frames only apply to encoder-decoder models")
        if rid is None:
            rid = self._next_rid
        # rid keys BlockManager ownership: keep auto-assignment monotonic
        self._next_rid = max(self._next_rid, rid + 1)
        self.queue.append(Request(rid=rid, prompt=prompt, max_new=max_new, frames=frames))
        if self.tracer.enabled:
            self.tracer.record_submit(self, self.queue[-1])

    def cancel(self, rid: int) -> bool:
        """Drop a request wherever it lives (queued, swapped out, or in a
        slot) and free its blocks on both tiers.  False for an unknown
        rid, so a double cancel is a no-op."""
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(i)
                self.block_mgr.free(rid)
                self._host_state.pop(rid, None)
                return True
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                self.slot_req[slot] = None
                self.block_mgr.free(rid)
                self._clear_slot(slot)
                self._host_state.pop(rid, None)
                return True
        return False

    def reset_for_rejoin(self, params, version: int):
        """Cold restart after a transient crash: fresh allocator, pool,
        slots, queue and host tier, then the fleet's weights through the
        normal install seam.  `done` and the cumulative stats survive."""
        self._fresh_pool()
        self._staged_weights = None
        self.install_weights(params, version)

    # -- live weight updates ------------------------------------------------
    def install_weights(self, params, version: int):
        """In-place weight hot-swap between steps: running requests keep
        their slots, blocks and pending tokens; their later tokens carry
        `version`.  KV scales stay locked (the pool's bytes were quantized
        at them)."""
        if self._executing:
            raise RuntimeError(
                "install_weights must run between engine steps, never "
                "inside execute(); use stage_weights")
        if version < self.weight_version:
            raise ValueError(f"weight version must be monotonic: {version} "
                             f"< {self.weight_version}")
        if self.faults.enabled:
            # the install-failure seam sits before any mutation
            self.faults.on_install(self, version)
        self.params = params
        self.weight_version = version
        if self.tracer.enabled:
            self.tracer.record_weights(self, version, staged=False)

    def stage_weights(self, params, version: int):
        """Queue a hot-swap for the next `step()` boundary."""
        self._staged_weights = (params, version)
        if self.tracer.enabled:
            self.tracer.record_weights(self, version, staged=True)

    def _apply_staged_weights(self):
        if self._staged_weights is not None:
            params, version = self._staged_weights
            self._staged_weights = None
            self.install_weights(params, version)

    # -- accounting ---------------------------------------------------------
    @property
    def block_size(self) -> int:
        return self.block_mgr.block_size

    @property
    def _state_blocks_in_use(self) -> int:
        """Block-equivalents pinned by the active slots' SSM state (from
        slot occupancy, so plan-time slot updates are priced at once)."""
        return self.state_blocks * sum(r is not None for r in self.slot_req)

    @property
    def _effective_blocks(self) -> int:
        """Block limit left for paged KV under the (possibly shrunk)
        token budget, the active slots' state netted out first (a shrink
        can force a preemption on an attention-free model)."""
        return min(self.block_mgr.num_blocks,
                   self.block_mgr.blocks_for_tokens(self.budget_tokens)) \
            - self._state_blocks_in_use

    @property
    def kv_pressure(self) -> float:
        """Fraction of the (possibly shrunk) block budget in live use:
        pool blocks plus slot-state block-equivalents."""
        budget = min(self.block_mgr.num_blocks,
                     self.block_mgr.blocks_for_tokens(self.budget_tokens))
        used = self.block_mgr.blocks_in_use + self._state_blocks_in_use
        return used / max(budget, 1)

    def gauge_snapshot(self) -> dict:
        """Point-in-time pool/slot/spec gauges (JSON-native)."""
        bm = self.block_mgr
        drafted = self.stats["draft_tokens"]
        return {
            "blocks_in_use": bm.blocks_in_use,
            "blocks_free": bm.num_free_blocks - bm.num_cached_blocks,
            "blocks_cached": bm.num_cached_blocks,
            "state_block_equiv": self._state_blocks_in_use,
            "slots_active": sum(r is not None for r in self.slot_req),
            "max_slots": self.max_slots,
            "queue_len": len(self.queue),
            "kv_pressure": self.kv_pressure,
            "prefix_hit_blocks": self.stats["prefix_hits"],
            "spec_acceptance": (self.stats["accepted_tokens"] / drafted
                                if drafted else 0.0),
            "weight_version": self.weight_version,
            "host_blocks_live": bm.num_host_live,
            "host_blocks_cached": bm.num_host_cached,
            "host_bytes_in_use": bm.host_bytes_in_use,
            "demoted_blocks": bm.demoted_blocks + bm.cache_demotions,
            "promoted_blocks": bm.promoted_blocks,
            "host_transfer_bytes": (bm.demoted_blocks + bm.cache_demotions
                                    + bm.promoted_blocks) * bm.block_bytes,
        }

    @property
    def _needs_kv_calibration(self) -> bool:
        """True until the first prefill locks the pool's KV scales."""
        return (self.precision.kv_quantized
                and self.precision.calculate_kv_scales
                and not self._scales_calibrated
                and not self.cfg.attention_free)

    def _prefill_precision(self) -> PrecisionConfig:
        """Only the first forward after a (re)load calibrates the KV
        scales; later prefills reuse the pool's (vLLM semantics)."""
        if self._scales_calibrated and self.precision.kv_quantized:
            return self.precision.replace(calculate_kv_scales=False)
        return self.precision

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _reserve_blocks(self, req: Request) -> int:
        """Paged-KV blocks a request needs at admission time (its constant
        state footprint is priced separately, `state_blocks`)."""
        if self.cfg.attention_free:
            return 0
        retained = self.block_mgr.swapped_tokens(req.rid)
        if self.admission == "reserve":
            # worst case: full prompt + every token it may still generate
            tokens = max(len(req.prompt) + req.max_new, retained + 1)
        else:
            # what it holds now, +1 so the first decode write is mapped
            tokens = max(len(req.prompt) + 1, retained + 1)
        return self.block_mgr.blocks_for_tokens(tokens)

    # -- cache surgery ------------------------------------------------------
    def _set_table_row(self, slot: int, ids: List[int]):
        if not self.has_paged_kv:       # attention-free: no block tables
            return
        w = self.cache["block_tables"].shape[1]
        row = np.full((w,), -1, np.int32)
        row[:len(ids)] = ids[:w]
        self.cache["block_tables"][slot] = torch.from_numpy(row).to(self.device)

    def _clear_slot(self, slot: int):
        if self.has_paged_kv:
            self.cache["block_tables"][slot] = -1
        self._lengths[slot] = 0

    def _kv_slots(self):
        return [(name, sd["kv"]) for name, sd in self.cache["slots"].items() if "kv" in sd]

    def _ssm_slots(self):
        return [(name, sd["ssm"]) for name, sd in self.cache["slots"].items() if "ssm" in sd]

    def _cross_slots(self):
        return [(name, sd["cross"]) for name, sd in self.cache["slots"].items()
                if "cross" in sd]

    def _write_slot_state(self, slot: int, state: Optional[dict] = None):
        """The one writer of a slot's non-KV state rows (all R layers):
        `state`, a `_snapshot_slot_state` of the request that resumes
        here, or for a fresh occupant zero SSM rows (the previous
        occupant's h/conv would be its prefill's initial state; cross rows
        need no reset: the enc-dec prefill overwrites them and
        `src_lengths` masks their padding)."""
        if state is None:
            for _, st in self._ssm_slots():
                st.h[:, slot] = 0
                st.conv[:, slot] = 0
            return
        for name, st in self._ssm_slots():
            h, conv = state[name]["ssm"]
            st.h[:, slot] = h.to(self.device)
            st.conv[:, slot] = conv.to(self.device)
        for name, cr in self._cross_slots():
            k, v = state[name]["cross"]
            cr.k[:, slot] = k.to(self.device)
            cr.v[:, slot] = v.to(self.device)

    def _snapshot_slot_state(self, slot: int) -> dict:
        """Host copies of the slot's non-KV state rows over the R layers,
        {slot name: {"ssm": (h, conv)} and / or {"cross": (k, v)}} (empty
        without SSM or cross layers)."""
        state = {}
        for name, st in self._ssm_slots():
            state.setdefault(name, {})["ssm"] = (_to_host(st.h[:, slot]),
                                                 _to_host(st.conv[:, slot]))
        for name, cr in self._cross_slots():
            state.setdefault(name, {})["cross"] = (_to_host(cr.k[:, slot]),
                                                   _to_host(cr.v[:, slot]))
        return state

    def _slot_view(self, slot: int) -> dict:
        """Batch-1 cache view for a prefill into `slot`: the pools are
        shared (and written in place), the table row, the SSM rows, the
        cross rows and the source length are sliced (views, written in
        place too; the cross scales are the pool-wide ones)."""
        slots = {}
        for name, sd in self.cache["slots"].items():
            view = {"ssm": sd["ssm"].rows(slot, slot + 1)} if "ssm" in sd else {"kv": sd["kv"]}
            if "cross" in sd:
                cr = sd["cross"]
                view["cross"] = attn_mod.KVCache(cr.k[:, slot:slot + 1], cr.v[:, slot:slot + 1],
                                                 cr.k_scale, cr.v_scale)
            slots[name] = view
        view = {"slots": slots}
        if self.has_paged_kv:
            view["block_tables"] = self.cache["block_tables"][slot:slot + 1]
        if "src_lengths" in self.cache:
            view["src_lengths"] = self.cache["src_lengths"][slot:slot + 1]
        return view

    def _copy_block(self, src: int, dst: int):
        """Duplicate pool row `src` into `dst` in every attention layer
        (the device half of copy-on-write)."""
        for _, kv in self._kv_slots():
            attn_mod.paged_copy_rows(kv, [src], [dst])

    # -- execution mechanism -------------------------------------------------
    def execute(self, decision: ScheduleDecision):
        """Run one planned step: actions strictly in plan order, then the
        fused decode over `decode_slots`."""
        tracing = self.tracer.enabled
        if tracing:
            self.tracer.begin_step(self)
        self._executing = True
        try:
            self._execute(decision)
        finally:
            self._executing = False
        if tracing:
            self.tracer.end_step(self, decision)

    def _execute(self, decision: ScheduleDecision):
        tracing = self.tracer.enabled
        n_verify = 0
        for act in decision.actions:
            if isinstance(act, SwapOut):
                self._exec_swap_out(act)
                if tracing:
                    self.tracer.record_swap_out(self, act)
            elif isinstance(act, Admit):
                restored = self._exec_admit(act)
                if tracing:
                    self.tracer.record_admit(self, act, restored)
            elif isinstance(act, Grow):
                self._set_table_row(act.slot, act.block_ids)
                # a slot this same plan swaps out is already empty here (the
                # scheduler moved its request at plan time) and the swap-out
                # clears the row: a void growth, no event (the reference's
                # tracer raises on it)
                if tracing and self.slot_req[act.slot] is not None:
                    self.tracer.record_grow(self, act, self.slot_req[act.slot].rid)
            elif isinstance(act, Cow):
                self._copy_block(act.src, act.dst)
                self._set_table_row(act.slot, act.block_ids)
                if tracing:
                    self.tracer.record_cow(self, act, self.slot_req[act.slot].rid)
            elif isinstance(act, Prefill):
                self._exec_prefill(act)
                if tracing:
                    self.tracer.record_prefill(self, act)
            elif isinstance(act, Draft):
                self._exec_draft(act)
                if tracing:
                    self.tracer.record_draft(self, act)
            elif isinstance(act, Verify):
                accepted, committed = self._exec_verify(act)
                if tracing:
                    self.tracer.record_verify(self, act, accepted, committed)
                n_verify += 1
            else:
                raise TypeError(f"unknown action {act!r}")
        self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                        self.block_mgr.blocks_in_use)
        if decision.decode_slots:
            self._exec_decode(decision.decode_slots)
        elif n_verify:
            # a verify-only step is still one serving step
            self.stats["steps"] += 1
        if n_verify:
            self.stats["occupancy"] += n_verify / self.max_slots

    def step(self) -> ScheduleDecision:
        """One scheduler + engine step.  The crash seam fires first, then
        staged weights are installed, then the step is planned and run."""
        if self.faults.enabled:
            self.faults.on_step(self)        # may raise ReplicaCrash
        self._apply_staged_weights()
        decision = self.scheduler.step(self)
        if not decision.is_empty:
            self.execute(decision)
        return decision

    def _try_admit(self):
        """Admission-only pass: plan and run admissions plus their prefill
        work, nothing else."""
        self.execute(self.scheduler.step(self, admit_only=True))

    def _finish(self, req: Request, slot: int):
        self.done.append(req)
        self.slot_req[slot] = None
        self.block_mgr.free(req.rid)
        self._clear_slot(slot)
        if self.tracer.enabled:
            self.tracer.record_finish(self, req)

    def _sample(self, logits):
        """(tokens, logps or None) from `logits` with the engine's sampler."""
        return sample(logits, self.gen, self.temperature, self.top_k,
                      want_logp=self.want_logps)

    def _commit_first_token(self, req: Request, tok: int, logp, slot: int):
        """Record the token sampled off the final prefill logits; a
        max_new=1 request, or one whose first token is EOS, is done here.
        (The reference checks only max_new here, so a first token equal to
        EOS did not stop it: a request failed over with its streamed
        tokens as a forced prefix then ran past the EOS it would have
        stopped at without the failover.)"""
        req.generated = [tok]
        req.token_versions = [self.weight_version]
        req.token_logps = [float(logp)] if logp is not None else []
        if tok == self.eos_id or len(req.generated) >= req.max_new:
            self._finish(req, slot)

    # -- prefill -------------------------------------------------------------
    def _exec_admit(self, act: Admit) -> int:
        """Returns the restore traffic in tokens (the host->device half of
        the decision's `swap_tokens`, which the tracer's `AdmitEvent`
        carries): a swap-in's restored tokens, or a fresh admit's revived
        host-cached prefix blocks."""
        self._set_table_row(act.slot, act.block_ids)
        if act.swap_in:
            return self._swap_in(act.slot, act.req, act)
        if act.moves:       # host-cached prefix hits revived by copy-in
            self._promote_blocks(act.moves)
        self._write_slot_state(act.slot)    # a fresh occupant starts at zero
        self._lengths[act.slot] = act.req.prefilled
        return act.n_promoted * self.block_size

    def _exec_prefill(self, act: Prefill):
        if act.oneshot:
            self._prefill_into(act.slot, act.req)
            return
        req = act.req
        chunk = np.full((1, act.width), tasks.PAD, np.int32)
        n = act.end - act.start
        chunk[0, :n] = req.prompt[act.start:act.end]
        logits, _ = self.model.prefill_chunk(
            self.params, torch.from_numpy(chunk), [act.start], [n],
            self._slot_view(act.slot), self._prefill_precision(),
            use_kernel=self.kernels.prefill)
        self._lengths[act.slot] = act.end
        req.cached_tokens = act.end
        self._scales_calibrated = True
        self.stats["prefill_chunks"] += 1
        if act.last:
            self.block_mgr.register_prefix(req.rid, req.prompt)
            tok, logp = self._sample(logits[0])
            self.pending_tok[act.slot] = tok = int(tok)
            self._commit_first_token(req, tok, logp, act.slot)

    def _prefill_into(self, slot: int, req: Request):
        """One-shot prefill: the whole prompt through one `prompt_pad`-wide
        batch-1 trace.  Shared prefix blocks are re-written with the bytes
        they already hold (causal prefix KV is a function of the prefix
        tokens; the scales are locked after calibration)."""
        p = len(req.prompt)
        padded = np.full((1, self.prompt_pad), tasks.PAD, np.int32)
        padded[0, :p] = req.prompt
        self._set_table_row(slot, self.block_mgr.blocks_of(req.rid))
        inputs = {"tokens": torch.from_numpy(padded),
                  "lengths": torch.tensor([p], dtype=torch.int32)}
        if self.cfg.is_encdec:
            # the request's frames padded to the slot's capacity; src_lengths
            # masks the padding through the encoder and every cross read
            n = req.frames.shape[0]
            fr = np.zeros((1, self.src_pad, self.cfg.d_model), np.float32)
            fr[0, :n] = req.frames
            inputs["frames"] = torch.from_numpy(fr).to(torch.bfloat16)
            inputs["src_lengths"] = torch.tensor([n], dtype=torch.int32)
        logits, _ = self.model.prefill(self.params, inputs,
                                       self._slot_view(slot),
                                       self._prefill_precision())
        self._lengths[slot] = p
        self._scales_calibrated = True
        self.block_mgr.register_prefix(req.rid, req.prompt)
        tok, logp = self._sample(logits[0])
        self.pending_tok[slot] = tok = int(tok)
        self.slot_req[slot] = req
        req.cached_tokens = p
        self._commit_first_token(req, tok, logp, slot)

    # -- preemption / swap ---------------------------------------------------
    def _host_copy_out_block(self, dev: int, host: int):
        """The allocator's `demote_copy` hook: copy one device pool row (all
        layers) to host storage under `host` — the evictor's
        demote-before-drop of content written in an earlier step."""
        if self.faults.enabled:
            # may raise HostCopyError: the allocator then drops the entry
            self.faults.on_demote_copy(self)
        self.host_pool[host] = {name: (_to_host(kv.k[:, dev]), _to_host(kv.v[:, dev]))
                                for name, kv in self._kv_slots()}

    def _host_drop_block(self, host: int):
        """The allocator's `host_drop` hook.  A drop can come before the
        storage exists (a same-plan swap-out -> re-admit); flag those so
        the pending SwapOut skips writing them."""
        if host in self.host_pool:
            del self.host_pool[host]
        else:
            self._host_dead_on_arrival.add(host)

    def _promote_blocks(self, moves):
        """Execute ordered (host_id, device_id) promote pairs: write each
        host block's rows into its device pool row, then drop the host
        storage."""
        hids = [h for h, _ in moves]
        idx = torch.tensor([d for _, d in moves], device=self.device)
        for name, kv in self._kv_slots():
            kv.k[:, idx] = torch.stack(
                [self.host_pool[h][name][0] for h in hids], dim=1).to(self.device)
            kv.v[:, idx] = torch.stack(
                [self.host_pool[h][name][1] for h in hids], dim=1).to(self.device)
        for h in hids:
            self.host_pool.pop(h, None)
        self.stats["promoted_blocks"] += len(moves)

    def _exec_swap_out(self, act: SwapOut):
        """The device half of an allocator demote: copy the victim's valid
        blocks into their host-tier ids (the allocator already moved the
        request at plan time), and snapshot its pending token."""
        req = act.req
        moves = [(d, h) for d, h in act.moves
                 if h not in self._host_dead_on_arrival]
        self._host_dead_on_arrival.difference_update(h for _, h in act.moves)
        if moves:
            idx = torch.tensor([d for d, _ in moves], device=self.device)
            rows = {name: (_to_host(kv.k[:, idx]), _to_host(kv.v[:, idx]))
                    for name, kv in self._kv_slots()}
            for j, (_, h) in enumerate(moves):
                self.host_pool[h] = {name: (k[:, j], v[:, j])
                                     for name, (k, v) in rows.items()}
        # the SSM rows and the pending token are read here, at the action's
        # place in execute order (they are only current once an earlier
        # same-step swap-in ran)
        self._host_state[req.rid] = {
            "state": self._snapshot_slot_state(act.slot) or None,
            "pending": int(self.pending_tok[act.slot])
            if req.prefilled >= len(req.prompt) else 0}
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.stats["swap_outs"] += 1
        self.stats["demoted_blocks"] += len(act.moves)
        self._clear_slot(act.slot)

    def _swap_in(self, slot: int, req: Request, act: Admit) -> int:
        """The device half of an allocator promote: copy the host-tier tail
        back into fresh pool rows (no recompute), and the SSM and cross
        rows (and the source length) into this slot.  The leading
        `n_shared` entries came from a prefix hit and already hold the
        prompt's KV; only the restored tokens (plus `state_swap_tokens`
        for slot state) count as `wasted`.  Returns them."""
        if act.moves:
            self._promote_blocks(act.moves)
        hs = self._host_state.pop(req.rid, None) or {}
        state = hs.get("state")
        if state:
            self._write_slot_state(slot, state)
        if self.cfg.is_encdec:
            self.cache["src_lengths"][slot] = req.frames.shape[0]
        retained = act.retained
        s = min(act.n_shared, self.block_mgr.blocks_for_tokens(retained))
        restored = max(retained - s * self.block_size, 0)
        if state:
            restored += self.state_swap_tokens
        req.wasted_tokens += restored
        self.stats["wasted_tokens"] += restored
        self._lengths[slot] = retained
        self.pending_tok[slot] = hs.get("pending", 0)
        req.cached_tokens = retained
        self.stats["swap_ins"] += 1
        if req.prefilled >= len(req.prompt):
            self.block_mgr.register_prefix(req.rid, req.prompt)
        return restored

    # -- speculative decoding ------------------------------------------------
    def _exec_draft(self, act: Draft):
        """The ordered record of a proposal (the n-gram proposer ran at
        plan time)."""
        if self.slot_req[act.slot] is not act.req:
            raise RuntimeError("draft for a slot whose occupant changed")
        self.stats["draft_tokens"] += len(act.tokens)

    def _exec_verify(self, act: Verify):
        """Score [pending, d_1..d_k] at positions [T, T + k] in one chunk,
        rejection-sample, and rewind: lengths drop to T + 1 + accepted, and
        the stale rows past it are never read (length masks, live-block
        clamps) and are overwritten by the next write.  Returns (accepted
        drafts, committed tokens)."""
        req, slot = act.req, act.slot
        if self.slot_req[slot] is not req or req.cached_tokens != act.start:
            raise RuntimeError(f"verify out of step with slot {slot}")
        k = len(act.tokens)
        chunk = np.full((1, act.width), tasks.PAD, np.int32)
        chunk[0, 0] = self.pending_tok[slot]
        chunk[0, 1:1 + k] = act.tokens
        logits, _ = self.model.prefill_chunk(
            self.params, torch.from_numpy(chunk), [act.start], [k + 1],
            self._slot_view(slot), self._prefill_precision(),
            use_kernel=self.kernels.prefill, want_all_logits=True)
        toks, n_acc, tok_logps = rejection_sample(
            logits[0, :k + 1], act.tokens, self.gen, self.temperature,
            self.top_k)
        new_len = act.start + 1 + n_acc
        self._lengths[slot] = new_len
        req.cached_tokens = new_len
        self.stats["spec_steps"] += 1
        self.stats["accepted_tokens"] += n_acc
        committed = 0
        for j, tok in enumerate(toks):
            self.stats["emitted"] += 1
            committed += 1
            req.generated.append(tok)
            req.token_versions.append(self.weight_version)
            if self.want_logps:
                req.token_logps.append(float(tok_logps[j]))
            self.pending_tok[slot] = tok
            if tok == self.eos_id or len(req.generated) >= req.max_new:
                self._finish(req, slot)
                break
        return n_acc, committed

    # -- decode --------------------------------------------------------------
    def _exec_decode(self, decode_slots: List[int]):
        """One fused decode step over every slot's row.  Mid-prefill slots'
        table rows point at the trash row for its duration (the batch-wide
        KV write must not land in their real, possibly shared, blocks),
        and their SSM rows and lengths are restored after it (the fused
        recurrence advances every row)."""
        # a request finished by this step's final prefill chunk was freed
        decode_slots = [i for i in decode_slots
                        if self.slot_req[i] is not None]
        if not decode_slots:
            return
        if self.tracer.enabled:
            # contexts are priced pre-decode (cached rows + the row being
            # written)
            self.tracer.record_decode(
                self, decode_slots,
                [self.slot_req[i].rid for i in decode_slots],
                [self.slot_req[i].cached_tokens + 1 for i in decode_slots])
        masked = [i for i, r in enumerate(self.slot_req)
                  if r is not None and i not in decode_slots]
        tables = self.cache.get("block_tables")
        if masked:
            midx = torch.tensor(masked, device=self.device)
            saved_state = {name: (st.h[:, midx], st.conv[:, midx])
                           for name, st in self._ssm_slots()}
            if tables is not None:
                saved_rows = tables[midx]
                tables[midx] = -1
        saved_lengths = self._lengths.copy()
        self.cache["lengths"] = torch.from_numpy(
            self._lengths.astype(np.int32)).to(self.device)
        live = None if tables is None else attn_mod._live_blocks(
            self._lengths + 1, tables.shape[1], self.block_size)
        logits, self.cache = self.model.decode_step(
            self.params, torch.from_numpy(self.pending_tok), self.cache,
            self.precision, use_kernel=self.kernels.decode, live_blocks=live)
        # decode_step advanced every row; masked slots did not decode
        self._lengths += 1
        if masked:
            if tables is not None:
                tables[midx] = saved_rows
            for name, st in self._ssm_slots():
                st.h[:, midx], st.conv[:, midx] = saved_state[name]
            self._lengths[masked] = saved_lengths[masked]
        next_toks, next_logps = self._sample(logits)
        next_toks = next_toks.cpu().numpy()
        if next_logps is not None:
            next_logps = next_logps.cpu().numpy()
        self.stats["steps"] += 1
        self.stats["occupancy"] += len(decode_slots) / self.max_slots
        for i in decode_slots:
            req = self.slot_req[i]
            tok = int(next_toks[i])
            self.stats["emitted"] += 1
            req.generated.append(tok)
            req.token_versions.append(self.weight_version)
            if next_logps is not None:
                req.token_logps.append(float(next_logps[i]))
            req.cached_tokens += 1
            self.pending_tok[i] = tok
            if tok == self.eos_id or len(req.generated) >= req.max_new:
                self._finish(req, i)

    # -- main loop ---------------------------------------------------------
    def run(self, max_steps: int = 1000) -> ServeReport:
        # chunk-only steps don't count against max_steps (it bounds decode
        # steps); a generous guard catches capacity-stuck chunk loops
        guard = 16 * max_steps + 256
        stalled = False
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and self.stats["steps"] < max_steps and guard > 0:
            guard -= 1
            self._apply_staged_weights()
            decision = self.scheduler.step(self)
            if decision.is_empty:
                stalled = True       # work remains but nothing schedules
                break
            self.execute(decision)
        if guard <= 0 and (self.queue
                           or any(r is not None for r in self.slot_req)):
            stalled = True
        steps = max(self.stats["steps"], 1)
        return ServeReport(
            completed=self.done,
            steps=self.stats["steps"],
            preemptions=self.stats["preemptions"],
            wasted_tokens=self.stats["wasted_tokens"],
            emitted_tokens=self.stats["emitted"],
            mean_occupancy=self.stats["occupancy"] / steps,
            budget_tokens=self.budget_tokens,
            swap_outs=self.stats["swap_outs"],
            swap_ins=self.stats["swap_ins"],
            peak_blocks_in_use=self.stats["peak_blocks"],
            prefix_hit_blocks=self.stats["prefix_hits"],
            cow_copies=self.stats["cow_copies"],
            prefill_chunks=self.stats["prefill_chunks"],
            spec_steps=self.stats["spec_steps"],
            draft_tokens=self.stats["draft_tokens"],
            accepted_tokens=self.stats["accepted_tokens"],
            stalled=stalled,
            kv_pressure=self.kv_pressure,
            latency=(self.tracer.latency_summary()
                     if self.tracer.enabled else None),
            gauges=self.gauge_snapshot(),
        )
