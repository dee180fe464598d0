"""Continuous-batching scheduler: admission / eviction / growth *policy*
(port of `repro.serving.scheduler`, unchanged: host-side logic).

The paper's §2.3.2 argument is that rollout throughput is a scheduling
outcome: FP8 KV doubles block capacity, which raises concurrency and
removes preemptions — but once capacity stops binding, *admission latency*
(batch-1, fixed-width prefill) and *eviction waste* (evicting a heavy
sharer frees almost nothing) become the limits.  This module owns every
such decision; `ServingEngine` stays pure execution mechanism.  The run
loop is the vLLM split:

    decision = scheduler.step(engine)     # host-side policy + bookkeeping
    engine.execute(decision)              # device work, in plan order

Chunked prefill
    A prompt is no longer prefilled in one batch-1 trace of fixed width
    `prompt_pad`.  The scheduler slices it into `prefill_chunk`-token
    chunks and schedules one chunk per slot per step, bounded by
    `StepBudget.prefill_tokens`; the chunk trace
    (`models.prefill_chunk`) writes KV through the block table and
    reads earlier chunks back from the pool — through the CUDA
    `fp8_paged_prefill_attention` kernel when the engine's
    `kernel_config` enables it, a table gather otherwise; the planned
    `Prefill`/decode actions are mechanism-agnostic and the engine picks
    the path at execute time — so decode for other slots proceeds
    *between* chunks (piggybacked prefill) and a prompt of any length
    streams through one fixed-width trace.  When the prefix index
    already holds leading full blocks of the prompt, chunking starts at
    the shared boundary — shared prefix compute is skipped outright
    (attention-only models; recurrent state cannot be skipped).

Eviction policies (registry)
    `youngest`        evict the highest rid (the least sunk cost).
    `lru`             evict the slot least recently scheduled (chunk or
                      decode) — FIFO-ish here since fused decode touches
                      every active slot each step, but it separates
                      prefill-stalled requests from hot decoders.
    `private-blocks`  evict the slot whose eviction actually frees the
                      most blocks: count refcount-1 (private) blocks.
                      Under GRPO group sharing, evicting a heavy sharer
                      frees little — its prompt blocks stay resident for
                      the group — so victim choice by rid wastes swaps.

Speculative decoding (`spec=SpecConfig(...)`)
    A decode-ready slot can spend its step on Draft + Verify instead of
    one fused-decode token: the proposer guesses k tokens from the
    request's own history (`serving.spec_decode`), and the engine scores
    pending-token + drafts in ONE `prefill_chunk` trace, rejection-
    samples, and rewinds the KV length past the rejected tail.  The
    scheduler plans speculation *opportunistically*: verify widths count
    against `StepBudget.prefill_tokens` alongside prefill chunks, the
    verify write range is grown/privatized up front (ordered Grow/Cow
    before the Verify), and speculation never evicts anyone — when
    blocks or budget are tight the slot falls back to plain decode.  A
    victim preempted mid-plan has its Draft/Verify cancelled exactly
    like a planned chunk, so a swapped request resumes from its pending
    token bit-exact.

A `ScheduleDecision` is an *ordered* action log: the engine executes
actions in plan order, which makes plan-time bookkeeping (free a victim's
blocks, hand them to a growing request) consistent with execute-time
device copies (the victim's rows are copied to host before any action
ordered after the swap-out can overwrite them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.serving.block_manager import NoFreeBlocksError
from repro_torch.serving.spec_decode import NGramProposer, SpecConfig, \
    _check_proposer

# ---------------------------------------------------------------------------
# decision = ordered action log + decode set + cost accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepBudget:
    """Per-step scheduling budget.

    prefill_tokens : max padded prefill tokens traced per step (None =
                     unlimited).  At least one chunk is always scheduled
                     when prefill work is pending, so a small budget
                     throttles rather than deadlocks.  Speculative
                     verify widths draw from the SAME pool (both are
                     multi-token traces) — prefill chunks are planned
                     first, so speculation only spends the leftover.
    new_blocks     : max fresh block allocations *for admission* per step
                     (None = unlimited).  Growth/CoW of already-running
                     requests is never budget-blocked — the decode write
                     must land somewhere.
    """

    prefill_tokens: Optional[int] = None
    new_blocks: Optional[int] = None


@dataclasses.dataclass
class SwapOut:
    slot: int
    req: object                  # engine.Request
    block_ids: List[int]         # table snapshot (device copy source)
    tokens: int                  # valid KV rows to save
    # ordered (device_id, host_id) demote pairs from the allocator — the
    # engine executes these copies when it reaches the action
    moves: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Admit:
    slot: int
    req: object
    block_ids: List[int]
    swap_in: bool                # restore host KV instead of prefilling
    n_shared: int                # leading table entries from prefix hits
    # ordered (host_id, device_id) promote pairs (swap-in tail restore,
    # or host-cached prefix blocks revived by copy-in on a fresh admit)
    moves: List[tuple] = dataclasses.field(default_factory=list)
    retained: int = 0            # valid KV rows restored on swap-in
    n_promoted: int = 0          # host->device copy-in blocks


@dataclasses.dataclass
class Grow:
    slot: int
    block_ids: List[int]         # full table after growth


@dataclasses.dataclass
class Cow:
    slot: int
    src: int                     # physical row to copy
    dst: int
    block_ids: List[int]         # full table after the remap


@dataclasses.dataclass
class Prefill:
    slot: int
    req: object
    start: int                   # token range [start, end) of the prompt
    end: int
    width: int                   # padded trace width (cost accounting)
    last: bool                   # final chunk: sample the first token
    oneshot: bool                # legacy batch-1 full-prompt prefill


@dataclasses.dataclass
class Draft:
    """Propose draft tokens for a decode-ready slot.  The n-gram
    proposer is host-side, so `tokens` is already filled at plan time
    and execution only records stats — but the action stays first-class
    and ordered so a draft-*model* proposer (device work, pool reads)
    slots in here without touching the plan shape."""

    slot: int
    req: object
    tokens: List[int]            # proposed draft ids (len k >= 1)


@dataclasses.dataclass
class Verify:
    """Score pending-token + drafts through one `prefill_chunk` trace,
    rejection-sample, and rewind the KV length past the rejected tail
    (the KV-rewind contract documented in `serving.spec_decode`).
    Always ordered after the Grow/Cow that map and privatize its write
    range [start, start+len(tokens)]."""

    slot: int
    req: object
    tokens: List[int]            # draft ids (k of them)
    start: int                   # cached_tokens at plan time (row of the
    #                              pending token's KV write)
    width: int                   # padded trace width (cost accounting)


Action = object


@dataclasses.dataclass
class ScheduleDecision:
    """One step's plan.  `actions` execute strictly in order; the fused
    decode over `decode_slots` runs last.  Slots with a planned Verify
    never appear in `decode_slots` — the verify trace IS their step."""

    actions: List[Action] = dataclasses.field(default_factory=list)
    decode_slots: List[int] = dataclasses.field(default_factory=list)
    prefill_tokens: int = 0      # padded widths scheduled this step
    swap_tokens: int = 0         # KV rows moved host<->device this step
    verify_tokens: int = 0       # padded speculative verify widths

    @property
    def cost_tokens(self) -> int:
        """Engine-work cost proxy in token units: tokens traced this step
        (padded prefill widths + speculative verify widths + one per
        decode slot) plus KV rows moved over the host link by preemption
        (swap-out saves + swap-in restores).  The continuous-batching
        benchmark advances its arrival clock by this — which is what
        makes eviction waste visible: a policy that swaps sharers back
        and forth pays here.  Verify widths are priced at full padded
        width even when fewer drafts are accepted, so speculation has to
        EARN its win in accepted tokens, not hide cost."""
        return self.prefill_tokens + self.verify_tokens + \
            len(self.decode_slots) + self.swap_tokens

    def accounting(self) -> Dict[str, int]:
        """The decision's token costs as a flat dict — the ground truth
        the observability gate reconciles the event log against (every
        key matches the corresponding `obs.events.StepEvent` field)."""
        return {
            "prefill_tokens": self.prefill_tokens,
            "verify_tokens": self.verify_tokens,
            "decode_tokens": len(self.decode_slots),
            "swap_tokens": self.swap_tokens,
            "cost_tokens": self.cost_tokens,
        }

    @property
    def is_empty(self) -> bool:
        return not self.actions and not self.decode_slots


# ---------------------------------------------------------------------------
# eviction-policy registry
# ---------------------------------------------------------------------------

EVICTION_POLICIES: Dict[str, Callable] = {}


def eviction_policy(name: str):
    def deco(fn):
        EVICTION_POLICIES[name] = fn
        return fn
    return deco


@eviction_policy("youngest")
def _victim_youngest(eng, slots: List[int]) -> int:
    """Highest rid = least sunk cost (the pre-scheduler hard-coded rule)."""
    return max(slots, key=lambda i: eng.slot_req[i].rid)


@eviction_policy("lru")
def _victim_lru(eng, slots: List[int]) -> int:
    """Least recently scheduled slot; ties fall back to youngest."""
    return max(slots, key=lambda i: (-eng.slot_req[i].last_used,
                                     eng.slot_req[i].rid))


@eviction_policy("private-blocks")
def _victim_private_blocks(eng, slots: List[int]) -> int:
    """Most refcount-1 blocks = most pool actually reclaimed.  Evicting a
    heavy sharer frees nothing the group still reads; ties fall back to
    youngest.  (Every victim additionally frees its `state_blocks` of
    constant slot state — a uniform offset within one model, so it
    cancels in the comparison but is priced in the budget accounting.)"""
    def private(i):
        mgr = eng.block_mgr
        return sum(1 for b in mgr.blocks_of(eng.slot_req[i].rid)
                   if mgr.refcount(b) == 1)
    return max(slots, key=lambda i: (private(i), eng.slot_req[i].rid))


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


class Scheduler:
    """Owns admission, chunked-prefill pacing, growth, CoW planning and
    victim selection over a `ServingEngine`'s host-visible state
    (queue / slot_req / block_mgr / cache lengths).  Produces a
    `ScheduleDecision`; never touches device arrays itself."""

    def __init__(self, *, eviction: str = "youngest",
                 prefill_chunk: Optional[int] = None,
                 budget: Optional[StepBudget] = None,
                 spec: Optional[SpecConfig] = None,
                 proposer=None):
        assert eviction in EVICTION_POLICIES, (
            f"unknown eviction policy {eviction!r}; "
            f"registered: {sorted(EVICTION_POLICIES)}")
        self.eviction = eviction
        self.prefill_chunk = prefill_chunk   # None = legacy batch-1 prefill
        self.budget = budget or StepBudget()
        self.spec = spec                     # None = speculation off
        if proposer is None and spec is not None:
            proposer = NGramProposer(spec)
        if proposer is not None:
            _check_proposer(proposer)
        self.proposer = proposer
        self._tick = 0

    # -- victim selection ---------------------------------------------------
    def _select_victim(self, eng, exclude=()) -> Optional[int]:
        slots = [i for i, r in enumerate(eng.slot_req)
                 if r is not None and i not in exclude]
        if not slots:
            return None
        return EVICTION_POLICIES[self.eviction](eng, slots)

    def _plan_swap_out(self, eng, decision: ScheduleDecision, slot: int,
                       planned: Dict[int, Prefill],
                       spec_planned: Optional[Dict[int, Verify]] = None):
        """Preempt `slot` at plan time: bookkeeping now (free + requeue),
        device copy when the engine reaches the action.  A chunk already
        planned for the victim this step is cancelled and rolled back —
        its writes must never land in blocks that were just handed to
        someone else.  A planned Draft/Verify is cancelled the same way:
        the victim keeps its pending token and resumes with a plain
        decode (or a fresh speculation) bit-exact after swap-in."""
        req = eng.slot_req[slot]
        chunk = planned.pop(slot, None)
        if chunk is not None:
            decision.actions.remove(chunk)
            decision.prefill_tokens -= chunk.width
            req.prefilled = chunk.start
        if spec_planned is not None:
            verify = spec_planned.pop(slot, None)
            if verify is not None:
                decision.actions = [
                    a for a in decision.actions
                    if not (isinstance(a, (Draft, Verify))
                            and a.slot == slot)]
                decision.verify_tokens -= verify.width
        # Demote only the blocks that hold valid rows: a speculating slot
        # can own blocks past `cached_tokens` (grown for a verify that
        # was then rewound or cancelled), and re-admission only reserves
        # blocks for the tokens actually retained — an untrimmed host
        # copy would not fit the restore target (and is pure swap waste).
        # `cached_tokens` is the host-authoritative count of valid KV rows
        # (kept in lockstep by engine.execute); for a slot admitted earlier
        # THIS step it already covers exactly the rows whose content is
        # valid at the swap-out action's place in the execution order.
        # Non-KV slot state (SSM h/conv, cross KV) moves over the host
        # link too — priced in block-equivalent token units alongside the
        # KV rows, so evicting a hybrid/enc-dec slot is never free.
        #
        # The demote IS the claim: the allocator marks the request
        # swapped NOW (a re-admission later in this same plan must see it
        # as swapped, not fresh — `_reserve_blocks` and the swap_in test
        # read `block_mgr.is_swapped`), its table becomes host ids, and
        # the freed device blocks are immediately reusable.  Only the
        # device COPIES wait for the action's place in execute order —
        # the victim's rows must reach host before any later-ordered
        # action can overwrite them.  The pending token and slot state
        # are snapshotted at execute time too: `pending_tok[slot]` can be
        # stale at plan time when this victim was itself swap-admitted
        # earlier in the same plan, but is always current at execute
        # time, and execute-time snapshotting also undoes `_swap_in`
        # consuming the host state when that same-plan Admit ran first.
        moves = eng.block_mgr.demote(req.rid, req.cached_tokens)
        decision.actions.append(SwapOut(
            slot, req, [d for d, _ in moves], req.cached_tokens,
            moves=moves))
        decision.swap_tokens += req.cached_tokens + eng.state_swap_tokens
        eng.slot_req[slot] = None
        eng.queue.insert(0, req)

    # -- admission ----------------------------------------------------------
    def _plan_admissions(self, eng, decision: ScheduleDecision,
                         fresh_blocks: List[int]):
        while eng.queue:
            slot = eng._free_slot()
            if slot is None:
                return
            req = eng.queue[0]
            swap_in = eng.block_mgr.is_swapped(req.rid)
            hits = eng.block_mgr.lookup_prefix(req.prompt)
            # A hit is usable only where its tier fits the admission
            # shape.  Host-tier hits need a copy-in, which only the
            # chunked skip path can exploit on a FRESH admission (legacy
            # one-shot prefill rewrites every prompt block anyway, and a
            # swap-in restore dedups against device content only — its
            # own host copy already covers those rows).  Either
            # restriction keeps the run a prefix: truncate at the first
            # unusable tier, never filter mid-run.
            if swap_in or not (self.prefill_chunk is not None
                               and eng._chunk_skip_ok):
                shared = []
                for b in hits:
                    if eng.block_mgr.tier(b) != "device":
                        break
                    shared.append(b)
            else:
                shared = hits
            need = max(eng._reserve_blocks(req) - len(shared), 0)
            # evictor-cached hits are revived (refcount 0 -> 1): they leave
            # the reclaimable pool exactly like a fresh allocation would,
            # so they count against the per-step block throttle the same
            # way — a GRPO burst whose prefixes all sit in the evictor
            # cache must still admit gradually, not all at once.  Host-
            # cached hits consume a fresh device block each (the copy-in
            # target), so they count identically.
            revive = sum(1 for b in shared
                         if eng.block_mgr.tier(b) == "device"
                         and eng.block_mgr.refcount(b) == 0)
            promote = sum(1 for b in shared
                          if eng.block_mgr.tier(b) == "host")
            # the request's constant slot state (SSM h/conv, cross KV)
            # counts against the byte budget like `state_blocks` more
            # fresh blocks — an enc-dec/hybrid model must not over-admit
            # on its per-token KV cost alone
            if self.budget.new_blocks is not None and \
                    fresh_blocks[0] + need + revive + promote + \
                    eng.state_blocks > \
                    self.budget.new_blocks and fresh_blocks[0] > 0:
                return              # block budget spent: admit next step
            if not eng.block_mgr.can_allocate(
                    need + revive + promote,
                    limit_blocks=eng._effective_blocks - eng.state_blocks):
                return              # capacity-bound: stay queued
            eng.queue.pop(0)
            fresh_blocks[0] += need + revive + promote + eng.state_blocks
            limit = eng._effective_blocks - eng.state_blocks
            if shared:
                eng.stats["prefix_hits"] += len(shared)
            moves: List[tuple] = []
            n_promoted = 0
            retained = 0
            if not swap_in:
                if shared:
                    # cross-tier acquire: device hits refcount up, host-
                    # cached hits are promoted (copy-in) and the prefix
                    # index re-points to their new device rows
                    _, moves, n_promoted = eng.block_mgr.promote_hits(
                        req.rid, shared, limit_blocks=limit)
                eng.block_mgr.allocate(req.rid, need, limit_blocks=limit)
                # fresh request: skip straight past the shared full-block
                # prefix (its KV is in the pool — or arriving from host
                # via the Admit's ordered copy-ins, which the engine
                # executes before this request's first chunk) — but only
                # where prefix KV is the *whole* carried state (pure
                # attention), and always leave >= 1 token so the last
                # chunk has logits
                p = len(req.prompt)
                skip = min(len(shared) * eng.block_size, p - 1) \
                    if (self.prefill_chunk is not None
                        and eng._chunk_skip_ok) else 0
                req.prefilled = skip
                req.cached_tokens = skip
                # revival is not free: the promoted blocks cross the host
                # link exactly like a swap-in restore, and the honest
                # charge is what lets `accounting()` and the tiered-kv
                # benchmark compare revival against recompute
                decision.swap_tokens += n_promoted * eng.block_size
            else:
                retained = eng.block_mgr.swapped_tokens(req.rid)
                moves, n_promoted = eng.block_mgr.promote(
                    req.rid, shared_ids=shared, limit_blocks=limit)
                eng.block_mgr.allocate(
                    req.rid, need - n_promoted, limit_blocks=limit)
                req.cached_tokens = retained
                # restore traffic: rows beyond the re-deduped shared head,
                # plus the slot state coming back from host
                s = min(len(shared),
                        eng.block_mgr.blocks_for_tokens(retained))
                decision.swap_tokens += max(
                    retained - s * eng.block_size, 0) + \
                    eng.state_swap_tokens
            ids = eng.block_mgr.blocks_of(req.rid)
            req.last_used = self._tick
            eng.slot_req[slot] = req
            if self.prefill_chunk is None:
                # legacy one-shot prefill: register the prompt's blocks at
                # PLAN time so a same-step same-prompt admission (the GRPO
                # burst shape) dedups against them.  Safe because a legacy
                # sharer recomputes its whole prompt and only *rewrites*
                # shared blocks (bit-identically) — it never reads pool
                # content that hasn't been written yet.  The chunked path
                # registers at execute time instead: its chunk attention
                # gathers earlier KV back from the pool, so a prefix must
                # be fully materialized before it becomes discoverable.
                eng.block_mgr.register_prefix(req.rid, req.prompt)
            decision.actions.append(
                Admit(slot, req, ids, swap_in, len(shared),
                      moves=moves, retained=retained,
                      n_promoted=n_promoted))

    # -- chunked prefill ----------------------------------------------------
    def _plan_prefills(self, eng, decision: ScheduleDecision,
                       planned: Dict[int, Prefill]):
        cap = self.budget.prefill_tokens
        calib_planned = False
        for slot, req in enumerate(eng.slot_req):
            if req is None or slot in planned:
                continue
            p = len(req.prompt)
            if req.prefilled >= p:
                continue
            if self.prefill_chunk is None:
                start, end, width, oneshot = 0, p, eng.prompt_pad, True
            elif req.prefilled == 0 and not calib_planned and \
                    eng._needs_kv_calibration:
                # KV-scale calibration: the first quantized prefill's amax
                # window must cover the WHOLE first prompt (and match the
                # one-shot window exactly for prompts both modes serve) —
                # per-chunk windows would lock scales from the first
                # chunk's amax alone, and a running amax across chunks
                # cannot help because earlier chunks' pool bytes are
                # already quantized at the provisional scale.  So the
                # calibrating prefill runs as ONE full-width chunk; later-
                # ordered chunks this step execute with scales locked.
                start, end, oneshot = 0, p, False
                width = max(eng.prompt_pad,
                            -(-p // self.prefill_chunk) * self.prefill_chunk)
                calib_planned = True
            else:
                start = req.prefilled
                end = min(start + self.prefill_chunk, p)
                width, oneshot = self.prefill_chunk, False
            if cap is not None and \
                    decision.prefill_tokens + width > cap and \
                    decision.prefill_tokens > 0:
                break               # budget spent; progress guaranteed above
            chunk = Prefill(slot, req, start, end, width, last=(end == p),
                            oneshot=oneshot)
            decision.actions.append(chunk)
            decision.prefill_tokens += width
            planned[slot] = chunk
            req.prefilled = end
            req.last_used = self._tick

    # -- speculative decoding ----------------------------------------------
    def _plan_spec(self, eng, decision: ScheduleDecision,
                   planned: Dict[int, Prefill],
                   spec_planned: Dict[int, Verify]):
        """Plan Draft + Verify for decode-ready slots (opportunistic).

        Per slot, in ordered-action terms: Grow maps the verify write
        range [T, T+k] (reserve mode already covers it), Cow privatizes
        every shared block the range touches, then Draft and Verify are
        appended — so the engine's in-order execution writes the verify
        chunk only into mapped, private blocks.  Speculation never
        preempts: if blocks or the prefill-token budget are unavailable,
        the slot simply takes a plain decode step instead (no Draft/
        Verify planned), which guarantees speculation composes with —
        and can only add to — the non-speculative schedule.
        """
        if self.spec is None or not getattr(eng, "_spec_ok", False):
            return
        cap = self.budget.prefill_tokens
        width = self.spec.num_draft_tokens + 1
        for slot in self._decode_ready(eng):
            req = eng.slot_req[slot]
            if req is None or slot in planned:
                continue             # prompt finishes only this step
            # emitted <= k+1 per verify; clamp so the request can never
            # exceed max_new (and KV rows stay within its reservation)
            k_cap = min(self.spec.num_draft_tokens,
                        req.max_new - len(req.generated) - 1)
            if k_cap <= 0:
                continue
            if cap is not None and decision.prefill_tokens + \
                    decision.verify_tokens + width > cap:
                continue             # budget spent: plain decode this step
            draft = [int(t) for t in self.proposer.propose(req, k_cap)]
            draft = draft[:k_cap]
            if not draft:
                continue             # nothing to guess: plain decode
            tokens_after = req.cached_tokens + len(draft) + 1
            need = eng.block_mgr.blocks_for_tokens(tokens_after) - \
                len(eng.block_mgr.blocks_of(req.rid))
            if need > 0:
                if not eng.block_mgr.can_allocate(
                        need, limit_blocks=eng._effective_blocks):
                    continue         # tight pool: never evict to speculate
                eng.block_mgr.allocate(
                    req.rid, need, limit_blocks=eng._effective_blocks)
                decision.actions.append(
                    Grow(slot, eng.block_mgr.blocks_of(req.rid)))
            if not self._cow_range(eng, decision, slot, req,
                                   req.cached_tokens,
                                   req.cached_tokens + len(draft)):
                continue             # no room to privatize: plain decode
            decision.actions.append(Draft(slot, req, draft))
            verify = Verify(slot, req, draft, req.cached_tokens, width)
            decision.actions.append(verify)
            decision.verify_tokens += width
            spec_planned[slot] = verify
            req.last_used = self._tick

    # -- growth / copy-on-write --------------------------------------------
    def _decode_ready(self, eng) -> List[int]:
        return [i for i, r in enumerate(eng.slot_req)
                if r is not None and r.prefilled >= len(r.prompt)]

    def _plan_growth(self, eng, decision: ScheduleDecision,
                     planned: Dict[int, Prefill],
                     spec_planned: Dict[int, Verify]):
        """ondemand mode: every decode-ready slot needs the next token's KV
        row mapped; allocate on block boundaries, evicting by policy when
        the pool is exhausted.  Speculating slots were already grown to
        their full verify range by `_plan_spec`."""
        if eng.cfg.attention_free:
            return                  # no per-token KV rows to map
        for slot in sorted(self._decode_ready(eng),
                           key=lambda i: eng.slot_req[i].rid):
            req = eng.slot_req[slot]
            if req is None or slot in spec_planned:
                continue
            while eng.slot_req[slot] is req:
                length = max(req.cached_tokens, req.prefilled)
                need = eng.block_mgr.blocks_for_tokens(length + 1) - \
                    len(eng.block_mgr.blocks_of(req.rid))
                if need <= 0:
                    break
                if eng.block_mgr.can_allocate(
                        need, limit_blocks=eng._effective_blocks):
                    eng.block_mgr.allocate(
                        req.rid, need, limit_blocks=eng._effective_blocks)
                    decision.actions.append(
                        Grow(slot, eng.block_mgr.blocks_of(req.rid)))
                    break
                victim = self._select_victim(eng, exclude=(slot,))
                if victim is None:
                    raise RuntimeError(
                        "KV pool smaller than a single request; raise "
                        "kv_budget_bytes or block_size")
                self._plan_swap_out(eng, decision, victim, planned,
                                    spec_planned)

    def _cow_range(self, eng, decision: ScheduleDecision, slot: int, req,
                   lo_tok: int, hi_tok: int) -> bool:
        """Privatize every shared block rows [lo_tok, hi_tok] land in,
        WITHOUT evicting (used by `_plan_spec`).  Returns False when the
        pool can't supply a copy target; already-planned Cows stay (a
        privatized block is correct either way — plain decode reaches it
        a few steps later)."""
        for j in range(lo_tok // eng.block_size,
                       hi_tok // eng.block_size + 1):
            ids = eng.block_mgr.blocks_of(req.rid)
            if j >= len(ids) or not eng.block_mgr.is_shared(ids[j]):
                continue
            try:
                res = eng.block_mgr.cow(
                    req.rid, j, limit_blocks=eng._effective_blocks)
            except NoFreeBlocksError:
                return False
            if res is not None:
                old, new = res
                decision.actions.append(
                    Cow(slot, old, new, eng.block_mgr.blocks_of(req.rid)))
                eng.stats["cow_copies"] += 1
        return True

    def _plan_cow(self, eng, decision: ScheduleDecision,
                  planned: Dict[int, Prefill],
                  spec_planned: Dict[int, Verify]):
        """Privatize any shared block the next decode write would land in
        (the scatter would corrupt every other holder).  Speculating
        slots already privatized their whole verify write range in
        `_plan_spec` (ordered before their Verify)."""
        for slot in self._decode_ready(eng):
            req = eng.slot_req[slot]
            if req is None or slot in spec_planned:
                continue             # evicted by an earlier slot's CoW
            ids = eng.block_mgr.blocks_of(req.rid)
            j = max(req.cached_tokens, req.prefilled) // eng.block_size
            if j >= len(ids) or not eng.block_mgr.is_shared(ids[j]):
                continue
            while True:
                try:
                    res = eng.block_mgr.cow(
                        req.rid, j, limit_blocks=eng._effective_blocks)
                    break
                except NoFreeBlocksError:
                    victim = self._select_victim(eng, exclude=(slot,))
                    if victim is None:
                        raise
                    self._plan_swap_out(eng, decision, victim, planned,
                                        spec_planned)
            if res is None:          # an eviction above dropped the refcount
                continue
            old, new = res
            decision.actions.append(
                Cow(slot, old, new, eng.block_mgr.blocks_of(req.rid)))
            eng.stats["cow_copies"] += 1

    # -- one step -----------------------------------------------------------
    def step(self, eng, *, admit_only: bool = False) -> ScheduleDecision:
        """Plan one engine step.  Order mirrors the pre-scheduler loop:
        budget preemption, admission, prefill chunks, then speculation
        planning, (ondemand) growth + a second admission pass, CoW, and
        the decode set (decode-ready slots minus speculating ones)."""
        self._tick += 1
        decision = ScheduleDecision()
        planned: Dict[int, Prefill] = {}
        spec_planned: Dict[int, Verify] = {}
        fresh_blocks = [0]

        # over the (possibly shrunk) budget: evict by policy until legal
        while eng.block_mgr.blocks_in_use > eng._effective_blocks:
            victim = self._select_victim(eng)
            if victim is None:
                break
            self._plan_swap_out(eng, decision, victim, planned, spec_planned)

        self._plan_admissions(eng, decision, fresh_blocks)
        self._plan_prefills(eng, decision, planned)
        if admit_only:
            return decision

        self._plan_spec(eng, decision, planned, spec_planned)
        if eng.admission == "ondemand":
            self._plan_growth(eng, decision, planned, spec_planned)
            self._plan_admissions(eng, decision, fresh_blocks)
            self._plan_prefills(eng, decision, planned)
        self._plan_cow(eng, decision, planned, spec_planned)

        decision.decode_slots = [i for i in self._decode_ready(eng)
                                 if i not in spec_planned]
        for i in decision.decode_slots:
            eng.slot_req[i].last_used = self._tick
        return decision
