"""Typed step-trace events, the observability schema of the serving stack
(port of `repro.obs.events`, unchanged: plain dataclasses).

One dataclass per executed `ScheduleDecision` action (Admit / SwapOut /
Grow / Cow / Prefill / Draft / Verify) plus the fused Decode, the
per-step accounting record (`StepEvent`), pool/fleet gauges
(`GaugeEvent`), and the request/weight lifecycle markers (`SubmitEvent`,
`FinishEvent`, `WeightsEvent`).  Every field is JSON-native, so an event
round-trips through the JSONL sink losslessly: `event.to_dict()` ->
`json.dumps` -> `json.loads` -> `event_from_dict` reconstructs an equal
instance (the schema contract `tests/test_torch_obs.py` pins).

Clock convention: the trace lives in the scheduler's *token-unit clock*
— one unit per token traced or moved
(`ScheduleDecision.cost_tokens`).  Events emitted while a step executes
carry that step's index; the step's end-of-step clock is derived from
the `StepEvent` stream (`obs.timeline`), because all of a step's work
completes together (the fused trace retires at once, so its tokens
share one arrival time).

Byte convention: `hbm_bytes` fields are *modeled* HBM traffic from
`roofline/kv_bytes` evaluated at the engine's own `KVGeometry`: the
analytic model as a live per-step counter.  Token costs (`tokens_moved`, widths, decode slot counts) come
from the decision's accounting, so per-step event sums reconcile
exactly with `ScheduleDecision.cost_tokens`
(`tests/test_torch_obs.py` and `chip_smoke.py` phase 9 assert this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Type


@dataclasses.dataclass(frozen=True)
class Event:
    """Base record: `step` is the engine step (execute() call) the event
    belongs to; between-step events (submit / weights) carry the index
    of the NEXT step and their own `clock` snapshot."""

    step: int

    kind = "event"              # overridden per subclass

    def to_dict(self) -> dict:
        """JSON-native dict with the event `kind` tag (the JSONL row)."""
        d = {"kind": self.kind}
        d.update(dataclasses.asdict(self))
        return d


@dataclasses.dataclass(frozen=True)
class SubmitEvent(Event):
    """A request entered the engine queue (queue-wait clock starts)."""

    rid: int
    prompt_len: int
    max_new: int
    clock: float                # token-unit clock at submission
    replica: int = 0

    kind = "submit"


@dataclasses.dataclass(frozen=True)
class AdmitEvent(Event):
    """An executed `Admit`: the request took a slot.  For a swap-in
    re-admission `restored_tokens` is the host-link restore traffic the
    decision charged (KV tail past the re-deduped prefix + slot-state
    block-equivalents); 0 for a fresh admission."""

    rid: int
    slot: int
    n_blocks: int               # table entries granted at admission
    n_shared: int               # leading entries from prefix-index hits
    swap_in: bool
    restored_tokens: int = 0
    # host->device copy-in blocks this admission executed: the swap-in
    # tail restore, or (fresh admit) host-cached prefix blocks revived
    # by copy-in instead of recompute
    n_promoted: int = 0

    kind = "admit"


@dataclasses.dataclass(frozen=True)
class SwapOutEvent(Event):
    """An executed `SwapOut` (preemption): `tokens_moved` is exactly what
    the decision charged — valid KV rows saved plus the slot-state
    block-equivalent tokens."""

    rid: int
    slot: int
    n_blocks: int               # host-copied pool blocks
    kv_tokens: int              # valid KV rows saved
    tokens_moved: int           # kv_tokens + state swap tokens
    n_demoted: int = 0          # device->host blocks (= n_blocks today)

    kind = "swap_out"


@dataclasses.dataclass(frozen=True)
class GrowEvent(Event):
    """An executed `Grow`: the slot's block table was extended."""

    rid: int
    slot: int
    n_blocks: int               # table size after growth

    kind = "grow"


@dataclasses.dataclass(frozen=True)
class CowEvent(Event):
    """An executed `Cow`: one shared block privatized before a write.
    `hbm_bytes` models the block copy (read + write at payload width)."""

    rid: int
    slot: int
    src: int
    dst: int
    hbm_bytes: int

    kind = "cow"


@dataclasses.dataclass(frozen=True)
class PrefillEvent(Event):
    """An executed `Prefill` trace (chunk or legacy one-shot).
    `cost_tokens` is the padded width the decision charged; `hbm_bytes`
    models the pool context read (`prefill_chunk_hbm_bytes`)."""

    rid: int
    slot: int
    start: int
    end: int
    cost_tokens: int            # padded trace width
    last: bool                  # final chunk: sampled the first token
    oneshot: bool
    version: int                # weight version live at the trace
    hbm_bytes: int

    kind = "prefill"


@dataclasses.dataclass(frozen=True)
class DraftEvent(Event):
    """An executed `Draft`: k tokens proposed for a speculating slot."""

    rid: int
    slot: int
    k: int

    kind = "draft"


@dataclasses.dataclass(frozen=True)
class VerifyEvent(Event):
    """An executed `Verify` trace.  `cost_tokens` is the padded verify
    width the decision charged (full width even when drafts are
    rejected); `committed` counts tokens actually appended to the
    request (accepted + corrected/bonus, truncated at EOS/max_new)."""

    rid: int
    slot: int
    start: int                  # cached_tokens at plan time
    k: int                      # drafts scored
    cost_tokens: int            # padded trace width
    accepted: int
    committed: int
    version: int
    hbm_bytes: int              # verify_hbm_bytes at (start, k)

    kind = "verify"


@dataclasses.dataclass(frozen=True)
class DecodeEvent(Event):
    """The fused decode over this step's decode set.  One token per slot;
    `contexts[i]` is slot `slots[i]`'s reachable context (cached rows +
    the row being written), the argument `decode_hbm_bytes` is priced
    at — so `hbm_bytes` is the sum of `decode_hbm_bytes` over them."""

    slots: List[int]
    rids: List[int]
    contexts: List[int]
    cost_tokens: int            # == len(slots)
    version: int
    hbm_bytes: int

    kind = "decode"


@dataclasses.dataclass(frozen=True)
class FinishEvent(Event):
    """A request completed (EOS or max_new) during this step."""

    rid: int
    n_tokens: int               # total generated tokens

    kind = "finish"


@dataclasses.dataclass(frozen=True)
class WeightsEvent(Event):
    """A weight hot-swap: `staged=True` for `stage_weights` (queued for
    the next step boundary), False for the actual install."""

    version: int
    staged: bool
    clock: float

    kind = "weights"


@dataclasses.dataclass(frozen=True)
class StepEvent(Event):
    """End-of-step accounting: the executed decision's token costs and
    the clock. `clock` is the END-of-step clock (clock_before +
    cost_tokens) — the arrival time of every token the step emitted."""

    clock_before: float
    cost_tokens: int
    prefill_tokens: int
    verify_tokens: int
    decode_tokens: int
    swap_tokens: int
    version: int

    kind = "step"

    @property
    def clock(self) -> float:
        return self.clock_before + self.cost_tokens


@dataclasses.dataclass(frozen=True)
class GaugeEvent(Event):
    """End-of-step pool/fleet gauges (sampled, not cumulative, except
    where noted)."""

    clock: float
    blocks_in_use: int          # allocated pool blocks (cached excluded)
    blocks_free: int            # truly free (evictor-cached excluded)
    blocks_cached: int          # evictor cache (reclaimable, index live)
    state_block_equiv: int      # slot-state block-equivalents pinned
    slots_active: int
    max_slots: int
    queue_len: int
    kv_pressure: float          # (blocks_in_use + state) / budget blocks
    prefix_hit_blocks: int      # cumulative stat
    spec_acceptance: float      # cumulative accepted / drafted
    staged_pending: bool        # stage_weights awaiting its boundary
    staged_age: float           # clock units the staged push has waited
    weight_version: int
    # host KV tier (two-tier allocator): occupancy split and cumulative
    # cross-tier traffic — additive defaults keep pre-tier logs loadable
    host_blocks_live: int = 0   # swapped-out requests' host blocks
    host_blocks_cached: int = 0  # demoted (refcount-0, index-live) blocks
    host_bytes_in_use: int = 0
    demoted_blocks: int = 0     # cumulative device->host moves
    promoted_blocks: int = 0    # cumulative host->device moves
    host_transfer_bytes: int = 0  # cumulative both directions

    kind = "gauge"


@dataclasses.dataclass(frozen=True)
class ReplicaDownEvent(Event):
    """A replica left the healthy set: it crashed (`reason="crash"`) or
    was quarantined after a weight push it could not take
    (`reason="quarantine"`).  `step` is the FLEET step index; `clock`
    the fleet token-unit clock."""

    replica: int
    clock: float
    transient: bool             # a rejoin is scheduled
    reason: str                 # "crash" | "quarantine"

    kind = "replica_down"


@dataclasses.dataclass(frozen=True)
class ReplicaUpEvent(Event):
    """A restarted replica rejoined the healthy set — only after
    installing the current fleet weight `version` (the catch-up
    contract: a rejoiner can never serve stale weights)."""

    replica: int
    clock: float
    version: int

    kind = "replica_up"


@dataclasses.dataclass(frozen=True)
class RedispatchEvent(Event):
    """One request failed over from `src_replica` to `dst_replica`.
    `replayed_tokens` is the exactly-once replay cost: tokens already
    streamed to the client, re-prefilled on the survivor as a forced
    prefix and never re-emitted.  Summing it over the event stream must
    reconcile exactly with the fleet's redispatch gauges
    (`tests/test_torch_obs.py` asserts this)."""

    rid: int
    src_replica: int
    dst_replica: int
    replayed_tokens: int
    clock: float

    kind = "redispatch"


@dataclasses.dataclass(frozen=True)
class PushRetryEvent(Event):
    """One failed install attempt during an atomic weight push (the
    replica raised; the front-end will retry up to its bounded budget,
    then quarantine)."""

    replica: int
    version: int
    attempt: int                # 1-based failed attempt index
    clock: float

    kind = "push_retry"


@dataclasses.dataclass(frozen=True)
class QuarantineEvent(Event):
    """A replica exhausted its install retries for weight `version` and
    was quarantined: marked unhealthy, its work re-dispatched — the
    healthy fleet is never version-split."""

    replica: int
    version: int
    clock: float

    kind = "quarantine"


@dataclasses.dataclass(frozen=True)
class AbortEvent(Event):
    """The front-end aborted a request (`FINISH_ABORT`): the fleet
    stalled with it in flight, its deadline passed on the fleet clock,
    or no healthy replica remained.  `n_tokens` is what had been
    streamed before the abort — delivered exactly once, then closed."""

    rid: int
    replica: int
    reason: str                 # "stall" | "deadline" | "no_replicas"
    n_tokens: int
    clock: float

    kind = "abort"


@dataclasses.dataclass(frozen=True)
class FleetGaugeEvent(Event):
    """End-of-fleet-step health gauges (cumulative where noted)."""

    clock: float
    healthy_replicas: int
    total_replicas: int
    redispatches: int           # cumulative failovers
    replayed_tokens: int        # cumulative forced-prefix replay cost
    aborted: int                # cumulative FINISH_ABORT finals
    push_retries: int           # cumulative failed install attempts
    quarantined: int            # replicas currently quarantined

    kind = "fleet_gauge"


_REGISTRY: Dict[str, Type[Event]] = {
    cls.kind: cls
    for cls in (SubmitEvent, AdmitEvent, SwapOutEvent, GrowEvent, CowEvent,
                PrefillEvent, DraftEvent, VerifyEvent, DecodeEvent,
                FinishEvent, WeightsEvent, StepEvent, GaugeEvent,
                ReplicaDownEvent, ReplicaUpEvent, RedispatchEvent,
                PushRetryEvent, QuarantineEvent, AbortEvent,
                FleetGaugeEvent)
}

EVENT_KINDS = tuple(sorted(_REGISTRY))


def event_from_dict(d: dict) -> Event:
    """Inverse of `Event.to_dict` — reconstruct the typed event from a
    parsed JSONL row.  Unknown kinds raise (schema drift must be loud).
    A top-level ``replica`` key is the multi-replica log envelope
    (merged fleet logs stamp it on every row) and is dropped for kinds
    whose schema doesn't carry it; ``run_id`` is the cross-sink join
    envelope (JsonlSink stamps it when the run was launched with one)
    and is dropped the same way."""
    d = dict(d)
    kind = d.pop("kind", None)
    if kind not in _REGISTRY:
        raise ValueError(f"unknown event kind {kind!r}; "
                         f"schema knows {EVENT_KINDS}")
    cls = _REGISTRY[kind]
    fields = {f.name for f in dataclasses.fields(cls)}
    for envelope in ("replica", "run_id"):
        if envelope in d and envelope not in fields:
            d.pop(envelope)
    return cls(**d)


def cow_copy_bytes(geo, block_size: int) -> int:
    """Modeled bytes one CoW block copy moves: one block read + one block
    write at KV payload width, across attention layers (`roofline`'s
    byte conventions applied to `paged_copy_rows`)."""
    return 2 * block_size * geo.token_payload_bytes * geo.n_attn_layers
