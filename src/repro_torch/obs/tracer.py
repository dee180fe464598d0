"""Step tracers: the null default and the recording `StepTracer` (port of
`repro.obs.tracer`, unchanged: host-side records only, no device work).

The engine owns exactly one tracer.  The contract with the hot path is a
single branch: every instrumentation site in `ServingEngine` is guarded
by ``if self.tracer.enabled:`` — with the default `NULL_TRACER` that is
one attribute load + bool test per site and nothing else (no event
objects, no geometry lookups, no dict churn).  With a `StepTracer`
installed the engine calls the ``record_*`` hooks, which read the live
decision/engine state and append typed `obs.events` records.

`StepTracer` keeps the token-unit clock itself (advanced by each
executed decision's `cost_tokens`), so traces from manually-driven
loops (scheduler.step -> engine.execute) and `engine.run()`
agree — the clock is a property of *executed work*, not of any caller.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.obs import events as ev
from repro_torch.roofline.kv_bytes import (
    KVGeometry,
    decode_hbm_bytes,
    prefill_chunk_hbm_bytes,
    verify_hbm_bytes,
)


class NullTracer:
    """Disabled tracer: the default.  `enabled` is False and every hook
    is absent by design — engine sites must check `enabled` first, which
    keeps the disabled hot path at one branch per site."""

    __slots__ = ()
    enabled = False


NULL_TRACER = NullTracer()


class StepTracer:
    """Recording tracer for one engine (one replica).

    Collects typed events in memory (`events`), optionally streaming
    each to `sink` (any object with a ``write(dict)`` method, e.g.
    `obs.export.JsonlSink`).  Clock and step counters live here;
    geometry (`KVGeometry.from_engine`) and the roofline byte mode are
    resolved lazily on the first step so construction never touches the
    engine.

    Use `timelines()` / `latency_summary()` (delegating to
    `obs.timeline`) for the per-request view, `chrome_trace()` (via
    `obs.export`) for the Perfetto view.
    """

    enabled = True

    def __init__(self, replica: int = 0, sink=None,
                 mode: str = "paged-clamped"):
        self.replica = replica
        self.sink = sink
        self.mode = mode
        self.events: List[ev.Event] = []
        self.clock = 0.0
        self.step = 0                 # index of the step being executed
        self._geo: Optional[KVGeometry] = None
        self._staged_since: Optional[float] = None

    # -- plumbing ----------------------------------------------------------

    def emit(self, event: ev.Event) -> None:
        """Record one typed event (and stream it when a sink is set)."""
        self.events.append(event)
        if self.sink is not None:
            self.sink.write(event.to_dict())

    def geometry(self, eng) -> KVGeometry:
        if self._geo is None:
            self._geo = KVGeometry.from_engine(eng)
        return self._geo

    # -- step framing (called by ServingEngine.execute) --------------------

    def begin_step(self, eng) -> None:
        self.geometry(eng)

    def end_step(self, eng, decision) -> None:
        """Close the step: accounting record + gauges, advance clock."""
        self.emit(ev.StepEvent(
            step=self.step,
            clock_before=self.clock,
            cost_tokens=decision.cost_tokens,
            prefill_tokens=decision.prefill_tokens,
            verify_tokens=decision.verify_tokens,
            decode_tokens=len(decision.decode_slots),
            swap_tokens=decision.swap_tokens,
            version=eng.weight_version,
        ))
        self.clock += decision.cost_tokens
        self.record_gauges(eng)
        self.step += 1

    # -- lifecycle hooks ----------------------------------------------------

    def record_submit(self, eng, req) -> None:
        self.emit(ev.SubmitEvent(
            step=self.step, rid=req.rid, prompt_len=len(req.prompt),
            max_new=req.max_new, clock=self.clock,
            replica=self.replica))

    def record_admit(self, eng, act, restored_tokens: int) -> None:
        self.emit(ev.AdmitEvent(
            step=self.step, rid=act.req.rid, slot=act.slot,
            n_blocks=len(act.block_ids), n_shared=act.n_shared,
            swap_in=act.swap_in, restored_tokens=restored_tokens,
            n_promoted=act.n_promoted))

    def record_swap_out(self, eng, act) -> None:
        self.emit(ev.SwapOutEvent(
            step=self.step, rid=act.req.rid, slot=act.slot,
            n_blocks=len(act.block_ids), kv_tokens=act.tokens,
            tokens_moved=act.tokens + eng.state_swap_tokens,
            n_demoted=len(act.moves)))

    def record_grow(self, eng, act, rid: int) -> None:
        self.emit(ev.GrowEvent(
            step=self.step, rid=rid, slot=act.slot,
            n_blocks=len(act.block_ids)))

    def record_cow(self, eng, act, rid: int) -> None:
        geo = self.geometry(eng)
        self.emit(ev.CowEvent(
            step=self.step, rid=rid, slot=act.slot, src=act.src,
            dst=act.dst,
            hbm_bytes=ev.cow_copy_bytes(geo, eng.block_size)))

    def record_prefill(self, eng, act) -> None:
        geo = self.geometry(eng)
        self.emit(ev.PrefillEvent(
            step=self.step, rid=act.req.rid, slot=act.slot,
            start=act.start, end=act.end, cost_tokens=act.width,
            last=act.last, oneshot=act.oneshot,
            version=eng.weight_version,
            hbm_bytes=prefill_chunk_hbm_bytes(
                geo, act.start, act.end - act.start, act.end,
                mode=self.mode)))

    def record_draft(self, eng, act) -> None:
        self.emit(ev.DraftEvent(
            step=self.step, rid=act.req.rid, slot=act.slot,
            k=len(act.tokens)))

    def record_verify(self, eng, act, accepted: int, committed: int) -> None:
        geo = self.geometry(eng)
        self.emit(ev.VerifyEvent(
            step=self.step, rid=act.req.rid, slot=act.slot,
            start=act.start, k=len(act.tokens), cost_tokens=act.width,
            accepted=accepted, committed=committed,
            version=eng.weight_version,
            hbm_bytes=verify_hbm_bytes(
                geo, act.start, len(act.tokens), mode=self.mode)))

    def record_decode(self, eng, slots, rids, contexts) -> None:
        geo = self.geometry(eng)
        self.emit(ev.DecodeEvent(
            step=self.step, slots=list(slots), rids=list(rids),
            contexts=list(contexts), cost_tokens=len(slots),
            version=eng.weight_version,
            hbm_bytes=sum(decode_hbm_bytes(geo, c, mode=self.mode)
                          for c in contexts)))

    def record_finish(self, eng, req) -> None:
        self.emit(ev.FinishEvent(
            step=self.step, rid=req.rid, n_tokens=len(req.generated)))

    def record_weights(self, eng, version: int, staged: bool) -> None:
        if staged:
            self._staged_since = self.clock
        else:
            self._staged_since = None
        self.emit(ev.WeightsEvent(
            step=self.step, version=version, staged=staged,
            clock=self.clock))

    # -- fleet fault/recovery hooks (called by ServingFrontend) -------------
    # These carry explicit step/clock arguments: the FLEET owns its own
    # step index and token clock (max-over-replicas), which this
    # tracer's per-engine counters do not track.

    def record_replica_down(self, replica: int, *, step: int, clock: float,
                            transient: bool, reason: str) -> None:
        self.emit(ev.ReplicaDownEvent(
            step=step, replica=replica, clock=clock, transient=transient,
            reason=reason))

    def record_replica_up(self, replica: int, *, step: int, clock: float,
                          version: int) -> None:
        self.emit(ev.ReplicaUpEvent(
            step=step, replica=replica, clock=clock, version=version))

    def record_redispatch(self, rid: int, src: int, dst: int, *, step: int,
                          clock: float, replayed_tokens: int) -> None:
        self.emit(ev.RedispatchEvent(
            step=step, rid=rid, src_replica=src, dst_replica=dst,
            replayed_tokens=replayed_tokens, clock=clock))

    def record_push_retry(self, replica: int, *, step: int, clock: float,
                          version: int, attempt: int) -> None:
        self.emit(ev.PushRetryEvent(
            step=step, replica=replica, version=version, attempt=attempt,
            clock=clock))

    def record_quarantine(self, replica: int, *, step: int, clock: float,
                          version: int) -> None:
        self.emit(ev.QuarantineEvent(
            step=step, replica=replica, version=version, clock=clock))

    def record_abort(self, rid: int, replica: int, *, step: int,
                     clock: float, reason: str, n_tokens: int) -> None:
        self.emit(ev.AbortEvent(
            step=step, rid=rid, replica=replica, reason=reason,
            n_tokens=n_tokens, clock=clock))

    def record_fleet_gauges(self, *, step: int, clock: float,
                            **gauges) -> None:
        self.emit(ev.FleetGaugeEvent(step=step, clock=clock, **gauges))

    def record_gauges(self, eng) -> None:
        self.emit(ev.GaugeEvent(
            step=self.step,
            clock=self.clock,
            staged_pending=self._staged_since is not None,
            staged_age=(self.clock - self._staged_since
                        if self._staged_since is not None else 0.0),
            **eng.gauge_snapshot(),
        ))

    # -- views --------------------------------------------------------------

    def timelines(self):
        """Per-request `obs.timeline.RequestTimeline` map."""
        from repro_torch.obs.timeline import build_timelines
        return build_timelines(self.events)

    def latency_summary(self) -> dict:
        """p50/p95/p99 TTFT / TPOT / queue-wait over this trace."""
        from repro_torch.obs.timeline import build_timelines, summarize_timelines
        return summarize_timelines(build_timelines(self.events))

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing)."""
        from repro_torch.obs.export import chrome_trace
        return chrome_trace(self.events, replica=self.replica)
