"""Async serving fleet: a streaming front-end over N engine replicas (port
of `repro.serving.frontend`: host logic, copied; an enc-dec request's
`frames` go with it to its replica and with its replay on failover).

`ServingFrontend` owns a list of data-parallel `ServingEngine` replicas
(same architecture, same precision, independent KV pools) and presents
one vLLM-style surface:

* `submit()` dispatches each request to the least-loaded healthy replica
  (load ties break on KV-pool pressure, then round-robin), returns the
  rid;
* `step()` advances every healthy replica one scheduler step and yields
  incremental `RequestOutput`s (new tokens + per-token weight versions
  + finish reasons) for every request that moved;
* `update_weights()` hot-swaps a new FP8 weight version into every
  replica **between** scheduler steps — in-flight requests keep running
  and their subsequent tokens are stamped with the new version.

The fleet clock is token-denominated: each front-end step costs the
*max* over replicas of that replica's `ScheduleDecision.cost_tokens`
(replicas run in parallel, so the step takes as long as its slowest
member).  This is the single engine's cost model, so a fleet's clock
compares with one engine's.

Fault tolerance (`serving.faults` is the injection seam; the chaos gate
is `chip_smoke.py` phase 9 on the card):

* **Health-tracked replicas.**  Each replica is healthy, down (crashed;
  transient crashes rejoin after their outage window), or quarantined
  (failed a weight push permanently).  Dispatch, stepping and
  `has_work()` all exclude unhealthy replicas — the fleet degrades
  gracefully to N-1.

* **Failover with exactly-once token delivery.**  A crash fires at a
  step boundary before any state mutates, so everything the replica had
  streamed is already delivered.  Its queued + in-flight requests are
  re-dispatched to survivors: tokens already streamed to the client are
  replayed as a *forced prefix* (the survivor re-prefills
  ``original_prompt + streamed_tokens`` and continues with the
  remaining budget) — they are never re-emitted, and they keep the
  version/logp stamps they were delivered with.  Under greedy decoding
  the continuation is bit-exact vs the fault-free fleet whenever the
  replayed prefix was generated under the current weight version
  (prefill-vs-decode logit equivalence is the spec-decode contract);
  a prefix spanning retired versions is the same honest policy mixture
  a live hot-swap creates, corrected by versioned TIS.  NOTE: the
  forced-prefix prompt is longer than the original, so failover of
  requests with streamed tokens needs chunked prefill (or prompt_pad
  headroom) on the survivors.

* **Atomic weight pushes.**  `update_weights` installs on every healthy
  replica with bounded retry (`install_retries`); `stage_weights`
  commits at each replica's next step boundary with the same retry
  budget.  A replica that cannot take the push is quarantined — marked
  unhealthy, its work re-dispatched — so the healthy fleet is never
  version-split.  A rejoining replica installs the current fleet
  weights before it serves anything (the catch-up contract).

* **No silent loss.**  A request in flight when `run()` stalls, whose
  `deadline_tokens` passes on the fleet clock, or that has no healthy
  replica left to fail over to, gets a final `RequestOutput` with
  `FINISH_ABORT` (carrying everything already streamed) and its blocks
  are freed.

Recovery is observable: pass ``tracer=`` a `StepTracer` and the fleet
emits `ReplicaDown/ReplicaUp/Redispatch/PushRetry/Quarantine/Abort`
events plus per-step `FleetGauge` health gauges through the same JSONL
and Chrome-trace exporters the engine events use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.timeline import build_timelines, summarize_timelines
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import ReplicaCrash, WeightInstallError
from repro_torch.serving.outputs import (
    FINISH_ABORT,
    FINISH_LENGTH,
    FINISH_STOP,
    CompletionOutput,
    RequestOutput,
)

HEALTHY = "healthy"
DOWN = "down"
QUARANTINED = "quarantined"


@dataclasses.dataclass
class _Tracked:
    """Front-end bookkeeping for one request.  The streamed_* lists are
    the client-side exactly-once record: every token ever delivered,
    with the version/logp stamps it was delivered with.  After a
    failover `req` points at the survivor's fresh engine Request (whose
    prompt embeds the replayed prefix), so cumulative outputs are built
    from this record, never by re-reading engine state."""

    replica: int
    req: Request
    prompt: np.ndarray             # ORIGINAL prompt (failover replays keep it)
    max_new: int                   # original budget
    frames: Optional[np.ndarray] = None
    deadline_clock: Optional[int] = None   # fleet clock bound (submit+deadline)
    reported: int = 0          # engine-side generated tokens already streamed
    finished: bool = False
    finish_reason: Optional[str] = None
    redispatches: int = 0
    streamed_tokens: List[int] = dataclasses.field(default_factory=list)
    streamed_versions: List[int] = dataclasses.field(default_factory=list)
    streamed_logps: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FleetReport:
    """What `run()` hands back: fleet-level accounting plus the final
    cumulative output per request (insertion order)."""

    outputs: List[RequestOutput]
    steps: int                 # front-end steps taken
    clock_tokens: int          # token-unit wall clock (max-over-replicas)
    emitted_tokens: int
    weight_version: int        # latest version pushed to the fleet
    stalled: bool
    replica_stats: List[dict]  # per-replica engine stat snapshots
    # per-replica KV-pool pressure at the end of the run (bytes in use /
    # budget, as block fractions) — the dispatch tie-break signal
    kv_pressure: List[float] = dataclasses.field(default_factory=list)
    # per-replica end-of-run gauge snapshots (ServingEngine.gauge_snapshot)
    replica_gauges: List[dict] = dataclasses.field(default_factory=list)
    # fleet-wide latency summary (token-unit clock) pooled over replicas,
    # plus per-replica breakdowns — only when replicas run with tracers
    latency: Optional[dict] = None
    replica_latency: Optional[List[dict]] = None
    # fault-tolerance gauges: end-of-run health + cumulative recovery
    # counters (all zero on a fault-free run)
    healthy_replicas: int = 0
    quarantined_replicas: int = 0
    redispatches: int = 0      # failovers executed
    replayed_tokens: int = 0   # forced-prefix replay cost (exactly-once)
    aborted: int = 0           # FINISH_ABORT finals emitted
    push_retries: int = 0      # failed install attempts absorbed by retry
    # tokens delivered to clients exactly once (sum of streamed records;
    # differs from emitted_tokens by the work a crash sacrificed)
    delivered_tokens: int = 0

    @property
    def tokens_per_clock(self) -> float:
        """Fleet throughput in the token-unit clock: emitted tokens per
        unit of modeled step time.  With perfect scaling, doubling the
        replicas doubles this on the same trace."""
        return self.emitted_tokens / max(self.clock_tokens, 1)


class ServingFrontend:
    # Weight of kv_pressure (a [0, ~1] fraction) against load (a request
    # count) in the dispatch score.  Below 1.0, pressure can never
    # reorder replicas whose loads differ by a whole request — it
    # resolves fractional standing between count-tied replicas (the old
    # tie-break, now as one continuous score) — while any pressure GAP
    # bigger than 1/pressure_weight of a request does shift dispatch
    # away from a replica near its byte budget.
    pressure_weight = 0.5

    def __init__(self, engines: List[ServingEngine], *, tracer=None,
                 install_retries: int = 2):
        if not engines:
            raise ValueError("ServingFrontend needs at least one engine")
        eos = {e.eos_id for e in engines}
        if len(eos) != 1:
            raise ValueError(f"replicas disagree on eos_id: {sorted(eos, key=repr)}")
        versions = {e.weight_version for e in engines}
        if len(versions) != 1:
            raise ValueError(
                f"replicas disagree on weight version: {sorted(versions)} "
                "— build the fleet from one synced checkpoint")
        self.engines = engines
        for i, eng in enumerate(engines):
            eng.replica_index = i      # keys the fault injector's schedules
        self.eos_id = engines[0].eos_id
        self.weight_version = engines[0].weight_version
        # fleet event stream (replica_down/redispatch/... + health
        # gauges); NULL_TRACER keeps the fault-free path at one branch
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # bounded install retry budget per replica per push; exhausted
        # retries quarantine the replica instead of splitting the fleet
        self.install_retries = install_retries
        self.health: List[str] = [HEALTHY] * len(engines)
        # fleet step at which a transiently-down replica attempts
        # rejoin; None = permanent (or not down)
        self._down_until: List[Optional[int]] = [None] * len(engines)
        # the fleet's current weights — what a rejoining replica must
        # install before serving (the catch-up contract)
        self._fleet_params = engines[0].params
        self._tracked: Dict[int, _Tracked] = {}
        self._pending_finals: List[RequestOutput] = []
        self._rr = 0               # round-robin cursor for load ties
        self._next_rid = 0
        self.steps = 0
        self.clock_tokens = 0
        self.redispatches = 0
        self.replayed_tokens = 0
        self.aborted = 0
        self.push_retries = 0

    # -- health -------------------------------------------------------------
    @property
    def healthy_replicas(self) -> int:
        return sum(h == HEALTHY for h in self.health)

    def _healthy_idx(self) -> List[int]:
        return [i for i, h in enumerate(self.health) if h == HEALTHY]

    # -- dispatch -----------------------------------------------------------
    def _load(self, eng: ServingEngine) -> int:
        """Replica load = queued requests + occupied slots.  KV is
        replica-local, so a request only moves replicas through the
        failover replay path (re-prefilled, never migrated in place)."""
        return len(eng.queue) + sum(r is not None for r in eng.slot_req)

    def _choose_replica(self) -> Optional[int]:
        """Least-loaded healthy replica under the weighted load/pressure
        score: queue+slot count plus the KV-pool pressure fraction
        scaled by `pressure_weight`.  A replica near its byte budget
        sheds load even at equal request count (pressure breaks count
        ties continuously), and a large enough pressure gap outweighs a
        small count deficit — e.g. a replica whose budget just shrank
        stops soaking up dispatch before its queue visibly backs up.
        Exact score ties fall back to round-robin so equal replicas
        share the stream instead of replica 0 soaking it up.  Returns
        None when no replica is healthy."""
        healthy = self._healthy_idx()
        if not healthy:
            return None
        n = len(self.engines)
        scores = {i: self._load(self.engines[i])
                  + self.pressure_weight * self.engines[i].kv_pressure
                  for i in healthy}
        best = min(scores.values())
        tied = [i for i in healthy if scores[i] <= best]
        for k in range(n):
            i = (self._rr + k) % n
            if i in tied:
                break
        self._rr = (i + 1) % n
        return i

    def submit(self, prompt_ids, max_new: int, rid: Optional[int] = None,
               frames=None, deadline_tokens: Optional[int] = None) -> int:
        """Dispatch one request; returns the rid.  `deadline_tokens`
        bounds its lifetime on the FLEET clock: if it has not finished
        by ``clock_at_submit + deadline_tokens``, it is aborted with a
        final `FINISH_ABORT` output and its blocks are freed."""
        if rid is None:
            rid = self._next_rid
        if rid in self._tracked:
            raise ValueError(f"duplicate rid {rid}")
        self._next_rid = max(self._next_rid, rid + 1)
        i = self._choose_replica()
        if i is None:
            raise RuntimeError(
                "no healthy replica to dispatch to — the whole fleet is "
                "down or quarantined")
        prompt = np.asarray(prompt_ids, np.int32)
        self.engines[i].submit(prompt, max_new, rid=rid, frames=frames)
        self._tracked[rid] = _Tracked(
            replica=i, req=self.engines[i].queue[-1], prompt=prompt,
            max_new=max_new, frames=frames,
            deadline_clock=(self.clock_tokens + deadline_tokens
                            if deadline_tokens is not None else None))
        return rid

    # -- weight hot-swap ----------------------------------------------------
    def _check_version(self, params, version):
        if version is None:
            params, version = params.params, params.version
        if version < self.weight_version:
            raise ValueError(
                f"weight version must be monotonic: got {version}, "
                f"fleet is at {self.weight_version}")
        return params, version

    def _note_push_failure(self, i: int, version: int, attempt: int):
        self.push_retries += 1
        if self.tracer.enabled:
            self.tracer.record_push_retry(
                i, step=self.steps, clock=float(self.clock_tokens),
                version=version, attempt=attempt)

    def _install_with_retry(self, i: int, params, version: int, *,
                            already_failed: int = 0) -> bool:
        """Install on replica `i`, retrying up to the bounded budget
        (`install_retries` extra attempts beyond the first).
        `already_failed` accounts failures observed before this call —
        a staged install that failed at the step boundary burned one
        attempt already."""
        eng = self.engines[i]
        for j in range(1 + self.install_retries - already_failed):
            try:
                eng.install_weights(params, version)
                return True
            except WeightInstallError:
                self._note_push_failure(i, version, already_failed + j + 1)
        return False

    def _quarantine(self, i: int, version: int):
        """Replica `i` exhausted its install retries: mark it
        unhealthy, free its requests' blocks, and re-dispatch them.
        The healthy fleet is never version-split — a replica either
        takes the push or leaves the healthy set."""
        self.health[i] = QUARANTINED
        if self.tracer.enabled:
            clock = float(self.clock_tokens)
            self.tracer.record_quarantine(
                i, step=self.steps, clock=clock, version=version)
            self.tracer.record_replica_down(
                i, step=self.steps, clock=clock, transient=False,
                reason="quarantine")
        eng = self.engines[i]
        for rid in self._victims(i):
            eng.cancel(rid)        # still a live engine: free its blocks
            self._failover(rid, src=i)

    def update_weights(self, params, version: Optional[int] = None):
        """Atomically install a new weight version on the healthy fleet.

        Accepts either `(params_pytree, version)` or a single
        `rl.weight_sync.VersionedWeights`-shaped object (anything with
        `.params` and `.version`).  The front-end only runs between
        engine steps, so each install is immediate (`install_weights`);
        in-flight requests are NOT drained — their next token simply
        comes from the new weights and is stamped with the new version.
        A transient install failure is retried up to `install_retries`
        times; a replica that cannot take the push is quarantined (its
        work re-dispatched), so every replica still healthy afterwards
        runs exactly `version`.
        """
        params, version = self._check_version(params, version)
        for i in self._healthy_idx():
            if not self._install_with_retry(i, params, version):
                self._quarantine(i, version)
        self.weight_version = version
        self._fleet_params = params

    def stage_weights(self, params, version: Optional[int] = None):
        """Stage a new weight version on every healthy replica for
        install at each replica's next `step()` boundary (the deferred
        spelling of `update_weights` — the trainer can push mid-flight
        and every replica picks the push up exactly when it is safe
        to).  Tokens sampled before a replica's boundary keep the old
        version stamp; tokens after carry the new one — version
        attribution stays exact per token either way.  An install that
        fails at the boundary gets the same bounded retry + quarantine
        treatment as `update_weights` (handled in `step()`)."""
        params, version = self._check_version(params, version)
        for i in self._healthy_idx():
            self.engines[i].stage_weights(params, version)
        self.weight_version = version
        self._fleet_params = params

    # -- failure handling ---------------------------------------------------
    def _victims(self, i: int) -> List[int]:
        """Unfinished tracked rids living on replica `i`, in rid order."""
        return [rid for rid in sorted(self._tracked)
                if self._tracked[rid].replica == i
                and not self._tracked[rid].finished]

    def _on_crash(self, i: int, exc: ReplicaCrash):
        """Replica `i` crashed fail-stop at a step boundary: mark it
        down (transient crashes schedule a rejoin on the fleet step
        clock) and fail its work over to the survivors.  The crashed
        engine's device state is garbage from here — it is never
        stepped or cancelled against, only cold-reset at rejoin."""
        self.health[i] = DOWN
        self._down_until[i] = (self.steps + exc.down_steps
                               if exc.transient else None)
        if self.tracer.enabled:
            self.tracer.record_replica_down(
                i, step=self.steps, clock=float(self.clock_tokens),
                transient=exc.transient, reason="crash")
        for rid in self._victims(i):
            self._failover(rid, src=i)

    def _failover(self, rid: int, src: int):
        """Re-dispatch one request to a healthy survivor with
        exactly-once delivery: the survivor is submitted
        ``original_prompt + streamed_tokens`` (the forced prefix — its
        total footprint equals the original prompt+max_new, so the
        max_seq_len admission check is unchanged) with the remaining
        token budget.  Streamed tokens are re-prefilled, never
        re-emitted, and keep their original version/logp stamps.  With
        no healthy survivor the request is aborted instead — a final
        FINISH_ABORT output, never silence."""
        t = self._tracked[rid]
        dst = self._choose_replica()
        if dst is None:
            self._pending_finals.append(self._abort(rid, "no_replicas"))
            return
        streamed = t.streamed_tokens
        remaining = t.max_new - len(streamed)
        assert remaining > 0, (
            f"rid {rid} had exhausted its budget without finishing")
        prompt = (np.concatenate(
            [t.prompt, np.asarray(streamed, np.int32)])
            if streamed else t.prompt)
        eng = self.engines[dst]
        eng.submit(prompt, remaining, rid=rid, frames=t.frames)
        t.req = eng.queue[-1]
        t.replica = dst
        t.reported = 0
        t.redispatches += 1
        self.redispatches += 1
        self.replayed_tokens += len(streamed)
        if self.tracer.enabled:
            self.tracer.record_redispatch(
                rid, src, dst, step=self.steps,
                clock=float(self.clock_tokens),
                replayed_tokens=len(streamed))

    def _maybe_rejoin(self):
        """Restart transiently-down replicas whose outage window ended:
        cold-reset, install the current fleet weights, and only then
        return them to the healthy set.  A rejoin whose weight install
        fails keeps the replica down and retries next step."""
        for i, eng in enumerate(self.engines):
            if self.health[i] != DOWN or self._down_until[i] is None:
                continue
            if self.steps < self._down_until[i]:
                continue
            try:
                eng.reset_for_rejoin(self._fleet_params, self.weight_version)
            except WeightInstallError:
                self._note_push_failure(i, self.weight_version, 1)
                self._down_until[i] = self.steps + 1
                continue
            self.health[i] = HEALTHY
            self._down_until[i] = None
            if self.tracer.enabled:
                self.tracer.record_replica_up(
                    i, step=self.steps, clock=float(self.clock_tokens),
                    version=self.weight_version)

    def _abort(self, rid: int, reason: str) -> RequestOutput:
        """Close a request with FINISH_ABORT: its final output carries
        everything already streamed (delivered exactly once — nothing
        re-emitted, nothing vanishes) and its blocks are freed on
        whichever healthy replica still holds it."""
        t = self._tracked[rid]
        if self.health[t.replica] == HEALTHY:
            self.engines[t.replica].cancel(rid)
        comp = CompletionOutput(
            token_ids=list(t.streamed_tokens),
            versions=list(t.streamed_versions),
            logps=list(t.streamed_logps) if t.streamed_logps else None,
            finish_reason=FINISH_ABORT)
        out = RequestOutput(
            rid=rid, replica=t.replica,
            prompt_token_ids=[int(x) for x in t.prompt],
            new_token_ids=[], new_versions=[], new_logps=None,
            output=comp, finished=True)
        t.finished = True
        t.finish_reason = FINISH_ABORT
        self.aborted += 1
        if self.tracer.enabled:
            self.tracer.record_abort(
                rid, t.replica, step=self.steps,
                clock=float(self.clock_tokens), reason=reason,
                n_tokens=len(t.streamed_tokens))
        return out

    def _enforce_deadlines(self) -> List[RequestOutput]:
        """Abort unfinished requests whose fleet-clock deadline passed.
        Runs after the step's drain, so tokens earned in the crossing
        step are still delivered before the abort closes the stream."""
        outs = []
        for rid in sorted(self._tracked):
            t = self._tracked[rid]
            if t.finished or t.deadline_clock is None:
                continue
            if self.clock_tokens >= t.deadline_clock:
                outs.append(self._abort(rid, "deadline"))
        return outs

    # -- stepping -----------------------------------------------------------
    def has_work(self) -> bool:
        return any(eng.queue or any(r is not None for r in eng.slot_req)
                   for i, eng in enumerate(self.engines)
                   if self.health[i] == HEALTHY)

    def _step_replica(self, i: int):
        """Advance replica `i` one step, absorbing its failure modes:
        a crash fails its work over; a staged weight push that fails at
        the boundary is retried (bounded) and the step re-entered, or
        the replica is quarantined.  Returns the executed decision, or
        None when the replica left the healthy set."""
        eng = self.engines[i]
        try:
            return eng.step()
        except ReplicaCrash as e:
            self._on_crash(i, e)
            return None
        except WeightInstallError:
            # the staged install burned one attempt at the boundary
            self._note_push_failure(i, self.weight_version, 1)
            if self._install_with_retry(i, self._fleet_params,
                                        self.weight_version,
                                        already_failed=1):
                try:
                    return eng.step()
                except ReplicaCrash as e:
                    self._on_crash(i, e)
                    return None
            self._quarantine(i, self.weight_version)
            return None

    def step(self) -> List[RequestOutput]:
        """Advance every healthy replica one scheduler step; return the
        incremental outputs (one per request that gained tokens or
        finished this step, plus any aborts), in rid order."""
        self._maybe_rejoin()
        step_cost = 0
        for i, eng in enumerate(self.engines):
            if self.health[i] != HEALTHY:
                continue
            if not (eng.queue or any(r is not None for r in eng.slot_req)):
                continue
            decision = self._step_replica(i)
            if decision is not None:
                step_cost = max(step_cost, decision.cost_tokens)
        self.steps += 1
        self.clock_tokens += step_cost
        outs = self._drain_outputs()
        if self._pending_finals:       # aborts raised inside failover
            outs.extend(self._pending_finals)
            self._pending_finals = []
        outs.extend(self._enforce_deadlines())
        if self.tracer.enabled:
            self._record_fleet_gauges()
        return outs

    def _finish_reason(self, t: _Tracked) -> str:
        if t.streamed_tokens and t.streamed_tokens[-1] == self.eos_id:
            return FINISH_STOP
        return FINISH_LENGTH

    def _drain_outputs(self) -> List[RequestOutput]:
        done_rids = [set(r.rid for r in eng.done) for eng in self.engines]
        outs: List[RequestOutput] = []
        for rid in sorted(self._tracked):
            t = self._tracked[rid]
            if t.finished:
                continue
            req = t.req
            have = len(req.generated)
            finished = rid in done_rids[t.replica]
            if have == t.reported and not finished:
                continue
            new_toks = list(req.generated[t.reported:])
            new_vers = list(req.token_versions[t.reported:])
            new_lps = (list(req.token_logps[t.reported:])
                       if req.token_logps else None)
            # exactly-once ledger: extend the client-side record, then
            # build the cumulative view from it (after a failover the
            # engine Request only holds the post-replay suffix)
            t.streamed_tokens.extend(new_toks)
            t.streamed_versions.extend(new_vers)
            if new_lps:
                t.streamed_logps.extend(new_lps)
            reason = self._finish_reason(t) if finished else None
            comp = CompletionOutput(
                token_ids=list(t.streamed_tokens),
                versions=list(t.streamed_versions),
                logps=(list(t.streamed_logps)
                       if t.streamed_logps else None),
                finish_reason=reason,
            )
            outs.append(RequestOutput(
                rid=rid,
                replica=t.replica,
                prompt_token_ids=[int(x) for x in t.prompt],
                new_token_ids=new_toks,
                new_versions=new_vers,
                new_logps=new_lps,
                output=comp,
                finished=finished,
            ))
            t.reported = have
            t.finished = finished
            t.finish_reason = reason
        return outs

    def _final_output(self, rid: int, t: _Tracked) -> RequestOutput:
        """Cumulative (zero-delta) RequestOutput for a finished request."""
        comp = CompletionOutput(
            token_ids=list(t.streamed_tokens),
            versions=list(t.streamed_versions),
            logps=list(t.streamed_logps) if t.streamed_logps else None,
            finish_reason=t.finish_reason or self._finish_reason(t),
        )
        return RequestOutput(
            rid=rid, replica=t.replica,
            prompt_token_ids=[int(x) for x in t.prompt],
            new_token_ids=[], new_versions=[], new_logps=None,
            output=comp, finished=True)

    def forget_finished(self) -> int:
        """Drop every finished request from the front end's books and
        each engine's `done` list; returns how many were dropped.  For a
        long-lived fleet (the trainer's), called once `run()` has handed
        back their final outputs, so the books (and the next report's
        `outputs`) stay bounded by one rollout's requests.  Automatic
        rids keep counting, so they stay fleet-unique."""
        gone = [rid for rid, t in self._tracked.items() if t.finished]
        for rid in gone:
            del self._tracked[rid]
        for eng in self.engines:
            eng.done[:] = [r for r in eng.done if r.rid in self._tracked]
        return len(gone)

    def _record_fleet_gauges(self):
        self.tracer.record_fleet_gauges(
            step=self.steps, clock=float(self.clock_tokens),
            healthy_replicas=self.healthy_replicas,
            total_replicas=len(self.engines),
            redispatches=self.redispatches,
            replayed_tokens=self.replayed_tokens,
            aborted=self.aborted,
            push_retries=self.push_retries,
            quarantined=sum(h == QUARANTINED for h in self.health))

    def run(self, max_steps: int = 1000) -> FleetReport:
        """Drive the fleet to completion (or stall), collecting the final
        cumulative output of every submitted request.  On a stall every
        request still in flight is aborted (FINISH_ABORT, blocks freed)
        — a stalled report accounts for every rid, none vanish."""
        finals: Dict[int, RequestOutput] = {}
        stalled = False
        steps_left = max_steps
        while self.has_work() and steps_left > 0:
            steps_left -= 1
            before = self.clock_tokens
            for out in self.step():
                if out.finished:
                    finals[out.rid] = out
            if self.clock_tokens == before and self.has_work():
                # every replica with work planned an empty step:
                # capacity-stuck, same contract as ServeReport.stalled
                stalled = True
                break
        if steps_left <= 0 and self.has_work():
            stalled = True
        if stalled:
            # the silent-loss fix: in-flight requests get an explicit
            # FINISH_ABORT final (with everything already streamed) and
            # their blocks are freed — they no longer vanish from the
            # report
            for rid in sorted(self._tracked):
                if not self._tracked[rid].finished:
                    finals[rid] = self._abort(rid, "stall")
        # backfill requests that finished before run() was entered (their
        # finish was already streamed by an earlier step() call) so the
        # report always carries one final output per completed request
        for rid, t in self._tracked.items():
            if t.finished and rid not in finals:
                finals[rid] = self._final_output(rid, t)
        emitted = sum(eng.stats["emitted"] for eng in self.engines)
        latency = None
        replica_latency = None
        if any(eng.tracer.enabled for eng in self.engines):
            # timelines are rid-keyed (rids are fleet-unique) so replica
            # timelines merge directly; step->clock maps must NOT merge
            # (step indices collide across replicas), hence per-replica
            # build_timelines calls
            merged: Dict[int, object] = {}
            replica_latency = []
            for eng in self.engines:
                if eng.tracer.enabled:
                    tls = build_timelines(eng.tracer.events)
                    merged.update(tls)
                    replica_latency.append(summarize_timelines(tls))
                else:
                    replica_latency.append({"requests": 0})
            latency = summarize_timelines(merged)
        return FleetReport(
            outputs=[finals[r] for r in sorted(finals)],
            steps=self.steps,
            clock_tokens=self.clock_tokens,
            emitted_tokens=emitted,
            weight_version=self.weight_version,
            stalled=stalled,
            replica_stats=[dict(eng.stats) for eng in self.engines],
            kv_pressure=[eng.kv_pressure for eng in self.engines],
            replica_gauges=[eng.gauge_snapshot() for eng in self.engines],
            latency=latency,
            replica_latency=replica_latency,
            healthy_replicas=self.healthy_replicas,
            quarantined_replicas=sum(h == QUARANTINED for h in self.health),
            redispatches=self.redispatches,
            replayed_tokens=self.replayed_tokens,
            aborted=self.aborted,
            push_retries=self.push_retries,
            delivered_tokens=sum(len(t.streamed_tokens)
                                 for t in self._tracked.values()),
        )
