"""Per-request lifecycle timelines from a step-trace event stream (port of
`repro.obs.timeline`, unchanged).

A pure post-pass over `obs.events`: no engine access, no numpy.  The
clock is the token-unit clock the `StepTracer` keeps — every token a
step emits arrives at that step's END-of-step clock (the fused trace
retires at once), so TPOT inter-arrivals are step-granular: a verify
burst lands k tokens at one instant (k-1 zero gaps — honest, that IS
what speculation buys), and a preempted request shows a long gap
spanning its swapped-out clock.

Derived per request:

- ``queue_wait``  — submit clock -> admit clock (first fresh admission)
- ``ttft``        — submit clock -> first generated token's clock
- ``tpot``        — inter-arrival gaps between consecutive tokens
- ``preemptions`` — (swap-out clock, swap-in clock) spans
- ``version_spans`` — contiguous (weight_version, n_tokens) runs

`percentile` reproduces numpy's default linear interpolation exactly
(pinned against ``np.percentile`` in tests), so summaries need no numpy
at runtime.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import events as ev


def percentile(values: List[float], q: float) -> float:
    """numpy-compatible percentile (linear interpolation, q in [0,100])."""
    if not values:
        return math.nan
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


@dataclasses.dataclass
class RequestTimeline:
    """One request's lifecycle in token-unit clock."""

    rid: int
    replica: int = 0
    submit_clock: Optional[float] = None
    admit_clock: Optional[float] = None          # first fresh admission
    first_token_clock: Optional[float] = None
    finish_clock: Optional[float] = None
    token_clocks: List[float] = dataclasses.field(default_factory=list)
    token_versions: List[int] = dataclasses.field(default_factory=list)
    preemptions: List[Tuple[float, float]] = \
        dataclasses.field(default_factory=list)
    n_tokens: int = 0

    @property
    def queue_wait(self) -> Optional[float]:
        if self.submit_clock is None or self.admit_clock is None:
            return None
        return self.admit_clock - self.submit_clock

    @property
    def ttft(self) -> Optional[float]:
        if self.submit_clock is None or self.first_token_clock is None:
            return None
        return self.first_token_clock - self.submit_clock

    @property
    def tpot(self) -> List[float]:
        """Inter-arrival gaps between consecutive generated tokens."""
        cs = self.token_clocks
        return [cs[i + 1] - cs[i] for i in range(len(cs) - 1)]

    @property
    def version_spans(self) -> List[Tuple[int, int]]:
        """Contiguous (weight_version, n_tokens) runs over the output."""
        spans: List[Tuple[int, int]] = []
        for v in self.token_versions:
            if spans and spans[-1][0] == v:
                spans[-1] = (v, spans[-1][1] + 1)
            else:
                spans.append((v, 1))
        return spans


def build_timelines(events: List[ev.Event]) -> Dict[int, RequestTimeline]:
    """Fold an event stream into per-request timelines.

    Token arrival clocks come from the `StepEvent` records: tokens
    emitted during step s arrive at that step's end-of-step clock.
    Works on typed events from a `StepTracer` or on `event_from_dict`
    output parsed back from a JSONL sink.
    """
    step_end: Dict[int, float] = {}
    step_start: Dict[int, float] = {}
    for e in events:
        if isinstance(e, ev.StepEvent):
            step_start[e.step] = e.clock_before
            step_end[e.step] = e.clock_before + e.cost_tokens

    def end_clock(step: int) -> float:
        return step_end.get(step, float(step))

    tls: Dict[int, RequestTimeline] = {}

    def tl(rid: int) -> RequestTimeline:
        if rid not in tls:
            tls[rid] = RequestTimeline(rid=rid)
        return tls[rid]

    open_swaps: Dict[int, float] = {}           # rid -> swap-out clock
    for e in events:
        if isinstance(e, ev.SubmitEvent):
            t = tl(e.rid)
            t.submit_clock = e.clock
            t.replica = e.replica
        elif isinstance(e, ev.AdmitEvent):
            t = tl(e.rid)
            if e.swap_in and e.rid in open_swaps:
                t.preemptions.append(
                    (open_swaps.pop(e.rid),
                     step_start.get(e.step, float(e.step))))
            elif t.admit_clock is None:
                t.admit_clock = step_start.get(e.step, float(e.step))
        elif isinstance(e, ev.SwapOutEvent):
            open_swaps[e.rid] = end_clock(e.step)
        elif isinstance(e, ev.PrefillEvent):
            # the final chunk samples the request's first token
            if e.last and tl(e.rid).first_token_clock is None:
                t = tl(e.rid)
                t.first_token_clock = end_clock(e.step)
                t.token_clocks.append(end_clock(e.step))
                t.token_versions.append(e.version)
                t.n_tokens += 1
        elif isinstance(e, ev.VerifyEvent):
            t = tl(e.rid)
            c = end_clock(e.step)
            for _ in range(e.committed):
                if t.first_token_clock is None:
                    t.first_token_clock = c
                t.token_clocks.append(c)
                t.token_versions.append(e.version)
                t.n_tokens += 1
        elif isinstance(e, ev.DecodeEvent):
            c = end_clock(e.step)
            for rid in e.rids:
                t = tl(rid)
                if t.first_token_clock is None:
                    t.first_token_clock = c
                t.token_clocks.append(c)
                t.token_versions.append(e.version)
                t.n_tokens += 1
        elif isinstance(e, ev.FinishEvent):
            tl(e.rid).finish_clock = end_clock(e.step)
    return tls


def summarize_timelines(tls: Dict[int, RequestTimeline]) -> dict:
    """p50/p95/p99/mean latency summary over a timeline map — the
    `ServeReport.latency` / `FleetReport.latency` payload."""
    ttfts = [t.ttft for t in tls.values() if t.ttft is not None]
    waits = [t.queue_wait for t in tls.values() if t.queue_wait is not None]
    tpots = [g for t in tls.values() for g in t.tpot]

    def pack(xs: List[float]) -> dict:
        if not xs:
            return {"n": 0}
        return {
            "n": len(xs),
            "mean": sum(xs) / len(xs),
            "p50": percentile(xs, 50),
            "p95": percentile(xs, 95),
            "p99": percentile(xs, 99),
        }

    return {
        "requests": len(tls),
        "ttft": pack(ttfts),
        "queue_wait": pack(waits),
        "tpot": pack(tpots),
        "preemption_spans": sum(len(t.preemptions) for t in tls.values()),
        "preempted_requests": sum(
            1 for t in tls.values() if t.preemptions),
    }
