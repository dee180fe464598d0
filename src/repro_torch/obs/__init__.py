"""Observability of the port (port of `repro.obs`): step-trace telemetry
for the serving fleet and the RL trainer.

Layering (no engine imports here: `obs` depends only on `roofline`):

- `obs.events`   the typed event schema (JSON-native dataclasses)
- `obs.tracer`   `NULL_TRACER` default + recording `StepTracer`
- `obs.timeline` per-request TTFT/TPOT/queue-wait/preemption post-pass
- `obs.export`   JSONL sink + Chrome trace-event (Perfetto) exporter

The engine owns one tracer (`NULL_TRACER` unless a `StepTracer` is
passed), every instrumentation site costs one branch when disabled, and
everything derived (timelines, percentiles, Chrome traces) is a pure
post-pass over the event list.
"""
from repro_torch.obs.events import (
    EVENT_KINDS,
    AbortEvent,
    AdmitEvent,
    CowEvent,
    DecodeEvent,
    DraftEvent,
    Event,
    FinishEvent,
    FleetGaugeEvent,
    GaugeEvent,
    GrowEvent,
    PrefillEvent,
    PushRetryEvent,
    QuarantineEvent,
    RedispatchEvent,
    ReplicaDownEvent,
    ReplicaUpEvent,
    StepEvent,
    SubmitEvent,
    SwapOutEvent,
    VerifyEvent,
    WeightsEvent,
    event_from_dict,
)
from repro_torch.obs.export import (
    JsonlSink,
    chrome_trace,
    read_events_jsonl,
    read_metrics_jsonl,
    write_events_jsonl,
)
from repro_torch.obs.timeline import (
    RequestTimeline,
    build_timelines,
    percentile,
    summarize_timelines,
)
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, StepTracer

__all__ = [
    "EVENT_KINDS", "AbortEvent", "AdmitEvent", "CowEvent", "DecodeEvent",
    "DraftEvent", "Event", "FinishEvent", "FleetGaugeEvent", "GaugeEvent",
    "GrowEvent", "PrefillEvent", "PushRetryEvent", "QuarantineEvent",
    "RedispatchEvent", "ReplicaDownEvent", "ReplicaUpEvent", "StepEvent",
    "SubmitEvent", "SwapOutEvent", "VerifyEvent", "WeightsEvent",
    "event_from_dict", "JsonlSink", "chrome_trace", "read_events_jsonl",
    "read_metrics_jsonl", "write_events_jsonl", "RequestTimeline",
    "build_timelines", "percentile", "summarize_timelines", "NULL_TRACER",
    "NullTracer", "StepTracer",
]
