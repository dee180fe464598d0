"""Step tracer (port of `repro.obs.tracer`, the disabled half only).

`NullTracer` is the engine's default: `enabled` is False and it has no
hooks.  The recording `StepTracer`, its events and sinks come with the
tooling item of ROADMAP queue 1 (item 6); until then the port's engine
refuses any other tracer.
"""
from __future__ import annotations


class NullTracer:
    """Disabled tracer: `enabled` is False and every hook is absent."""

    __slots__ = ()
    enabled = False


NULL_TRACER = NullTracer()
