"""Observability of the port (port of `repro.obs`): so far only the
disabled tracer the engine defaults to."""
from repro_torch.obs.tracer import NULL_TRACER, NullTracer

__all__ = ["NULL_TRACER", "NullTracer"]
