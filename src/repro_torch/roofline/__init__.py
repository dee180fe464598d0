"""Roofline models of the port (port of `repro.roofline`): so far the
analytic KV byte model the step tracer reads (`kv_bytes`)."""
from repro_torch.roofline.kv_bytes import (
    DECODE_MODES,
    KVGeometry,
    decode_hbm_bytes,
    prefill_chunk_hbm_bytes,
    verify_hbm_bytes,
)

__all__ = ["KVGeometry", "DECODE_MODES", "decode_hbm_bytes",
           "prefill_chunk_hbm_bytes", "verify_hbm_bytes"]
