"""Roofline models of the port (port of `repro.roofline`): the step
roofline at the H100's peaks (`analysis`) and the analytic KV byte model
the step tracer reads (`kv_bytes`)."""
from repro_torch.roofline.analysis import (
    HBM_BW,
    ICI_BW,
    PEAK_FLOPS,
    RooflineTerms,
    analyze,
    collective_bytes,
    count_step,
    model_flops_for_cell,
)
from repro_torch.roofline.kv_bytes import (
    DECODE_MODES,
    KVGeometry,
    cross_tier_block_bytes,
    cross_tier_move_bytes,
    decode_hbm_bytes,
    prefill_chunk_hbm_bytes,
    prefix_revival_bytes,
    trace_decode_bytes,
    verify_hbm_bytes,
)

__all__ = ["analyze", "count_step", "collective_bytes", "model_flops_for_cell",
           "RooflineTerms", "PEAK_FLOPS", "HBM_BW", "ICI_BW",
           "KVGeometry", "DECODE_MODES", "decode_hbm_bytes",
           "prefill_chunk_hbm_bytes", "trace_decode_bytes",
           "verify_hbm_bytes", "cross_tier_block_bytes",
           "cross_tier_move_bytes", "prefix_revival_bytes"]
