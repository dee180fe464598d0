"""Analytic HBM bytes-moved model for the serving attention hot path (port
of `repro.roofline.kv_bytes`, unchanged: integer arithmetic only).

Serving decode and chunked-prefill context reads are bound by memory
bytes: FLOPs per token are trivial next to streaming the reachable KV, so
modeled bytes moved over the card's memory rate is the step's roofline
term, and ratios of bytes between mechanisms are ratios of step time.
The recording `obs.tracer.StepTracer` evaluates this model at each
engine's own `KVGeometry` and puts the result on its events.

Four decode mechanisms over the same logical KV (all costs are per
sequence, per decode step, across attention layers; the one-token q/out
traffic is negligible and excluded):

    paged-clamped   the paged decode kernel (kernel 4): tables clamped to
                    ceil(context/BS) live blocks, K/V streamed once at
                    payload width.  Cost scales with the slot's context.
    paged-full      a kernel that streams the whole padded table width
                    regardless of context.
    gather          the table-gather path: pool rows are gathered into a
                    contiguous copy (payload-width write + read-back) and,
                    when quantized, dequantized into a bf16 copy (write +
                    read) before attention reads it.
    contiguous      the non-paged decode kernel over a dense (B, S_max)
                    cache: payload-width stream of the whole allocated
                    sequence capacity.

Chunked prefill reads the same pool through the same mechanisms; the
chunk's reachable context is min(start + C, lengths).
"""
from __future__ import annotations

import dataclasses

DECODE_MODES = ("paged-clamped", "paged-full", "gather", "contiguous")


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    """Shape/byte facts of one serving engine's paged KV layout."""

    n_kv_heads: int
    d_head: int
    block_size: int        # tokens per pool block
    table_width: int       # W table entries per sequence
    kv_elem_bytes: int     # 1 = fp8 payload, 2 = bf16
    n_attn_layers: int = 1

    @property
    def token_payload_bytes(self) -> int:
        """K+V payload bytes one token occupies in ONE attention layer."""
        return 2 * self.n_kv_heads * self.d_head * self.kv_elem_bytes

    @property
    def token_bf16_bytes(self) -> int:
        """K+V bytes of one token's dequantized bf16 working copy."""
        return 2 * self.n_kv_heads * self.d_head * 2

    def live_blocks(self, context_len: int) -> int:
        """ceil(context / BS) clamped to [1, W] — mirrors the kernel's
        live-block count and the gather path's `_live_blocks`."""
        nb = -(-max(int(context_len), 1) // self.block_size)
        return max(1, min(self.table_width, nb))

    @classmethod
    def from_engine(cls, eng) -> "KVGeometry":
        """A `ServingEngine`'s paged-KV layout (duck-typed: reads only
        host attributes), so the model is evaluated on exactly the layout
        the engine served."""
        cfg = eng.cfg
        return cls(
            n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            block_size=eng.block_size,
            table_width=eng.cache["block_tables"].shape[1],
            kv_elem_bytes=1 if eng.precision.kv_quantized else 2,
            n_attn_layers=sum(cfg.is_attn_layer(i)
                              for i in range(cfg.n_layers)))


def decode_hbm_bytes(geo: KVGeometry, context_len: int,
                     mode: str = "paged-clamped") -> int:
    """Modeled HBM bytes one sequence's decode step moves for KV reads."""
    assert mode in DECODE_MODES, (mode, DECODE_MODES)
    bs = geo.block_size
    if mode == "paged-clamped":
        tokens = geo.live_blocks(context_len) * bs
        per_token = geo.token_payload_bytes
    elif mode == "paged-full":
        tokens = geo.table_width * bs
        per_token = geo.token_payload_bytes
    elif mode == "contiguous":
        tokens = geo.table_width * bs      # S_max capacity, dense layout
        per_token = geo.token_payload_bytes
    else:                                  # "gather" (live-sliced table gather)
        tokens = geo.live_blocks(context_len) * bs
        # pool read + contiguous copy write + copy read, at payload width
        per_token = 3 * geo.token_payload_bytes
        if geo.kv_elem_bytes < 2:
            # quantized pool: the bf16 dequant copy is written once and
            # read once by the attention einsum
            per_token += 2 * geo.token_bf16_bytes
    return tokens * per_token * geo.n_attn_layers


def prefill_chunk_hbm_bytes(geo: KVGeometry, start: int, chunk: int,
                            total_len: int,
                            mode: str = "paged-clamped") -> int:
    """Modeled HBM bytes one chunked-prefill trace moves reading context
    from the pool (the chunk's own KV write is common to every mode and
    excluded).  Reachable context = min(start + chunk, total_len)."""
    ctx = min(start + chunk, total_len)
    return decode_hbm_bytes(geo, ctx, mode)


def verify_hbm_bytes(geo: KVGeometry, context_len: int, num_drafts: int,
                     mode: str = "paged-clamped") -> int:
    """Modeled HBM bytes one speculative-decoding verify trace moves: the
    [pending, draft_1..draft_k] chunk starts at `context_len` valid rows
    and streams its reachable context (context + k + 1 rows, block-
    clamped) from the pool once — the same stream one decode step of
    equal context pays, widened by the draft rows.  A verify that
    accepts r drafts replaces r+1 decode steps' pool streams, so
    speculation must win at equal modeled bytes, not by under-counting
    the verify pass."""
    return prefill_chunk_hbm_bytes(geo, context_len, num_drafts + 1,
                                   context_len + num_drafts + 1, mode)


def trace_decode_bytes(geo: KVGeometry, contexts,
                       mode: str = "paged-clamped") -> int:
    """Total modeled decode bytes over a trace's per-step slot contexts
    (one entry per (step, decode slot) with that slot's context length)."""
    return sum(decode_hbm_bytes(geo, c, mode) for c in contexts)


# ---------------------------------------------------------------------------
# cross-tier (host link) pricing: the two-tier allocator's move costs
# ---------------------------------------------------------------------------

def cross_tier_block_bytes(geo: KVGeometry) -> int:
    """Device-side bytes one block-granular tier move (demote or promote)
    touches: the block's KV payload across attention layers, read or
    written once on the device end of the host link (both directions cost
    the same)."""
    return geo.block_size * geo.token_payload_bytes * geo.n_attn_layers


def cross_tier_move_bytes(geo: KVGeometry, n_blocks: int) -> int:
    """Modeled bytes for `n_blocks` blocks crossing the host link in either
    direction (an allocator demote / promote's `moves` list)."""
    return n_blocks * cross_tier_block_bytes(geo)


def prefix_revival_bytes(geo: KVGeometry, n_blocks: int) -> int:
    """Modeled bytes to revive a host-cached prefix of `n_blocks` blocks by
    copy-in: one promote write per block (recomputing it would write the
    same payload and also stream the growing context)."""
    return cross_tier_move_bytes(geo, n_blocks)
