"""Speculative decoding: proposer seam + config for the serving stack
(port of `repro.serving.spec_decode`, unchanged).

The vLLM-style split the scheduler/engine implement:

    proposer  (this module)   cheap guesses: `propose(req, k) -> tokens`
    scorer    (engine)        one `models.prefill_chunk` trace scores the
                              pending token + k drafts against the TARGET
                              model at every position (`want_all_logits`)
    sampler   (core.sampling) `rejection_sample` accepts a draft prefix
                              and emits one corrected/bonus token, with an
                              output distribution provably identical to
                              non-speculative sampling

Because the verifier is the target model itself and acceptance is
modified rejection sampling, speculation changes *latency only* — the
emitted token distribution is untouched (greedy: bit-exact).  That is
the property that makes it safe for RL rollouts: the stack already
carries one corrected train/inference mismatch (FP8, via TIS/MIS); a
distribution-perturbing drafter would add an uncorrected second one.

KV-rewind contract (the engine's `Verify` execution)
    The verify chunk writes KV rows for positions [T, T+k] (T =
    `cached_tokens` at plan time).  After rejection sampling accepts r of
    k drafts, the slot's `cache["lengths"]` row and `req.cached_tokens`
    are truncated to T+1+r.  Rows beyond the truncated length are never
    read — every attention path masks keys by per-slot length, and the
    paged kernels additionally clamp their gather to `_live_blocks` — and
    the next write (decode or the next verify) overwrites them in place.
    No copy, no zeroing: rewind is a host-side integer truncation.

Only attention-only decoder models speculate: SSM recurrent state
advances in-place during the verify chunk and cannot be rewound by a
length truncation, and enc-dec / multimodal prefills don't run through
`prefill_chunk` at all.  (A draft-model proposer sharing the pool is the
recorded follow-up; the `propose` seam below is all it needs.)
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs.

    num_draft_tokens : max drafts (k) scored per verify; the verify trace
                       width is fixed at k+1 so every verify shares one
                       compiled shape.
    max_ngram/min_ngram : suffix-match window the n-gram proposer scans,
                       longest first (prompt-lookup decoding).
    """

    num_draft_tokens: int = 4
    max_ngram: int = 3
    min_ngram: int = 1

    def __post_init__(self):
        assert self.num_draft_tokens >= 1, self.num_draft_tokens
        assert 1 <= self.min_ngram <= self.max_ngram, (
            self.min_ngram, self.max_ngram)


class NGramProposer:
    """Prompt-lookup drafter: continue the request's own history.

    The context is every token the model has committed — the prompt plus
    `req.generated` (whose last entry is the engine's pending token, the
    one the next forward pass feeds).  The longest context suffix
    (max_ngram down to min_ngram) is matched against the most recent
    earlier occurrence in the context, and the tokens that followed that
    occurrence are proposed.  Free (host-side, no device work), and very
    effective exactly where decode steps are most wasteful: repetitive
    suffixes — code, templated text, and the repetition cycles greedy
    decoding falls into.
    """

    def __init__(self, spec: SpecConfig):
        self.spec = spec

    def propose(self, req, k: int) -> List[int]:
        """Up to `k` draft tokens continuing `req`'s committed context
        (may return fewer, or none — the scheduler then falls back to a
        plain decode step for the slot).

        The lookup is *self-extending*: each matched continuation is
        appended to the working context and the suffix re-matched, so a
        match near the end of the context (the constant-token runs and
        short cycles greedy decoding produces, where the most recent
        occurrence overlaps the suffix and yields a 1-token
        continuation) still drafts the full k tokens."""
        ctx = [int(t) for t in req.prompt] + [int(t) for t in req.generated]
        out: List[int] = []
        while len(out) < k:
            cand = self._continuation(ctx, k - len(out))
            if not cand:
                break
            out.extend(cand)
            ctx.extend(cand)
        return out

    def _continuation(self, ctx: Sequence[int], want: int) -> List[int]:
        """Continuation after the most recent earlier occurrence of the
        longest context-suffix n-gram (longest n, then rightmost j — a
        found match always yields >= 1 token since j + n < len(ctx))."""
        n_ctx = len(ctx)
        for n in range(min(self.spec.max_ngram, n_ctx - 1),
                       self.spec.min_ngram - 1, -1):
            suffix = ctx[n_ctx - n:]
            for j in range(n_ctx - n - 1, -1, -1):
                if ctx[j:j + n] == suffix:
                    return list(ctx[j + n:j + n + want])
        return []


def _check_proposer(proposer) -> None:
    assert callable(getattr(proposer, "propose", None)), (
        "a speculative proposer needs propose(req, k) -> draft tokens; "
        f"got {proposer!r}")


__all__ = ["SpecConfig", "NGramProposer"]
