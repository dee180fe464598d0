"""Streaming per-request completion outputs, vLLM-style (port of
`repro.serving.outputs`, unchanged: plain dataclasses).

The fleet front-end (`serving.frontend`) turns the engines' internal
`Request` bookkeeping into a stream of `RequestOutput`s: one per request
per front-end step that produced new tokens (or a finish), carrying the
incremental delta plus the cumulative `CompletionOutput`.

Every generated token is stamped with the **weight version** that
produced it (`CompletionOutput.versions`).  Under live weight updates a
request can span versions — the per-token attribution is what makes the
version-aware TIS/MIS correction (`rl.correction`) possible: a rollout
that straddles a mid-flight update is corrected token-by-token against
the version that actually sampled each token, instead of being dropped
or mis-attributed to a step-level average policy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

FINISH_STOP = "stop"  # hit the engine's EOS id
FINISH_LENGTH = "length"  # hit the request's max_new budget
# aborted by the front-end: the fleet stalled with the request in
# flight, its deadline_tokens passed on the fleet clock, or no healthy
# replica was left to fail it over to.  The final RequestOutput carries
# every token already streamed (exactly-once: nothing re-emitted,
# nothing silently vanishes) and the request's blocks are freed.
FINISH_ABORT = "abort"


@dataclasses.dataclass
class CompletionOutput:
    """Cumulative output of one request.

    Parallel lists, one entry per generated token:

    token_ids : the sampled ids, in emission order
    versions  : weight version live on the serving replica when each
                token was sampled (the per-token policy attribution)
    logps     : rollout log-probabilities under the sampling
                distribution (the pi^FP8 side of TIS); None unless the
                engine was built with ``want_logps=True``
    """

    token_ids: List[int] = dataclasses.field(default_factory=list)
    versions: List[int] = dataclasses.field(default_factory=list)
    logps: Optional[List[float]] = None
    finish_reason: Optional[str] = None  # None while still running

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    def __len__(self) -> int:
        return len(self.token_ids)


@dataclasses.dataclass
class RequestOutput:
    """One front-end step's delta for one request.

    new_token_ids / new_versions / new_logps are the tokens emitted
    since the previous `RequestOutput` for this rid; `output` is the
    cumulative view.  `replica` names the engine that served the step —
    a request never migrates between replicas (KV is replica-local), so
    its whole stream carries one replica index.
    """

    rid: int
    replica: int
    prompt_token_ids: List[int]
    new_token_ids: List[int]
    new_versions: List[int]
    new_logps: Optional[List[float]]
    output: CompletionOutput
    finished: bool

    @property
    def finish_reason(self) -> Optional[str]:
        return self.output.finish_reason
