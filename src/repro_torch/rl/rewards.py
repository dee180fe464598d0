"""Batch reward evaluation (port of `repro.rl.rewards`): the rule-based
verifier, on the host."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.data import tasks


def batch_rewards(problems: Sequence[tasks.Problem],
                  response_tokens: np.ndarray,
                  response_lengths: np.ndarray) -> np.ndarray:
    """problems repeated n-per-prompt to match response rows."""
    out = np.zeros((len(problems),), np.float32)
    for i, prob in enumerate(problems):
        ids = response_tokens[i, : int(response_lengths[i])]
        out[i] = tasks.reward_fn(prob, ids)
    return out


def exact_match_accuracy(problems, response_tokens, response_lengths
                         ) -> float:
    r = batch_rewards(problems, response_tokens, response_lengths)
    return float((r >= 1.0).mean())
