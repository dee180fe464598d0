"""Toy token space and prompt recipe (port of `repro.data.tasks`, the
parts the rollout slice needs)."""
from __future__ import annotations

from typing import List

import numpy as np

PAD, BOS, EOS, ANS = 0, 1, 2, 3
_SPECIALS = ["<pad>", "<bos>", "<eos>", "<ans>"]
_DIGITS = [str(d) for d in range(10)]
_OPS = ["+", "-", "*", "=", " "]
VOCAB: List[str] = _SPECIALS + _DIGITS + _OPS
VOCAB_SIZE = len(VOCAB)  # 19


def random_prompt(seed: int, length: int) -> np.ndarray:
    """Deterministic synthetic prompt: BOS + random in-vocab tokens —
    the same recipe (and so the same tokens) as the reference's."""
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [[BOS], rng.integers(4, 19, size=length - 1)]).astype(np.int32)
