"""Toy token space and prompt recipes (port of `repro.data.tasks`, the
parts the rollout and serving slices need)."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

PAD, BOS, EOS, ANS = 0, 1, 2, 3
_SPECIALS = ["<pad>", "<bos>", "<eos>", "<ans>"]
_DIGITS = [str(d) for d in range(10)]
_OPS = ["+", "-", "*", "=", " "]
VOCAB: List[str] = _SPECIALS + _DIGITS + _OPS
TOK = {t: i for i, t in enumerate(VOCAB)}
VOCAB_SIZE = len(VOCAB)  # 19


def encode(text: str) -> List[int]:
    return [TOK[c] for c in text]


@dataclasses.dataclass
class Problem:
    prompt_ids: List[int]
    answer: str


def random_prompt(seed: int, length: int) -> np.ndarray:
    """Deterministic synthetic prompt: BOS + random in-vocab tokens —
    the same recipe (and so the same tokens) as the reference's."""
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [[BOS], rng.integers(4, 19, size=length - 1)]).astype(np.int32)


def sample_problem(rng: np.random.Generator, max_operand: int = 99) -> Problem:
    """An arithmetic prompt "a+b=" / "a-b=" drawn from `rng` — the same
    draws, in the same order, as the reference's (the launcher's trace)."""
    a = int(rng.integers(0, max_operand + 1))
    b = int(rng.integers(0, max_operand + 1))
    op = rng.choice(["+", "-"])
    val = a + b if op == "+" else a - b
    text = f"{a}{op}{b}="
    return Problem(prompt_ids=[BOS] + encode(text), answer=str(val))
