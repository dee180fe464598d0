"""Toy token space, prompt and frame recipes and the rule-based verifier
(port of `repro.data.tasks`)."""
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


def random_frames(seed: int, n: int, d_model: int) -> np.ndarray:
    """Deterministic synthetic encoder frame embeddings (n, d_model) f32 —
    the audio frontend's stand-in for enc-dec traces, the reference's
    draw."""
    return np.random.default_rng(seed).normal(
        size=(n, d_model)).astype(np.float32)


def sample_problem(rng: np.random.Generator, max_operand: int = 99) -> Problem:
    """An arithmetic prompt "a+b=" / "a-b=" drawn from `rng` — the same
    draws, in the same order, as the reference's (the launcher's trace)."""
    a = int(rng.integers(0, max_operand + 1))
    b = int(rng.integers(0, max_operand + 1))
    op = rng.choice(["+", "-"])
    val = a + b if op == "+" else a - b
    text = f"{a}{op}{b}="
    return Problem(prompt_ids=[BOS] + encode(text), answer=str(val))


def decode_ids(ids) -> str:
    """Token ids -> text; specials other than `<ans>` are dropped and EOS
    ends the text."""
    out = []
    for i in ids:
        i = int(i)
        if i < len(VOCAB) and i >= len(_SPECIALS):
            out.append(VOCAB[i])
        elif i == ANS:
            out.append("<ans>")
        elif i == EOS:
            break
    return "".join(out)


def reward_fn(problem: Problem, response_ids) -> float:
    """Rule-based verifiable reward (paper's reward model analogue):
    response must contain `<ans>` followed by exactly the right digits and
    then EOS.  Partial credit 0.1 for a well-formed but wrong answer."""
    ids = [int(i) for i in response_ids]
    if ANS not in ids:
        return 0.0
    start = ids.index(ANS) + 1
    try:
        end = ids.index(EOS, start)
    except ValueError:
        return 0.0
    text = decode_ids(ids[start:end]) if end > start else ""
    expected = problem.answer
    if text == expected:
        return 1.0
    return 0.1 if text.lstrip("-").isdigit() else 0.0


def solution_ids(problem: Problem) -> List[int]:
    """Gold completion (for sanity baselines / SFT warmstart)."""
    return [ANS] + encode(problem.answer) + [EOS]
