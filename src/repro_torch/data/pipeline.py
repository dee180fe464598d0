"""Deterministic, resumable prompt pipeline (port of `repro.data.pipeline`).

The RL trainer consumes fixed-shape prompt batches.  The pipeline's cursor
(epoch seed + step index) is checkpointed, so a restarted run sees exactly
the prompt stream it would have seen.  Prompts are drawn with numpy from
the same seeds as the reference's, so the port yields the same prompts.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.data import tasks


@dataclasses.dataclass
class PromptBatch:
    tokens: np.ndarray        # (B, P) int32, right-padded
    lengths: np.ndarray       # (B,) int32
    problems: List[tasks.Problem]


class PromptPipeline:
    def __init__(self, batch_size: int, max_prompt_len: int = 16,
                 seed: int = 0, max_operand: int = 99):
        self.batch_size = batch_size
        self.max_prompt_len = max_prompt_len
        self.seed = seed
        self.max_operand = max_operand
        self.step = 0

    # -- checkpointable cursor -------------------------------------------
    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step,
                "batch_size": self.batch_size,
                "max_prompt_len": self.max_prompt_len,
                "max_operand": self.max_operand}

    def load_state_dict(self, d: dict):
        self.seed = d["seed"]
        self.step = d["step"]
        self.batch_size = d["batch_size"]
        self.max_prompt_len = d["max_prompt_len"]
        self.max_operand = d["max_operand"]

    # -- iteration ---------------------------------------------------------
    def next_batch(self) -> PromptBatch:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        problems = [tasks.sample_problem(rng, self.max_operand)
                    for _ in range(self.batch_size)]
        tokens = np.full((self.batch_size, self.max_prompt_len), tasks.PAD,
                         np.int32)
        lengths = np.zeros((self.batch_size,), np.int32)
        for i, p in enumerate(problems):
            ids = p.prompt_ids[: self.max_prompt_len]
            tokens[i, : len(ids)] = ids
            lengths[i] = len(ids)
        return PromptBatch(tokens=tokens, lengths=lengths, problems=problems)
