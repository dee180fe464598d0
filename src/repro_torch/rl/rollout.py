"""Rollout engine: batched autoregressive generation on the FP8 policy
(port of `repro.rl.rollout`).

The inference-engine role of the paper's stack: it consumes the synced
rollout params, prefills once (recalibrating the KV scales when
`calculate_kv_scales` is on), then decodes in an eager Python loop that
stops when every sequence has emitted EOS or after `max_new_tokens`
steps, and returns per-token rollout logprobs (the pi^FP8 side of TIS).
GRPO group sampling (`num_samples_per_prompt` > 1) prefills each prompt
once and forks per-sample block tables over the shared KV blocks,
copying the partially filled boundary block before the first divergent
append (copy-on-write), and tiling every SSM layer's recurrent state
G-fold on its batch axis, as the reference does (an attention-free model
has no pool and no tables to fork), and an enc-dec model's cross caches
and source lengths likewise.  `extra_inputs` carries an enc-dec model's
`frames` (B, S_src, D) and `src_lengths` (B,), or a VLM's `patches` (B, P,
D), whose P positions the cache is sized for (the reference counts only
the text there, so its decode writes past the block table land in the
last table entry's block; the port sizes the table with the prefix).
With `want_routing` an
MoE model's routing is recorded for rollout router replay: the prefill's
per prompt and every decode step's per sample, as the reference records
them.  The scoring helpers (`packed_sequences`,
`gather_response_logps`) align a trajectory with the trainer's
teacher-forced pass.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.sampling import sample as _sample
from repro_torch.data import tasks
from repro_torch.models import attention as attn_mod
from repro_torch.models.ssm import SSMState
from repro_torch.models.transformer import Transformer
from repro_torch.rl.calibration import apply_kv_scales


class Trajectory(NamedTuple):
    """One rollout batch (B sequences)."""

    prompt_tokens: torch.Tensor     # (B, P)
    prompt_lengths: torch.Tensor    # (B,)
    response_tokens: torch.Tensor   # (B, G) PAD after EOS
    response_mask: torch.Tensor     # (B, G) 1.0 through EOS inclusive
    rollout_logps: torch.Tensor     # (B, G) log pi^FP8 of sampled tokens
    response_lengths: torch.Tensor  # (B,)
    routing: Optional[dict]         # MoE routing (want_routing), else None
    kv_scales: Optional[dict]       # per-slot (R,) k/v scales after calibration


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    max_new_tokens: int = 24
    temperature: float = 1.0
    top_k: int = 0              # 0 = full softmax
    eos_id: int = tasks.EOS
    pad_id: int = tasks.PAD


def generate(rollout_params: dict, prompts, prompt_lengths,
             generator: Optional[torch.Generator], cfg,
             precision: PrecisionConfig,
             sampler: SamplerConfig = SamplerConfig(), *,
             kv_scales: Optional[dict] = None, page_size: int = 8,
             num_samples_per_prompt: int = 1,
             shared_prefix_blocks: Optional[int] = None,
             want_routing: bool = False, extra_inputs: Optional[dict] = None,
             device=None) -> Trajectory:
    """Sample `num_samples_per_prompt` responses per right-padded prompt.

    Runs on `device` (CUDA when not given; without CUDA that raises).
    `generator` drives the temperature > 0 draws (unused when greedy).
    With a group size of 1 every sequence owns a contiguous run of blocks
    (identity tables).  With a larger group the prompts are prefilled once
    and samples share the prompt's first `shared_prefix_blocks` blocks
    read-only; that bound must not exceed min(prompt_lengths + P) //
    page_size, P a VLM's patch prefix (the default None shares nothing).
    Rows come back grouped: sample s of prompt i is row i *
    num_samples_per_prompt + s.  `extra_inputs` go to the prefill with
    the prompts (`frames` and `src_lengths`, or `patches`).

    With `want_routing` and MoE layers, `routing` is {"prefill": {slot:
    (R, B, P, K)} — per prompt, the prefill is shared by a group —,
    "decode": {slot: (G, R, B * group, 1, K)}}, int32, the rows of steps
    not run (every sequence done) zero, as the reference's buffer.
    """
    device = resolve_device(device)
    model = Transformer(cfg, device)
    prompts = torch.as_tensor(prompts, device=device).to(torch.int32)
    prompt_lengths = torch.as_tensor(prompt_lengths, device=device).to(torch.int32)
    b, p = prompts.shape
    g = sampler.max_new_tokens
    group = num_samples_per_prompt
    assert group >= 1
    n = b * group
    inputs = {"tokens": prompts, "lengths": prompt_lengths}
    inputs.update({k: torch.as_tensor(v, device=device)
                   for k, v in (extra_inputs or {}).items()})
    src_len = inputs["frames"].shape[1] if "frames" in inputs else 0
    # the prefill writes prefix + text positions: size the table for both
    pos = p + (inputs["patches"].shape[1] if "patches" in inputs else 0)
    max_len = pos + g + 1

    if group == 1:
        cache = model.init_cache(b, max_len, precision, page_size=page_size,
                                 src_len=src_len)
    else:
        fp, priv, w = _group_layout(pos, g, page_size, shared_prefix_blocks)
        cache = model.init_cache(b, max_len, precision, page_size=page_size,
                                 num_pages=b * fp + n * priv, src_len=src_len)
        if "block_tables" in cache:
            cache["block_tables"] = _prefill_tables(b, group, w, fp, priv, device)
    if kv_scales is not None:
        apply_kv_scales(cache, kv_scales)
    moe_slots = [f"s{j}" for j, s in enumerate(model.pattern) if s.ffn == "moe"]
    want_routing = want_routing and bool(moe_slots)
    out = model.prefill(rollout_params, inputs, cache, precision, want_routing=want_routing)
    logits0, cache = out[:2]
    routing = None
    if want_routing:
        routing = {"prefill": out[2], "decode": {
            name: torch.zeros((g, model.repeats, n, 1, cfg.top_k), dtype=torch.int32,
                              device=device) for name in moe_slots}}

    if group > 1:
        cache = _fork_group(cache, b, group, pos, page_size, fp, priv, w)
        logits0 = torch.repeat_interleave(logits0, group, dim=0)
        prompts = torch.repeat_interleave(prompts, group, dim=0)
        prompt_lengths = torch.repeat_interleave(prompt_lengths, group, dim=0)

    tok, logp = _sample(logits0, generator, sampler.temperature, sampler.top_k)
    done = torch.zeros((n,), dtype=torch.bool, device=device)
    resp = torch.full((n, g), sampler.pad_id, dtype=torch.int32, device=device)
    logps = torch.zeros((n, g), dtype=torch.float32, device=device)
    mask = torch.zeros((n, g), dtype=torch.float32, device=device)
    for i in range(g):
        if bool(done.all()):
            break
        # Ordering invariant: the token sampled in the previous iteration
        # is committed FIRST (EOS included — mask 1 through EOS), and only
        # THEN does `done` absorb it; a done sequence commits PAD/0 from
        # here on.  The decode step runs for every row (fixed shapes); its
        # output for done rows is masked out by `response_mask`.
        resp[:, i] = torch.where(done, sampler.pad_id, tok.to(torch.int32))
        logps[:, i] = torch.where(done, 0.0, logp)
        mask[:, i] = torch.where(done, 0.0, 1.0)
        done = done | (tok == sampler.eos_id)
        out = model.decode_step(rollout_params, tok, cache, precision,
                                want_routing=want_routing)
        logits, cache = out[:2]
        if want_routing:
            for name, idx in out[2]["routing"].items():
                routing["decode"][name][i] = idx
        tok, logp = _sample(logits, generator, sampler.temperature,
                            sampler.top_k)

    return Trajectory(
        prompt_tokens=prompts,
        prompt_lengths=prompt_lengths,
        response_tokens=resp,
        response_mask=mask,
        rollout_logps=logps,
        response_lengths=mask.sum(dim=1).to(torch.int32),
        routing=routing,
        kv_scales=_collect_kv_scales(cache),
    )


# ---------------------------------------------------------------------------
# GRPO group sampling: shared-prefix pool layout + fork/copy-on-write
# ---------------------------------------------------------------------------

def _group_layout(p: int, g: int, page_size: int,
                  shared_prefix_blocks: Optional[int]):
    """Static pool geometry: fp blocks shared by a prompt's samples, priv
    private blocks per sample, w table width."""
    w = -(-(p + g + 1) // page_size)
    fp = 0 if shared_prefix_blocks is None else shared_prefix_blocks
    fp = max(0, min(fp, p // page_size))
    return fp, w - fp, w


def _prefill_tables(b: int, group: int, w: int, fp: int, priv: int,
                    device=None) -> torch.Tensor:
    """(B, W) tables for the one shared prefill: prompt i writes its shared
    rows [i*fp, (i+1)*fp) and spills the rest into sample i*G's private
    rows — the donor copy `_fork_group` copies to the siblings."""
    ii = torch.arange(b, device=device)[:, None]
    jj = torch.arange(w, device=device)[None, :]
    donor = b * fp + (ii * group) * priv + (jj - fp)
    return torch.where(jj < fp, ii * fp + jj, donor).to(torch.int32)


def _fork_group(cache: dict, b: int, group: int, p: int, page_size: int,
                fp: int, priv: int, w: int) -> dict:
    """Fork the prefilled B-prompt cache into B*G per-sample sequences:
    copy the donor's prompt rows past the shared region to every sibling
    (copy-on-write, before any divergent append), give each sample the
    shared prefix rows plus its own private run, and tile the lengths, the
    SSM state, the cross caches and the source lengths (G copies of
    prompt i's at rows i*G .. i*G+G-1; the per-layer cross scales are
    shared).  `p` counts the prefilled positions, a VLM's prefix
    included."""
    n = b * group
    pool0 = b * fp
    n_cow = -(-p // page_size) - fp      # donor rows holding prompt tokens
    device = cache["lengths"].device
    if n_cow > 0:
        src, dst = [], []
        for i in range(b):
            for s in range(1, group):
                for r in range(n_cow):
                    src.append(pool0 + (i * group) * priv + r)
                    dst.append(pool0 + (i * group + s) * priv + r)
        for sd in cache["slots"].values():
            if "kv" in sd:
                attn_mod.paged_copy_rows(sd["kv"], src, dst)
    for sd in cache["slots"].values():
        if "ssm" in sd:
            st = sd["ssm"]
            sd["ssm"] = SSMState(torch.repeat_interleave(st.h, group, dim=1),
                                 torch.repeat_interleave(st.conv, group, dim=1))
        if "cross" in sd:
            cr = sd["cross"]
            sd["cross"] = attn_mod.KVCache(torch.repeat_interleave(cr.k, group, dim=1),
                                           torch.repeat_interleave(cr.v, group, dim=1),
                                           cr.k_scale, cr.v_scale)
    if "src_lengths" in cache:
        cache["src_lengths"] = torch.repeat_interleave(cache["src_lengths"], group, dim=0)
    if "block_tables" in cache:
        ii = (torch.arange(n, device=device) // group)[:, None]
        jj = torch.arange(w, device=device)[None, :]
        own = pool0 + torch.arange(n, device=device)[:, None] * priv + (jj - fp)
        cache["block_tables"] = torch.where(jj < fp, ii * fp + jj, own).to(torch.int32)
    cache["lengths"] = torch.repeat_interleave(cache["lengths"], group, dim=0)
    return cache


def _collect_kv_scales(cache: dict) -> dict:
    return {name: {"k_scale": slot["kv"].k_scale.clone(),
                   "v_scale": slot["kv"].v_scale.clone()}
            for name, slot in cache["slots"].items() if "kv" in slot}


# ---------------------------------------------------------------------------
# scoring-side alignment helpers
# ---------------------------------------------------------------------------

def packed_sequences(traj: Trajectory) -> torch.Tensor:
    """(B, P+G): prompt[:L_i] immediately followed by the response — the
    teacher-forced scoring input (no PAD gap for short prompts)."""
    b, p = traj.prompt_tokens.shape
    g = traj.response_tokens.shape[1]
    dev = traj.prompt_tokens.device
    pos = torch.arange(p + g, device=dev)[None, :]
    lens = traj.prompt_lengths[:, None].long()
    prompt_part = torch.gather(
        traj.prompt_tokens, 1, torch.clamp(pos, 0, p - 1).expand(b, p + g))
    resp_idx = torch.clamp(pos - lens, 0, g - 1)
    resp_part = torch.gather(traj.response_tokens, 1, resp_idx)
    return torch.where(pos < lens, prompt_part, resp_part)


def gather_response_logps(score_logps: torch.Tensor, traj: Trajectory
                          ) -> torch.Tensor:
    """Align scoring-model logprobs (B, T-1) with rollout response tokens.

    The response token k of row i sits at packed position L_i + k and is
    predicted at logprob index L_i + k - 1.  Returns (B, G) masked like
    `traj.response_mask`."""
    g = traj.response_mask.shape[1]
    dev = score_logps.device
    idx = traj.prompt_lengths[:, None].long() + torch.arange(g, device=dev)[None, :] - 1
    idx = torch.clamp(idx, 0, score_logps.shape[1] - 1)
    return torch.gather(score_logps, 1, idx) * traj.response_mask
