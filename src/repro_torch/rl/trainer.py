"""The RL trainer: the DAPO loop with FP8 rollout (port of
`repro.rl.trainer`, paper Fig 1).

Per step:
  1. weight sync  — quantize the BF16 policy into rollout params (kernel 2)
  2. rollout      — n responses per prompt through `generate` (kernels 1,
                    3 and 4); the rollout params are freed right after it.
                    With `rollout_backend="fleet"` the sync is a versioned
                    push (`WeightSyncer.push_to`) into N `ServingEngine`
                    replicas behind a `ServingFrontend`, the rollout runs
                    through them, every token carries the weight version
                    that sampled it, and the loss applies versioned TIS/MIS
  3. reward       — the rule-based verifier (host)
  4. advantage    — group-relative (GRPO) + the DAPO dynamic-sampling mask
  5. update       — token-level DAPO loss with TIS/MIS correction: a
                    teacher-forced bf16 scoring pass (`token_logprobs`,
                    each layer recomputed in the backward), autograd,
                    then the reference's AdamW (`optim.adamw`, in place)
  6. calibration  — trainer-side KV scales for the next rollout (optional)
  7. telemetry and checkpoint

Sync and rollout run under `torch.no_grad()`; the update turns on
`requires_grad` for the params' leaves only while it differentiates.
Randomness comes from one `torch.Generator` on the trainer's device (the
reference's `jax.random` key cannot be reproduced); each fleet replica
samples from its own, seeded `seed + 100 + i`.  The fleet keeps the live
weight version between steps (its quantized linears; the other leaves
are the training params themselves).

Precision, as in the reference: the rollout runs under `rl.precision`
(with `quantize_attention` the attention math is QDQ'd: `generate` and
the fleet's engines take the plain attention branch, see
`kernels.config.KernelConfig.resolve`); the scoring pass takes no
precision, so the backward is bf16 and `fp8_training` (E2E_FP8) reaches
no linear here: an E2E_FP8 step equals a FULL_FP8_ROLLOUT step.  An MoE
model adds `moe_aux_coef` x the MoE layers' load-balancing losses to the
loss (stat `moe_aux_loss`).  Under `rollout_router_replay` the batch
rollout records the routing (`Trajectory.routing`) and, as in the
reference, the update does not replay it: the scoring pass routes on its
own (the fleet backend records none).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer, flatten_tree
from repro_torch.core.fp8_params import tree_leaves
from repro_torch.core.precision import PrecisionConfig
from repro_torch.data import PromptPipeline
from repro_torch.models.transformer import Transformer, token_logprobs
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as opt_init
from repro_torch.optim import update as opt_update
from repro_torch.rl import calibration as calib_mod
from repro_torch.rl import rewards as rewards_mod
from repro_torch.rl.advantage import dynamic_sampling_mask, group_advantages, overlong_penalty
from repro_torch.rl.loss import LossConfig, dapo_token_loss
from repro_torch.rl.rollout import (
    SamplerConfig,
    Trajectory,
    gather_response_logps,
    generate,
    packed_sequences,
)
from repro_torch.rl.weight_sync import WeightSyncer, sync_policy_weights
from repro_torch.serving import ServingEngine, ServingFrontend

# Fixed one-hot width for the fleet's versioned TIS: with one weight push
# per train step every batch sees one or two versions, so 4 slots is
# generous headroom.  Versions are rebased to the batch's minimum before
# entering the loss.
_VERSION_SLOTS = 4


@dataclasses.dataclass(frozen=True)
class RLConfig:
    precision: PrecisionConfig
    prompt_batch: int = 8
    n_per_prompt: int = 4
    max_prompt_len: int = 12
    max_new_tokens: int = 12
    temperature: float = 1.0
    seed: int = 0
    optimizer: AdamWConfig = AdamWConfig(lr=3e-4, b2=0.98, grad_clip=1.0)
    loss: LossConfig = LossConfig()
    moe_aux_coef: float = 1e-2
    dynamic_sampling: bool = True
    overlong_shaping: bool = False
    calibration: str = "inference"       # "inference" | "trainer"
    # rollout backend: "batch" = whole-batch `generate` (rl/rollout.py),
    # "fleet" = the live-updating serving fleet (serving/frontend.py) —
    # N engine replicas, per-token weight-version attribution, versioned
    # TIS in the loss
    rollout_backend: str = "batch"
    fleet_replicas: int = 2
    fleet_max_slots: int = 8
    fleet_block_size: int = 4
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 2

    @property
    def rollout_batch(self) -> int:
        return self.prompt_batch * self.n_per_prompt


def check_supported(rl: RLConfig) -> None:
    """Raise for what the port's trainer does not run yet."""
    if rl.rollout_backend not in ("batch", "fleet"):
        raise ValueError(f"rollout_backend {rl.rollout_backend!r}")
    if rl.rollout_backend == "fleet" and rl.fleet_replicas < 1:
        raise ValueError(f"fleet_replicas {rl.fleet_replicas} < 1")
    if rl.calibration not in ("inference", "trainer"):
        raise ValueError(f"calibration {rl.calibration!r}")


def _fill(like, it):
    """`like`'s dict structure with leaves taken in order from `it`."""
    if isinstance(like, dict):
        return {k: _fill(v, it) for k, v in like.items()}
    return next(it)


def _clock(device) -> float:
    """Host seconds, after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class RLTrainer:
    def __init__(self, cfg, rl: RLConfig, params=None, metrics_sink=None,
                 device=None):
        """cfg: a decoder-only dense or MoE ArchConfig.  Runs on `device` (CUDA
        when not given; without CUDA that raises); `params`, if given,
        must live there.  metrics_sink: an object with a ``write(dict)``
        method; every `train_step()` writes its metrics there."""
        check_supported(rl)
        self.cfg = cfg
        self.rl = rl
        self.device = resolve_device(device)
        self.metrics_sink = metrics_sink
        self.generator = torch.Generator(device=self.device).manual_seed(rl.seed)
        if params is None:
            params = Transformer(cfg, self.device).init_params(rl.seed + 1)
        elif params["emb"].device != self.device:
            raise ValueError(f"params on {params['emb'].device}, trainer on {self.device}")
        self.params = params
        self.opt_state = opt_init(self.params, rl.optimizer)
        self.pipeline = PromptPipeline(rl.prompt_batch, rl.max_prompt_len,
                                       seed=rl.seed + 2)
        self.sampler = SamplerConfig(max_new_tokens=rl.max_new_tokens,
                                     temperature=rl.temperature)
        self.step_idx = 0
        self.ckpt = Checkpointer(rl.ckpt_dir, keep=rl.ckpt_keep) \
            if rl.ckpt_dir else None
        self.kv_scales = None            # trainer-side calibration state
        self.last_update_batch = None    # the last step's update batch
        self.versioned = rl.rollout_backend == "fleet"
        if self.versioned:
            self.syncer = WeightSyncer(self._rollout_precision())
            self._fleet = None           # built at the first weight push

    # ------------------------------------------------------------------
    def _rollout_precision(self) -> PrecisionConfig:
        if self.rl.calibration == "trainer":
            return calib_mod.trainer_side_precision(self.rl.precision)
        return self.rl.precision

    def _loss(self, params, batch):
        rl = self.rl
        logp_all, aux = _score_logprobs(
            params, {"tokens": batch["packed_tokens"]}, self.cfg)
        resp_logps = _gather(logp_all, batch)
        loss, stats = dapo_token_loss(
            logp_theta=resp_logps,
            logp_old=resp_logps.detach(),
            logp_rollout=batch["rollout_logps"],
            advantages=batch["advantages"],
            mask=batch["mask"],
            precision=rl.precision,
            cfg=rl.loss,
            metrics_mask=batch["response_mask"],
            token_versions=batch["token_versions"] if self.versioned else None,
            num_versions=_VERSION_SLOTS if self.versioned else 1,
        )
        if aux["moe"]:
            aux_loss = sum(v["aux_loss"].mean() for v in aux["moe"].values())
            loss = loss + rl.moe_aux_coef * aux_loss
            stats["moe_aux_loss"] = aux_loss
        return loss, stats

    @torch.no_grad()
    def batch_loss(self, params, batch):
        """(loss, stats) of `batch` under `params`, without gradients."""
        return self._loss(params, batch)

    def loss_and_grads(self, params, batch):
        """The DAPO loss of `batch` under `params`, its stats (the
        reference's keys) and the gradient tree (bf16, like the params)."""
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, stats = self._loss(params, batch)
                grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), stats, _fill(params, iter(grads))

    def update_fn(self, params, opt_state, batch, timings: Optional[dict] = None):
        """(params, opt_state, batch) -> (params, opt_state, stats), the
        reference's update; params and moments change in place.  With
        `timings`, puts the ms of the scoring pass + backward and of the
        optimizer there (device synchronized around each)."""
        t0 = _clock(self.device)
        loss, stats, grads = self.loss_and_grads(params, batch)
        t1 = _clock(self.device)
        params, opt_state, opt_stats = opt_update(params, grads, opt_state,
                                                  self.rl.optimizer)
        del grads
        if timings is not None:
            timings.update(score_backward_ms=(t1 - t0) * 1e3,
                           optimizer_ms=(_clock(self.device) - t1) * 1e3)
        stats.update(opt_stats)
        stats["loss"] = loss
        return params, opt_state, stats

    # ------------------------------------------------------------------
    def rollout(self, batch, precision: PrecisionConfig):
        """Weight sync + GRPO group `generate` of a prompt batch under
        `precision`: (trajectory, sync stats, rollout seconds).  The
        rollout params live only inside this call."""
        rl = self.rl
        page_size = 8
        with torch.no_grad():
            rollout_params, sync_stats = sync_policy_weights(self.params, precision)
            t_roll = _clock(self.device)
            traj = generate(
                rollout_params, batch.tokens, batch.lengths, self.generator,
                self.cfg, precision, self.sampler,
                kv_scales=self.kv_scales, page_size=page_size,
                num_samples_per_prompt=rl.n_per_prompt,
                shared_prefix_blocks=int(np.min(batch.lengths)) // page_size,
                want_routing=rl.precision.rollout_router_replay,
                device=self.device)
            del rollout_params
            rollout_s = _clock(self.device) - t_roll
        return traj, sync_stats, rollout_s

    # ------------------------------------------------------------------
    # fleet rollout backend
    # ------------------------------------------------------------------
    def _build_fleet(self, rollout_params, version: int):
        """N engine replicas behind one streaming front-end.  Built once,
        at the first weight push; later pushes hot-swap in place."""
        rl = self.rl
        engines = [
            ServingEngine(
                rollout_params, self.cfg, self._rollout_precision(),
                max_slots=rl.fleet_max_slots,
                max_seq_len=rl.max_prompt_len + rl.max_new_tokens,
                temperature=rl.temperature,
                seed=rl.seed + 100 + i,     # replicas sample independently
                prompt_pad=max(16, rl.max_prompt_len),
                block_size=rl.fleet_block_size,
                want_logps=True,
                weight_version=version,
                device=self.device,
            )
            for i in range(rl.fleet_replicas)
        ]
        return ServingFrontend(engines)

    def fleet_rollout(self, batch):
        """Versioned push + GRPO group rollout through the fleet:
        (trajectory, token versions rebased to the batch's minimum, sync
        stats, rollout seconds).  The first push builds the fleet; later
        ones go through `push_to`, which mints the version only once the
        fleet accepts the install, so a failed sync never desyncs trainer
        and fleet.  The stats' `push_ms` is the whole push: the sync, then
        the install (or the fleet's construction)."""
        with torch.no_grad():
            t_push = _clock(self.device)
            if self._fleet is None:
                vw = self.syncer.push(self.params)
                self._fleet = self._build_fleet(vw.params, vw.version)
            else:
                vw = self.syncer.push_to(self.params, self._fleet)
            sync_stats = dict(vw.stats)
            del vw                   # the fleet holds the live version
            t_roll = _clock(self.device)
            sync_stats["push_ms"] = (t_roll - t_push) * 1e3
            traj, versions = self._fleet_rollout(batch)
            rollout_s = _clock(self.device) - t_roll
        return traj, versions, sync_stats, rollout_s

    def _fleet_rollout(self, batch):
        """GRPO group rollout through the fleet.  Submission order matches
        the batch backend's layout: sample s of prompt i is row
        i * n_per_prompt + s, so rewards/advantages group identically."""
        rl = self.rl
        g = rl.max_new_tokens
        rids = []
        lengths_np = np.asarray(batch.lengths)
        tokens_np = np.asarray(batch.tokens)
        for i in range(len(lengths_np)):
            ids = tokens_np[i, : lengths_np[i]]
            for _ in range(rl.n_per_prompt):
                rids.append(self._fleet.submit(ids, max_new=g))
        report = self._fleet.run(max_steps=100_000)
        if report.stalled:
            raise RuntimeError(
                "fleet rollout stalled — replica KV pools too small for "
                "the prompt batch (raise fleet_max_slots or shrink "
                "prompt_batch)")
        by_rid = {o.rid: o for o in report.outputs}
        self._fleet.forget_finished()
        b = len(rids)
        resp = np.full((b, g), self.sampler.pad_id, np.int32)
        mask = np.zeros((b, g), np.float32)
        logps = np.zeros((b, g), np.float32)
        versions = np.zeros((b, g), np.int32)
        rlens = np.zeros((b,), np.int32)
        for r, rid in enumerate(rids):
            out = by_rid[rid].output
            n = len(out.token_ids)
            resp[r, :n] = out.token_ids
            mask[r, :n] = 1.0
            logps[r, :n] = out.logps
            versions[r, :n] = out.versions
            rlens[r] = n
        dev = self.device
        traj = Trajectory(
            prompt_tokens=torch.as_tensor(
                np.repeat(tokens_np, rl.n_per_prompt, axis=0), device=dev),
            prompt_lengths=torch.as_tensor(
                np.repeat(lengths_np, rl.n_per_prompt), device=dev),
            response_tokens=torch.as_tensor(resp, device=dev),
            response_mask=torch.as_tensor(mask, device=dev),
            rollout_logps=torch.as_tensor(logps, device=dev),
            response_lengths=torch.as_tensor(rlens, device=dev),
            routing=None, kv_scales=None)
        # rebase absolute weight versions to the batch minimum so they fit
        # the loss's one-hot width (_VERSION_SLOTS)
        base = int(versions[mask > 0].min()) if mask.any() else 0
        rel = np.where(mask > 0, versions - base, 0).astype(np.int32)
        return traj, torch.as_tensor(rel, device=dev)

    def make_update_batch(self, traj: Trajectory, rewards: np.ndarray,
                          token_versions: Optional[torch.Tensor] = None) -> dict:
        """The update's inputs for a trajectory and its rewards: packed
        sequences, GRPO advantages, the loss mask (dynamic sampling on
        when configured), the raw response mask and, for the fleet, each
        token's weight version."""
        rl = self.rl
        rewards_t = torch.as_tensor(rewards, device=self.device)
        adv = group_advantages(rewards_t, rl.n_per_prompt)
        mask = traj.response_mask
        if rl.dynamic_sampling:
            mask = mask * dynamic_sampling_mask(rewards_t, rl.n_per_prompt)[:, None]
        batch = {
            "packed_tokens": packed_sequences(traj),
            "prompt_lengths": traj.prompt_lengths,
            "rollout_logps": traj.rollout_logps,
            "advantages": adv,
            "mask": mask,
            "response_mask": traj.response_mask,
        }
        if token_versions is not None:
            batch["token_versions"] = token_versions
        return batch

    def train_step(self) -> dict:
        rl, cfg = self.rl, self.cfg
        t_start = time.perf_counter()

        # 1. prompts
        batch = self.pipeline.next_batch()
        problems = [p for p in batch.problems for _ in range(rl.n_per_prompt)]

        # 2-3. weight sync, then the GRPO group rollout: `generate` with the
        # prefix shared over the shortest prompt's whole pages, or a
        # versioned push into the fleet and a rollout through it
        token_versions = None
        if self.versioned:
            traj, token_versions, sync_stats, rollout_s = self.fleet_rollout(batch)
        else:
            traj, sync_stats, rollout_s = self.rollout(batch, self._rollout_precision())
        gen_tokens = float(traj.response_mask.sum())

        # 4. rewards + advantages
        resp = traj.response_tokens.cpu().numpy()
        rlen = traj.response_lengths.cpu().numpy()
        rewards = rewards_mod.batch_rewards(problems, resp, rlen)
        if rl.overlong_shaping:
            rewards = rewards + overlong_penalty(
                torch.as_tensor(rlen), rl.max_new_tokens).numpy().astype(np.float32)
        update_batch = self.make_update_batch(traj, rewards, token_versions)

        # 5. update
        timings = {}
        self.params, self.opt_state, stats = self.update_fn(
            self.params, self.opt_state, update_batch, timings)
        self.last_update_batch = update_batch

        # 6. trainer-side calibration for the *next* rollout (paper §B.2);
        # an attention-free model has no KV to calibrate
        if rl.calibration == "trainer" and not cfg.attention_free:
            calib = {
                "tokens": update_batch["packed_tokens"][: rl.prompt_batch],
                "lengths": (traj.prompt_lengths
                            + traj.response_lengths)[: rl.prompt_batch],
            }
            self.kv_scales = calib_mod.calibrate_kv_scales(self.params, calib, cfg)

        self.step_idx += 1
        metrics = stats_to_host(stats)
        metrics.update(
            step=self.step_idx,
            reward_mean=float(rewards.mean()),
            accuracy=float((rewards >= 1.0).mean()),
            response_len_mean=float(rlen.mean()),
            rollout_s=rollout_s,
            rollout_tokens_per_s=gen_tokens / max(rollout_s, 1e-9),
            step_s=time.perf_counter() - t_start,
            sync_ms=sync_stats.get("sync_ms", 0.0),
            **timings,
        )
        if self.versioned:
            metrics["push_ms"] = sync_stats["push_ms"]
        if self.metrics_sink is not None:
            self.metrics_sink.write(metrics)

        # 7. checkpoint
        if self.ckpt and self.step_idx % rl.ckpt_every == 0:
            self.save_checkpoint()
        return metrics

    # ------------------------------------------------------------------
    def evaluate(self, n_problems: int = 64, seed: int = 9999) -> float:
        """Greedy decoding accuracy on held-out problems (AIME24 analogue)."""
        batch = PromptPipeline(n_problems, self.rl.max_prompt_len, seed=seed).next_batch()
        prec = self._rollout_precision()
        sampler = dataclasses.replace(self.sampler, temperature=0.0)
        with torch.no_grad():
            rollout_params, _ = sync_policy_weights(self.params, prec)
            traj = generate(rollout_params, batch.tokens, batch.lengths, None,
                            self.cfg, prec, sampler, kv_scales=self.kv_scales,
                            device=self.device)
        return rewards_mod.exact_match_accuracy(
            batch.problems, traj.response_tokens.cpu().numpy(),
            traj.response_lengths.cpu().numpy())

    # ------------------------------------------------------------------
    def _ckpt_tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "key": self.generator.get_state()}

    def save_checkpoint(self):
        assert self.ckpt is not None
        self.ckpt.save(self.step_idx, self._ckpt_tree(), extra={
            "pipeline": self.pipeline.state_dict(),
            "step_idx": self.step_idx,
        })

    def restore_checkpoint(self) -> bool:
        """Resume from the latest committed checkpoint (fault recovery):
        params, optimizer state and kv scales stay where they live and
        take the checkpoint's values."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        like = self._ckpt_tree()
        tree, extra, _ = self.ckpt.restore(like)
        with torch.no_grad():     # the key's leaf in `like` is a scratch copy
            for (_, dst), (_, src) in zip(flatten_tree(like), flatten_tree(tree)):
                dst.copy_(src)
        self.generator.set_state(tree["key"])
        self.pipeline.load_state_dict(extra["pipeline"])
        self.step_idx = extra["step_idx"]
        return True


def stats_to_host(stats: dict) -> dict:
    """Stats tensors -> floats (0-dim) and lists, in one device copy."""
    names = list(stats)
    flat = torch.cat([stats[k].detach().float().reshape(-1) for k in names]).cpu()
    out, i = {}, 0
    for k in names:
        n = stats[k].numel()
        vals = flat[i:i + n].tolist()
        out[k] = vals if stats[k].dim() else vals[0]
        i += n
    return out


# ---------------------------------------------------------------------------
# scoring helpers
# ---------------------------------------------------------------------------

def _score_logprobs(params, inputs, cfg):
    return token_logprobs(params, inputs, cfg)


def _gather(logp_all, batch):
    tr = Trajectory(
        prompt_tokens=batch["packed_tokens"],
        prompt_lengths=batch["prompt_lengths"],
        response_tokens=batch["rollout_logps"],   # only the shape is used
        response_mask=batch["response_mask"],
        rollout_logps=batch["rollout_logps"],
        response_lengths=None, routing=None, kv_scales=None)
    return gather_response_logps(logp_all, tr)
