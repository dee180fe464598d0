"""RL training launcher (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --reduced --device cpu --steps 2 --precision fp8-linear

Builds an `RLTrainer` (random weights from `--seed`) and runs `--steps`
train steps, printing each step's metrics as one JSON line; a greedy
evaluation runs at step 1 and every `--eval-every` steps.  With
`--metrics-out PATH` every step's metrics are also streamed there as JSONL
(`obs.JsonlSink`), stamped with `--run-id` when given.  Runs on CUDA
unless `--device` says otherwise.  `--precision` defaults to the
reference's `fp8` (FULL_FP8_ROLLOUT: the rollout's attention math QDQ'd
too); `e2e-fp8` (E2E_FP8) trains exactly as `fp8` does, because the
scoring pass takes no precision, as in the reference; `default`, a
port-only spelling, is `PrecisionConfig()`.  `--rrr` (rollout router
replay) records an MoE model's routing in the rollout; as in the
reference, the update does not replay it.  `--arch` takes any name of the
port's registry, the MoE models (qwen3-30b-a3b, granite-moe-3b-a800m,
grok-1-314b) included.  `--fp8-moments` (port-only) keeps AdamW's moments
in fp8, as a full-width model on one card needs.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.core.precision import (
    BF16_ROLLOUT,
    E2E_FP8,
    FP8_KV_ONLY_ROLLOUT,
    FP8_LINEAR_ROLLOUT,
    FULL_FP8_ROLLOUT,
    PrecisionConfig,
    RolloutCorrection,
)
from repro_torch.data import tasks
from repro_torch.obs import JsonlSink
from repro_torch.optim import AdamWConfig
from repro_torch.rl import RLConfig, RLTrainer

PRECISIONS = {
    "bf16": BF16_ROLLOUT,
    "default": PrecisionConfig(),
    "fp8": FULL_FP8_ROLLOUT,
    "fp8-linear": FP8_LINEAR_ROLLOUT,
    "fp8-kv": FP8_KV_ONLY_ROLLOUT,
    "e2e-fp8": E2E_FP8,
}


def build_trainer(args, metrics_sink=None) -> RLTrainer:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=tasks.VOCAB_SIZE,
                          n_layers=args.layers, d_model=args.d_model)
    precision = PRECISIONS[args.precision]
    correction = RolloutCorrection.TIS if args.tis else (
        RolloutCorrection.MIS if args.mis else RolloutCorrection.NONE)
    precision = precision.replace(correction=correction,
                                  rollout_router_replay=args.rrr)
    rl = RLConfig(
        precision=precision,
        prompt_batch=args.prompt_batch,
        n_per_prompt=args.n_per_prompt,
        max_new_tokens=args.max_new_tokens,
        optimizer=AdamWConfig(lr=args.lr, b2=0.98, grad_clip=1.0,
                              fp8_moments=args.fp8_moments),
        calibration=args.calibration,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        seed=args.seed,
    )
    return RLTrainer(cfg, rl, metrics_sink=metrics_sink, device=args.device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-8b",
                    help="a name of repro_torch.configs.REGISTRY (dense or MoE)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--precision", choices=sorted(PRECISIONS), default="fp8")
    ap.add_argument("--tis", action="store_true", default=True)
    ap.add_argument("--no-tis", dest="tis", action="store_false")
    ap.add_argument("--mis", action="store_true")
    ap.add_argument("--rrr", action="store_true")
    ap.add_argument("--calibration", choices=("inference", "trainer"),
                    default="inference")
    ap.add_argument("--prompt-batch", type=int, default=8)
    ap.add_argument("--n-per-prompt", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="stream per-step metrics as JSONL (one step per "
                         "line, written as each step completes — incl. "
                         "mismatch-KL, per-version KL breakdowns and "
                         "TIS/MIS weight ESS)")
    ap.add_argument("--run-id", default=None, metavar="ID",
                    help="stamp this id on every metrics row; launch the "
                         "serving side (repro_torch.launch.serve --run-id) "
                         "with the SAME id to join trainer steps to the "
                         "serving steps that produced their rollout batches")
    ap.add_argument("--fp8-moments", action="store_true",
                    help="keep AdamW's moments in fp8 (a port-only flag: the "
                         "f32 moments of full-width qwen3-8b do not fit one "
                         "80 GB card beside its params and gradients)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    sink = JsonlSink(args.metrics_out, run_id=args.run_id) \
        if args.metrics_out else None
    try:
        trainer = build_trainer(args, metrics_sink=sink)
        if args.resume and trainer.restore_checkpoint():
            print(f"resumed from step {trainer.step_idx}")

        history = []
        for _ in range(args.steps):
            m = trainer.train_step()
            history.append(m)
            if m["step"] % args.eval_every == 0 or m["step"] == 1:
                m["eval_accuracy"] = trainer.evaluate(n_problems=32)
            print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                              for k, v in m.items()}), flush=True)
    finally:
        if sink is not None:
            sink.close()
    return history


if __name__ == "__main__":
    main()
