"""Serving launcher: continuous batching with FP8 weights and an FP8 KV
cache (port of `repro.launch.serve`, the single-engine path).

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --prefill-chunk 4 --requests 8

Random weights from `--seed`, synced to the rollout precision, then one
`ServingEngine` over the launcher's arithmetic-prompt trace; prints the
JSON report.  Runs on CUDA unless `--device` says otherwise;
`--kernel-config` defaults to `all`, so a run on the card goes through
the paged decode and chunked-prefill kernels.  The fleet (`--replicas`,
`--update-every`), tracing (`--trace-out`, `--events-out`, `--run-id`)
and chaos flags of the reference come with the port's front-end and
observability (ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.precision import (
    BF16_ROLLOUT,
    FP8_KV_ONLY_ROLLOUT,
    FP8_LINEAR_ROLLOUT,
    FULL_FP8_ROLLOUT,
    PrecisionConfig,
)
from repro_torch.data import tasks
from repro_torch.models import Transformer
from repro_torch.rl import sync_policy_weights
from repro_torch.serving import (
    EVICTION_POLICIES,
    ServingEngine,
    SpecConfig,
    StepBudget,
    kv_bytes_per_token,
)

# the reference's rollout presets; "default" is PrecisionConfig() (W8A8
# linears + FP8 KV, the paper's recipe).  "fp8" quantizes the attention
# math too, which the port does not do yet: the engine raises for it.
PRECISIONS = {
    "bf16": BF16_ROLLOUT,
    "default": PrecisionConfig(),
    "fp8": FULL_FP8_ROLLOUT,
    "fp8-linear": FP8_LINEAR_ROLLOUT,
    "fp8-kv": FP8_KV_ONLY_ROLLOUT,
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--precision", choices=sorted(PRECISIONS), default="default")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--budget-tokens", type=int, default=None)
    ap.add_argument("--block-size", type=int, default=4,
                    help="paged KV block size in bf16-KV tokens (fp8 KV "
                         "blocks hold twice as many)")
    ap.add_argument("--admission", choices=("reserve", "ondemand"),
                    default="reserve",
                    help="reserve: worst-case block reservation; "
                         "ondemand: vLLM-style growth + swap preemption")
    ap.add_argument("--eviction", choices=sorted(EVICTION_POLICIES),
                    default="youngest",
                    help="preemption victim-selection policy")
    ap.add_argument("--host-kv-blocks", type=int, default=0,
                    help="host-tier reservation (blocks) for demoted "
                         "cache blocks (0 = drop on evict)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill width in tokens (default: "
                         "one-shot batch-1 prefill)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prefill tokens scheduled per engine step")
    ap.add_argument("--kernel-config",
                    choices=("off", "decode", "prefill", "all"),
                    default="all",
                    help="attention hot path: decode routes the fused "
                         "decode through fp8_paged_decode_attention, "
                         "prefill routes chunks through "
                         "fp8_paged_prefill_attention, all does both, off "
                         "uses the table gather (plain versions on the CPU)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculative decoding: draft up to K tokens per "
                         "verify with the n-gram proposer")
    ap.add_argument("--shrink-at", type=int, default=None,
                    help="shrink the KV budget after N engine steps")
    ap.add_argument("--shrink-frac", type=float, default=0.5,
                    help="fraction of the budget kept after --shrink-at")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap


def run(argv=None) -> dict:
    """Parse `argv`, serve the trace, return the report as a dict."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=tasks.VOCAB_SIZE)
    precision = PRECISIONS[args.precision]
    params = Transformer(cfg, device).init_params(args.seed)
    rollout_params, sync_stats = sync_policy_weights(params, precision)
    budget = None
    if args.budget_tokens:
        budget = args.budget_tokens * max(kv_bytes_per_token(cfg, precision), 1)
    eng = ServingEngine(
        rollout_params, cfg, precision, max_slots=args.slots, max_seq_len=64,
        kv_budget_bytes=budget, seed=args.seed, block_size=args.block_size,
        admission=args.admission, eviction=args.eviction,
        host_kv_blocks=args.host_kv_blocks, prefill_chunk=args.prefill_chunk,
        step_budget=(StepBudget(prefill_tokens=args.prefill_budget)
                     if args.prefill_budget else None),
        kernel_config=args.kernel_config,
        spec=SpecConfig(num_draft_tokens=args.spec_k) if args.spec_k else None,
        device=device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(tasks.sample_problem(rng).prompt_ids, max_new=args.max_new, rid=i)
    t0 = time.perf_counter()
    if args.shrink_at is not None:
        full = eng.budget_tokens
        for _ in range(args.shrink_at):
            eng.step()
        eng.budget_tokens = int(full * args.shrink_frac)
    report = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    return {
        "device": str(device),
        "kernel_config": args.kernel_config,
        "completed": len(report.completed),
        "steps": report.steps,
        "preemptions": report.preemptions,
        "swap_outs": report.swap_outs,
        "swap_ins": report.swap_ins,
        "wasted_tokens": report.wasted_tokens,
        "prefill_chunks": report.prefill_chunks,
        "emitted_tokens": report.emitted_tokens,
        "mean_occupancy": round(report.mean_occupancy, 4),
        "useful_token_rate": round(report.useful_token_rate, 4),
        "spec_steps": report.spec_steps,
        "accepted_tokens": report.accepted_tokens,
        "spec_tokens_per_step": round(report.spec_tokens_per_step, 3),
        "stalled": report.stalled,
        "budget_tokens": report.budget_tokens,
        "kv_bytes_per_token": kv_bytes_per_token(cfg, precision),
        "state_bytes_per_request": eng.state_bytes,
        "sync_ms": round(sync_stats.get("sync_ms", 0.0), 2),
        "serve_wall_s": round(wall_s, 3),
    }


def main(argv=None):
    print(json.dumps(run(argv), indent=2))


if __name__ == "__main__":
    main()
