"""Serving launcher: continuous batching with FP8 weights and an FP8 KV
cache (port of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --prefill-chunk 4 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --replicas 2 --update-every 4 --crash-replica 0

Random weights from `--seed`, synced to the rollout precision, then one
`ServingEngine` over the launcher's arithmetic-prompt trace, or with
`--replicas N` / `--update-every K` a `ServingFrontend` over N replicas
that takes a freshly requantized weight version every K fleet steps (a
nudge of every weight by 1e-3 stands in for the trainer's step); prints
the JSON report.  `--trace-out` / `--events-out` put a `StepTracer` on
every replica and write a Chrome trace / the JSONL event log;
`--chaos-seed` or `--crash-replica` inject replica crashes that the
front-end fails over.  Runs on CUDA unless `--device` says otherwise.
`--precision` defaults to the reference's `fp8` (FULL_FP8_ROLLOUT: W8A8
linears, an FP8 KV cache and QDQ'd attention math).  Without
`--kernel-config` the port's default applies (`KernelConfig.resolve`):
the paged decode and chunked-prefill kernels, except under `fp8`, where
the attention takes the reference's default QDQ branch; an explicit
`--kernel-config all` keeps the kernels (which skip the QDQ, as the
reference's kernel branches do).  The report's `kernel_config` is the
resolved one.  `--arch` takes any name of the port's registry, the MoE
models (qwen3-30b-a3b, granite-moe-3b-a800m, grok-1-314b) included.
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
from repro_torch.kernels.config import KernelConfig
from repro_torch.models import Transformer
from repro_torch.obs import JsonlSink, StepTracer, chrome_trace
from repro_torch.rl import WeightSyncer, sync_policy_weights
from repro_torch.serving import (
    EVICTION_POLICIES,
    CrashFault,
    FaultInjector,
    FaultPlan,
    ServingEngine,
    ServingFrontend,
    SpecConfig,
    StepBudget,
    kv_bytes_per_token,
)

# the reference's rollout presets; "fp8" (the default, as in the
# reference) quantizes the attention math too; "default", a port-only
# spelling, is PrecisionConfig() (W8A8 linears + FP8 KV).
PRECISIONS = {
    "bf16": BF16_ROLLOUT,
    "default": PrecisionConfig(),
    "fp8": FULL_FP8_ROLLOUT,
    "fp8-linear": FP8_LINEAR_ROLLOUT,
    "fp8-kv": FP8_KV_ONLY_ROLLOUT,
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-8b",
                    help="a name of repro_torch.configs.REGISTRY (dense or MoE)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--precision", choices=sorted(PRECISIONS), default="fp8")
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
                    default=None,
                    help="attention hot path: decode routes the fused "
                         "decode through fp8_paged_decode_attention, "
                         "prefill routes chunks through "
                         "fp8_paged_prefill_attention, all does both, off "
                         "uses the table gather (plain versions on the "
                         "CPU); default: all, or off under --precision "
                         "fp8 (the reference's QDQ'd attention)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculative decoding: draft up to K tokens per "
                         "verify with the n-gram proposer")
    ap.add_argument("--shrink-at", type=int, default=None,
                    help="shrink the KV budget after N engine steps")
    ap.add_argument("--shrink-frac", type=float, default=0.5,
                    help="fraction of the budget kept after --shrink-at")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind the "
                         "streaming front-end (1 = the single-engine path)")
    ap.add_argument("--update-every", type=int, default=None,
                    help="hot-swap a fresh FP8 weight version into every "
                         "replica each N front-end steps (in-flight "
                         "requests keep running, their tokens carry the "
                         "version live at each step)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(Perfetto / chrome://tracing; enables the step "
                         "tracer)")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the raw typed event log as JSONL (one "
                         "event per line; enables the step tracer)")
    ap.add_argument("--run-id", default=None, metavar="ID",
                    help="stamp this id on every --events-out row; launch "
                         "the trainer (repro_torch.launch.train --run-id) "
                         "with the SAME id to join its metrics to these "
                         "serving steps")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="fleet chaos: a deterministic random crash "
                         "schedule from this seed (FaultPlan.random) in "
                         "every replica; the front-end fails work over "
                         "with exactly-once token delivery (needs "
                         "--replicas >= 2)")
    ap.add_argument("--crash-replica", type=int, default=None, metavar="I",
                    help="fleet chaos: crash exactly replica I (instead of "
                         "a --chaos-seed random schedule)")
    ap.add_argument("--crash-step", type=int, default=2, metavar="N",
                    help="engine-local step at which --crash-replica fires "
                         "(0-based count of step() entries)")
    ap.add_argument("--crash-transient", action="store_true",
                    help="make the --crash-replica crash transient: the "
                         "replica rejoins after --crash-down-steps once it "
                         "reinstalls the fleet weight version")
    ap.add_argument("--crash-down-steps", type=int, default=3,
                    help="front-end steps a transient crash stays down")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap


def _check_args(ap, args):
    """The reference's mutual-exclusion and range checks."""
    if args.chaos_seed is not None and args.crash_replica is not None:
        ap.error("--chaos-seed and --crash-replica are mutually "
                 "exclusive (random schedule vs one explicit crash)")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    chaos = args.chaos_seed is not None or args.crash_replica is not None
    if chaos and args.replicas < 2:
        ap.error("fault injection needs --replicas >= 2: a single-replica "
                 "fleet has nowhere to fail work over to")
    fleet = args.replicas > 1 or args.update_every is not None
    if fleet and args.shrink_at is not None:
        ap.error("--shrink-at applies to the single-engine path only")
    if args.crash_replica is not None and \
            not 0 <= args.crash_replica < args.replicas:
        ap.error(f"--crash-replica {args.crash_replica} out of range "
                 f"for --replicas {args.replicas}")


def _faults(args):
    """One shared injector: faults are keyed on each engine's
    replica_index (assigned by the front-end), so every replica sees the
    same plan and only its own entries fire."""
    if args.crash_replica is not None:
        return FaultInjector(FaultPlan(crashes=(
            CrashFault(replica=args.crash_replica, step=args.crash_step,
                       transient=args.crash_transient,
                       down_steps=args.crash_down_steps),)))
    if args.chaos_seed is not None:
        # max_step=4: short launcher runs drain in a handful of steps, so
        # schedule the crash early enough to actually fire
        return FaultInjector(FaultPlan.random(
            args.chaos_seed, replicas=args.replicas, max_step=4,
            down_steps=args.crash_down_steps))
    return None


def _write_traces(args, tracers):
    if args.events_out:
        with JsonlSink(args.events_out, run_id=args.run_id) as sink:
            for t in tracers:
                for e in t.events:
                    row = e.to_dict()
                    row.setdefault("replica", t.replica)
                    sink.write(row)
    if args.trace_out:
        rows = []
        for t in tracers:
            rows.extend(chrome_trace(t.events, replica=t.replica)["traceEvents"])
        with open(args.trace_out, "w") as f:
            json.dump({"traceEvents": rows}, f)


def _nudge(params):
    """The reference's stand-in for a gradient step: every weight times
    (1 + 1e-3).  That is under half a bf16 ulp, so bf16 weights come back
    unchanged (in the reference too): each push requantizes and mints a
    version over the same weights."""
    if isinstance(params, dict):
        return {k: _nudge(v) for k, v in params.items()}
    return params * (1.0 + 1e-3)


def _serve_fleet(args, frontend, params, precision, faults) -> dict:
    """Drive the fleet (with the weight pushes of --update-every), then
    drain it; the fleet half of the JSON report."""
    syncer = WeightSyncer(precision)
    steps = 0
    while frontend.has_work() and steps < 1000:
        if args.update_every and steps and steps % args.update_every == 0:
            # the RL reality: the trainer's policy moved, requantize and
            # push
            params = _nudge(params)
            frontend.update_weights(syncer.push(params))
        frontend.step()
        steps += 1
    report = frontend.run(max_steps=1000)      # drain + final accounting
    out = {
        "replicas": args.replicas,
        "completed": len(report.outputs),
        "steps": report.steps,
        "clock_tokens": report.clock_tokens,
        "emitted_tokens": report.emitted_tokens,
        "tokens_per_clock": round(report.tokens_per_clock, 4),
        "weight_version": report.weight_version,
        "versions_seen": sorted({v for o in report.outputs
                                 for v in o.output.versions}),
        "stalled": report.stalled,
        "kv_pressure": [round(p, 4) for p in report.kv_pressure],
    }
    if faults is not None:
        out["chaos"] = {
            "healthy_replicas": report.healthy_replicas,
            "quarantined_replicas": report.quarantined_replicas,
            "redispatches": report.redispatches,
            "replayed_tokens": report.replayed_tokens,
            "aborted": report.aborted,
            "delivered_tokens": report.delivered_tokens,
            "injected": dict(faults.injected),
        }
    if report.latency is not None:
        out["latency"] = report.latency
    return out


def run(argv=None) -> dict:
    """Parse `argv`, serve the trace, return the report as a dict."""
    ap = _parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
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
    fleet = args.replicas > 1 or args.update_every is not None
    tracing = args.trace_out is not None or args.events_out is not None
    tracers = []
    faults = _faults(args)

    def mk_engine(i: int) -> ServingEngine:
        tracer = None
        if tracing:
            tracer = StepTracer(replica=i)
            tracers.append(tracer)
        return ServingEngine(
            rollout_params, cfg, precision, tracer=tracer, faults=faults,
            max_slots=args.slots, max_seq_len=64, kv_budget_bytes=budget,
            seed=args.seed + i, block_size=args.block_size,
            admission=args.admission, eviction=args.eviction,
            host_kv_blocks=args.host_kv_blocks,
            prefill_chunk=args.prefill_chunk,
            step_budget=(StepBudget(prefill_tokens=args.prefill_budget)
                         if args.prefill_budget else None),
            kernel_config=args.kernel_config,
            spec=SpecConfig(num_draft_tokens=args.spec_k) if args.spec_k else None,
            device=device)

    target = (ServingFrontend([mk_engine(i) for i in range(args.replicas)])
              if fleet else mk_engine(0))
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        target.submit(tasks.sample_problem(rng).prompt_ids, max_new=args.max_new, rid=i)
    t0 = time.perf_counter()
    if fleet:
        # only the replicas hold version 0 now, so an update frees it
        del rollout_params
        out = _serve_fleet(args, target, params, precision, faults)
    else:
        out = _serve_engine(args, target)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    _write_traces(args, tracers)
    out.update(device=str(device),
               kernel_config=KernelConfig.resolve(args.kernel_config, precision).name,
               kv_bytes_per_token=kv_bytes_per_token(cfg, precision),
               sync_ms=round(sync_stats.get("sync_ms", 0.0), 2),
               serve_wall_s=round(wall_s, 3))
    return out


def _serve_engine(args, eng) -> dict:
    """Run the single engine (with the --shrink-at budget cut); the
    engine half of the JSON report."""
    if args.shrink_at is not None:
        full = eng.budget_tokens
        for _ in range(args.shrink_at):
            eng.step()
        eng.budget_tokens = int(full * args.shrink_frac)
    report = eng.run()
    out = {
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
        "state_bytes_per_request": eng.state_bytes,
    }
    if report.latency is not None:
        out["latency"] = report.latency
    return out


def main(argv=None):
    print(json.dumps(run(argv), indent=2))


if __name__ == "__main__":
    main()
