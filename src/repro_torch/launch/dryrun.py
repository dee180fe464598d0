"""Multi-pod dry run of the port (port of `repro.launch.dryrun`).

For every (architecture x input-shape x mesh) cell:
  * open a fake process group of the production mesh's size (16x16
    single pod, 256 ranks; 2x16x16 multi-pod, 512) in this process —
    `torch.testing._internal.distributed.fake_pg`: collectives return at
    once and move nothing — and build the mesh on it;
  * build the cell's step (train_step / prefill_step / serve_step) under
    `ShardingRules` and `attention_impl`, as the reference's
    `_lower_and_compile` does, and run it once on meta DTensors: rank 0's
    shards, shapes and dtypes only, nothing allocated;
  * memory (replacing XLA's `memory_analysis()`): `argument_bytes` and
    `output_bytes` are rank 0's local shard bytes of the params, optimizer
    state, batch and cache going in and of what comes out,
    `alias_bytes` those of what the reference donates (train: params and
    optimizer state; decode: the cache), `temp_bytes` the peak of the
    bytes the step allocated and had not yet freed, less what it still
    holds at its end (its new outputs), tracked by the counting dispatch
    mode (`roofline.analysis.count_step`);
  * costs: `count_step`'s FLOPs, bytes and collectives of rank 0 and the
    roofline at the H100's peaks (`roofline.analysis`).  The port's eager
    loop runs every layer, so the counts need no R=1 / R=2 fit (the
    reference's `_lin` / `_extrapolate`); the record says so under
    "accounting";
  * write one JSON per cell under the git-ignored `build/dryrun/` (or
    `--out`), never into `benchmarks/`.

Each cell runs in its own process (`run_cell_subprocess`): the fake group
is process-wide, and a group of 256 or 512 ranks changes what
`launch.mesh.make_production_mesh` returns.

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all                # every cell, both meshes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULTS_DIR = os.path.join(REPO, "build", "dryrun")

# precision of the paper-faithful baseline: FP8 rollout (linears + KV,
# attention QDQ'd: FULL_FP8_ROLLOUT), BF16 train
BASE_PRECISION = "fp8"

ACCOUNTING = ("eager: the step's Python loop runs every layer once, so the "
              "counts are the whole step's (no R=1 / R=2 fit)")


def cell_list():
    """All cells, multi-pod first, small archs first (the reference's
    order)."""
    from repro_torch.configs import ASSIGNED
    by_size = sorted(ASSIGNED, key=lambda n: ASSIGNED[n].param_count())
    cells = []
    for mesh in ("multi", "single"):
        for name in by_size:
            for shape in ASSIGNED[name].shapes():
                cells.append((name, shape.name, mesh))
    return cells


def result_path(arch, shape, mesh, precision=BASE_PRECISION, tag="", out_dir=None):
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}__{precision}{suffix}.json")


# ---------------------------------------------------------------------------
# single-cell execution (in-process)
# ---------------------------------------------------------------------------

def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in `tree` (dicts,
    `QuantizedTensor`s, the caches' dataclasses, host values skipped)."""
    import dataclasses

    import torch

    from repro_torch import is_dtensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_local_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if is_dtensor(tree) else tree
        return t.numel() * t.element_size()
    return 0


def _cell_inputs(cfg, shape, rules, precision, opt_cfg):
    """(step, args, donated arg indices) of one cell on meta DTensors."""
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw

    mesh = rules.mesh
    if shape.kind == "train":
        step = steps_mod.make_train_step(cfg, None, opt_cfg, rules=rules)
        p_specs = steps_mod.param_specs(cfg)
        params = distribute(p_specs, rules.params(p_specs), mesh)
        return step, (params, adamw.init(params, opt_cfg),
                      steps_mod.input_specs(cfg, shape)), (0, 1)
    p_specs = steps_mod.param_specs(cfg, precision)
    params = distribute(p_specs, rules.params(p_specs), mesh)
    batch = steps_mod.input_specs(cfg, shape)
    if shape.kind == "prefill":
        return steps_mod.make_prefill_step(cfg, shape, precision, "meta", rules=rules), \
            (params, batch), ()
    cache = steps_mod.shard_cache(cfg, shape.global_batch, shape.seq_len, precision, rules,
                                  src_len=shape.seq_len if cfg.is_encdec else 0,
                                  device="meta")
    cache["max_length"] = shape.seq_len - 1       # a full cache: one step left
    return steps_mod.make_serve_step(cfg, precision, "meta", rules=rules), \
        (params, batch["tokens"], cache), (2,)


def _batch_bytes(batch, rules) -> int:
    """Rank 0's shard bytes of a batch under `rules.batch_spec` (the
    reference's in_shardings)."""
    import math

    from repro_torch.distributed.sharding import shard_shape
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    specs = rules.batch_spec(batch)
    return sum(math.prod(shard_shape(rules.mesh, v.shape, specs[k])) * v.element_size()
               for k, v in batch.items())


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             precision_name: str = BASE_PRECISION, tag: str = "",
             overrides: dict | None = None, cfg=None) -> dict:
    """One cell in this process, on a fake process group of the mesh's
    size that it opens and closes.  `cfg` (an `ArchConfig`, e.g. a
    `reduced()` one for a quick CPU check) replaces `arch`'s registry
    config."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.core.precision import BF16_ROLLOUT, FP8_LINEAR_ROLLOUT, FULL_FP8_ROLLOUT
    from repro_torch.distributed.sharding import ShardingRules, register_dtensor_ops
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.attention import attention_impl
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline.analysis import analyze, count_step

    cfg = cfg or get_config(arch)
    shape = next(s for s in cfg.shapes() if s.name == shape_name)
    precision = {"bf16": BF16_ROLLOUT, "fp8": FULL_FP8_ROLLOUT,
                 "fp8lin": FP8_LINEAR_ROLLOUT}[precision_name]
    overrides = overrides or {}
    world = 512 if mesh_kind == "multi" else 256
    if dist.is_initialized():
        raise RuntimeError("run_cell opens its own fake process group: call it in a "
                           "process of its own (run_cell_subprocess)")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
        register_dtensor_ops()
        if overrides.get("full_tp"):
            # beyond-paper decode sharding: every mesh axis is TP
            rules = ShardingRules(mesh, tp_axis=tuple(mesh.mesh_dim_names), dp_axes=(),
                                  vocab_parallel_ce=overrides.get("vocab_parallel_ce", False))
        else:
            rules = ShardingRules(
                mesh, zero3=overrides.get("zero3", True),
                sequence_parallel=overrides.get("sequence_parallel", False),
                vocab_parallel_ce=overrides.get("vocab_parallel_ce", False))
        # big models need fp8 optimizer moments to fit HBM (the reference's rule)
        opt_cfg = AdamWConfig(fp8_moments=cfg.param_count() > 50e9)
        record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "precision": precision_name, "n_devices": world, "status": "running",
                  "tag": tag, "overrides": overrides}
        t0 = time.time()
        step, args, donated = _cell_inputs(cfg, shape, rules, precision, opt_cfg)
        batch_i = 2 if shape.kind == "train" else 1
        arg_bytes = [_batch_bytes(a, rules) if i == batch_i else _local_bytes(a)
                     for i, a in enumerate(args)]
        grad = contextlib.nullcontext() if shape.kind == "train" else torch.no_grad()
        with attention_impl(overrides.get("attn_impl", "naive")), grad:
            out, costs = count_step(step, *args)
        record["step_s"] = time.time() - t0
        temp = costs.pop("peak_live_bytes") - costs["end_live_bytes"]
        mem = {"argument_bytes": int(sum(arg_bytes)),
               "output_bytes": int(_local_bytes(out)),
               "temp_bytes": int(temp),
               "alias_bytes": int(sum(arg_bytes[i] for i in donated))}
        mem["peak_bytes_est"] = (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])
        mem["temp_definition"] = ("peak bytes the step allocated and had not freed, less "
                              "those it still holds at its end (its new outputs)")
        record["memory"] = mem
        print("memory:", mem)
        record["accounting"] = ACCOUNTING
        record["raw_costs_counted"] = {k: costs[k] for k in
                                       ("flops", "bytes", "coll", "coll_counts", "kernels",
                                        "end_live_bytes")}
        terms = analyze(costs, cfg, shape, shape.kind, world)
        record["roofline"] = terms.to_dict()
        record["status"] = "ok"
        print(f"roofline: compute={terms.compute_s:.4e}s memory={terms.memory_s:.4e}s "
              f"collective={terms.collective_s:.4e}s dominant={terms.dominant} "
              f"useful_flops={terms.useful_flops_fraction:.2f} mfu={terms.mfu:.3f}")
        return record
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def run_cell_subprocess(arch, shape, mesh, precision=BASE_PRECISION, tag="",
                        overrides=None, timeout=5400, out_dir=None):
    """`run_cell` in a child process (`python -m repro_torch.launch.dryrun`);
    returns the record's path (an error record if the child wrote none)."""
    out_path = result_path(arch, shape, mesh, precision, tag, out_dir)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--precision", precision,
           "--out", os.path.dirname(out_path)]
    if tag:
        cmd += ["--tag", tag]
    if overrides:
        cmd += ["--overrides", json.dumps(overrides)]
    env = dict(os.environ)
    src = os.path.join(REPO, "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                               else "")
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=timeout)
        err = proc.stderr[-4000:]
        failed = proc.returncode != 0
    except subprocess.TimeoutExpired:
        err, failed = f"timeout after {timeout}s", True
    if failed and not os.path.exists(out_path):
        record = {"arch": arch, "shape": shape, "mesh": mesh,
                  "precision": precision, "status": "error", "tag": tag,
                  "wall_s": time.time() - t0, "error": err}
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--precision", default=BASE_PRECISION)
    ap.add_argument("--tag", default="")
    ap.add_argument("--overrides", default="")
    ap.add_argument("--out", default=None, help=f"records' directory (default {RESULTS_DIR})")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for c in cell_list():
            print(*c)
        return

    if args.all:
        cells = cell_list()
        for i, (arch, shape, mesh) in enumerate(cells):
            out_path = result_path(arch, shape, mesh, out_dir=args.out)
            if os.path.exists(out_path) and not args.force:
                print(f"[{i+1}/{len(cells)}] cached {arch} {shape} {mesh}")
                continue
            print(f"[{i+1}/{len(cells)}] {arch} {shape} {mesh} ...", flush=True)
            t0 = time.time()
            run_cell_subprocess(arch, shape, mesh, out_dir=args.out)
            with open(out_path) as f:
                status = json.load(f).get("status")
            print(f"    -> {status} ({time.time()-t0:.0f}s)", flush=True)
        return

    # single-cell (in-process) mode
    overrides = json.loads(args.overrides) if args.overrides else None
    out_path = result_path(args.arch, args.shape, args.mesh, args.precision, args.tag,
                           args.out)
    try:
        record = run_cell(args.arch, args.shape, args.mesh, args.precision,
                          args.tag, overrides)
    except Exception:
        record = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                  "precision": args.precision, "tag": args.tag,
                  "status": "error", "error": traceback.format_exc()[-6000:]}
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2)
        print(record["error"], file=sys.stderr)
        sys.exit(1)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
