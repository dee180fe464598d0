"""Spawned gloo ranks for `test_torch_distributed.py` (imports only torch,
numpy and `repro_torch`, never JAX).

`RankGroup(world, store_path)` starts `world` processes (the `spawn`
method) that join one gloo group through a `FileStore` and then serve
jobs: `group.submit(key, name, **kw)` queues the job `JOBS[name]`
(called as `fn(rank, world, **kw)`) on every rank, and `collect(key)`
returns the ranks' results in rank order (`run` does both); a rank that
raises sends its traceback, and `collect` raises with it.  One group
serves a whole test module, which can queue every job up front and
compute its oracles while the ranks work.
"""
from __future__ import annotations

import os
import queue
import traceback

import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 120


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    t = tree.full_tensor() if hasattr(tree, "full_tensor") else tree
    return t.detach().float().cpu().numpy()


def _tiny_dense():
    from repro_torch.configs import get_config
    return get_config("llama3.2-3b").reduced(
        d_model=64, d_ff=128, vocab_size=256, n_layers=2, n_heads=4,
        n_kv_heads=2, d_head=16)


def _tiny_moe():
    from repro_torch.configs import get_config
    return get_config("granite-moe-3b-a800m").reduced(
        d_model=64, d_ff=64, vocab_size=256, n_layers=2)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def job_compress(rank, world, xs, dtype):
    """compressed_psum / pmean of x[rank] (numpy f32, cast to `dtype`)."""
    from repro_torch.distributed.compression import compressed_pmean, compressed_psum
    x = torch.from_numpy(xs[rank]).to(getattr(torch, dtype))
    return {"psum": compressed_psum(x).float().numpy(),
            "pmean": compressed_pmean(x).float().numpy()}


def job_pipeline(rank, world, w, b, x):
    """pipeline_apply over a ("rep", "stage") mesh: each row of 4 ranks is
    one 4-stage pipeline of tanh(h @ w_s + b_s)."""
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
    n_stages = w.shape[0]
    mesh = _mesh((world // n_stages, n_stages), ("rep", "stage"))
    piped = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), mesh)
    out = piped({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    return {"out": out.numpy(), "bubble": bubble_fraction(n_stages, x.shape[0])}


_MESHES = {}


def _mesh(shape, names):
    """One `DeviceMesh` per shape for the life of the rank (each new mesh
    makes new gloo groups)."""
    from torch.distributed.device_mesh import init_device_mesh
    if (shape, names) not in _MESHES:
        _MESHES[shape, names] = init_device_mesh("cpu", shape, mesh_dim_names=names)
    return _MESHES[shape, names]


def _mesh_and_rules(world):
    from repro_torch.distributed.sharding import ShardingRules
    mesh = _mesh((2, world // 2), ("data", "model"))
    return mesh, ShardingRules(mesh, zero3=True)


def _sharded_step(cfg, params, tokens, steps, impl="naive"):
    """`steps` sharded train steps of a copy of `params` on the (2, 4)
    mesh: {"losses", "local_shapes", "comms"}."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.attention import attention_impl
    from repro_torch.optim import adamw

    mesh, rules = _mesh_and_rules(torch.distributed.get_world_size())
    dparams = distribute(params, rules.params(params), mesh)
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    state = adamw.init(dparams, opt_cfg)
    step = steps_mod.make_train_step(cfg, opt_cfg=opt_cfg, rules=rules)
    out = {"losses": [], "local_shapes": {}}
    with attention_impl(impl):
        comm = CommDebugMode()
        with comm:
            dparams, state, loss = step(dparams, state, {"tokens": tokens})
        out["losses"].append(float(loss))
        for _ in range(steps - 1):
            dparams, state, loss = step(dparams, state, {"tokens": tokens})
            out["losses"].append(float(loss))
    out["comms"] = sorted(str(k).split(".")[-1] for k in comm.get_comm_counts())

    def shapes(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                shapes(v, path)
            else:
                out["local_shapes"][path] = tuple(v.to_local().shape)
    shapes(dparams)
    return out


def _plain_step(cfg, params, tokens, steps):
    """The same steps in this process alone, on a copy of `params`."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw

    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    params = _clone(params)
    state = adamw.init(params, opt_cfg)
    step = steps_mod.make_train_step(cfg, opt_cfg=opt_cfg, device="cpu")
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, {"tokens": tokens})
        losses.append(float(loss))
    return {"losses": losses}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def job_dense_step(rank, world, params_np, tokens, impl="naive"):
    """A sharded make_train_step of the reduced llama3.2-3b (the
    reference's params, bridged)."""
    from repro_torch.bridge import params_from_numpy
    params = params_from_numpy(params_np, "cpu")
    out = _sharded_step(_tiny_dense(), params, torch.from_numpy(tokens), 1, impl)
    return out if rank == 0 else {"losses": out["losses"]}


def job_repeat_step(rank, world, params_np, tokens):
    """The sharded forward loss of `job_dense_step`'s params under the
    repeat impl (no backward: the naive step's loss is the oracle)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.bridge import params_from_numpy
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.attention import attention_impl
    from repro_torch.models.common import activation_sharding

    params = params_from_numpy(params_np, "cpu")
    mesh, rules = _mesh_and_rules(world)
    dparams = distribute(params, rules.params(params), mesh)
    tok = distribute(torch.from_numpy(tokens), rules.batch_spec(torch.from_numpy(tokens)), mesh)
    with torch.no_grad(), implicit_replication(), activation_sharding(rules), \
            attention_impl("repeat"):
        loss = steps_mod._lm_loss(dparams, {"tokens": tok}, _tiny_dense(), None, 0.0)
    return {"loss": float(loss)}


def job_moe_step(rank, world, tokens):
    """Two sharded steps of the reduced granite-moe-3b-a800m (f32 params
    from the port's seeded init) and, on rank 0, the same two steps in one
    process."""
    from repro_torch.models.transformer import Transformer
    cfg = _tiny_moe()
    params = Transformer(cfg, "cpu", dtype=torch.float32).init_params(0)
    tok = torch.from_numpy(tokens)
    sharded = _sharded_step(cfg, params, tok, 2)
    if rank:
        return {"losses": sharded["losses"]}
    plain = _plain_step(cfg, params, tok, 2)
    return {"sharded": sharded, "plain": plain}


JOBS = {"compress": job_compress, "pipeline": job_pipeline,
        "dense_step": job_dense_step, "repeat_step": job_repeat_step,
        "moe_step": job_moe_step}


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------

def _serve(rank, world, store_path, inbox, outbox):
    import datetime
    import logging

    import torch.distributed as dist
    torch.set_num_threads(1)
    # gloo's CPU all-to-all falls back to an all-gather, with a warning
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    # a rank that fails leaves the others in a collective: time it out
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        while True:
            job = inbox.get()
            if job is None:
                break
            key, name, kw = job
            try:
                outbox.put((key, rank, True, JOBS[name](rank, world, **kw)))
            except Exception:
                outbox.put((key, rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankGroup:
    def __init__(self, world: int, store_path: str):
        ctx = mp.get_context("spawn")
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.done = {}          # key -> {rank: (ok, result)}
        env = {"OMP_NUM_THREADS": "1"}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            self.procs = [ctx.Process(target=_serve, daemon=True,
                                      args=(r, world, store_path, self.inboxes[r], self.outbox))
                          for r in range(world)]
            for p in self.procs:
                p.start()
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def run(self, name: str, **kw) -> list:
        self.submit(name, name, **kw)
        return self.collect(name)

    def submit(self, key: str, name: str, **kw) -> None:
        """Queue job `name` on every rank under `key` and return at once:
        the ranks run their queue in order while the caller computes its
        oracles; `collect(key)` waits for the job's results."""
        for q in self.inboxes:
            q.put((key, name, kw))

    def collect(self, key: str) -> list:
        """The ranks' results of job `key` (kept: a second call returns
        them again)."""
        while len(self.done.get(key, ())) < self.world:
            try:
                k, rank, ok, res = self.outbox.get(timeout=JOB_TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError(f"job {key}: a rank sent nothing in {JOB_TIMEOUT_S} s")
            self.done.setdefault(k, {})[rank] = (ok, res)
        got = self.done[key]
        errors = [f"rank {r}:\n{res}" for r, (ok, res) in sorted(got.items()) if not ok]
        if errors:
            raise RuntimeError(f"job {key} failed\n" + "\n".join(errors))
        return [got[r][1] for r in range(self.world)]

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
