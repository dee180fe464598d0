"""Spawned gloo ranks for `test_torch_distributed.py` (imports only torch,
numpy and `repro_torch`, never JAX).

`RankGroup(world, store_path)` starts `world` processes (the `spawn`
method) that join one gloo group through a `FileStore` and then serve
jobs: `group.submit(key, name, **kw)` registers the job `JOBS[name]`
(called as `fn(rank, world, **kw)`) under `key`, and `collect(key)` sends
it to every rank and returns the ranks' results in rank order (`run`
does both); a rank that raises sends its traceback, and `collect` raises
with it.  One group serves a whole test module, which can register every
job up front: a job reaches the ranks only when a test collects it, so
each pytest-xdist worker that runs some of the module's tests (each with
a group of its own) runs only those tests' jobs.
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
    one 4-stage pipeline of tanh(h @ w_s + b_s), its params laid out by
    `shard_stages` (each rank holds its own stage's slice)."""
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply, shard_stages
    n_stages = w.shape[0]
    mesh = _mesh((world // n_stages, n_stages), ("rep", "stage"))
    piped = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), mesh)
    params = shard_stages({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, mesh)
    out = piped(params, torch.from_numpy(x))
    return {"out": out.numpy(), "bubble": bubble_fraction(n_stages, x.shape[0]),
            "local_shapes": {k: tuple(v.to_local().shape) for k, v in params.items()}}


def _serve_cfg():
    """A reduced llama3.2-3b whose shards on the (2, 4) mesh take every
    branch of the sharded W8A8 linear (wq's N shard of 48 splits a scale
    block and is gathered, wg's 256 is column-parallel, wd's K shard of
    256 row-parallel) and of the moment layouts (wq's last axis straddles
    128-blocks, wg's does not)."""
    from repro_torch.configs import get_config
    return get_config("llama3.2-3b").reduced(
        d_model=256, d_ff=1024, vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=48)


def _serve_ssm_cfg():
    """A reduced mamba2-780m: its mixers run replicated under the rules
    (`models.ssm`), w_in's N shard of 272 is gathered."""
    from repro_torch.configs import get_config
    return get_config("mamba2-780m").reduced(d_model=256, vocab_size=256, n_layers=2,
                                               ssm_state=16, ssm_head_dim=16)


def _byte_equal(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def job_fp8_moments(rank, world, steps):
    """`steps` AdamW updates with fp8 moments of the sharded f32 params of
    `_serve_cfg` against the same updates in this process: the leaves
    whose moments differ in a payload or a scale byte, the largest param
    difference, and the leaves whose blocks straddle a shard."""
    import copy

    from torch.distributed.tensor import Replicate

    from repro_torch.core.fp8_params import tree_leaves
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models.common import redistribute
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw

    cfg = _serve_cfg()
    params = Transformer(cfg, "cpu", dtype=torch.float32).init_params(0)
    gen = torch.Generator().manual_seed(5)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return torch.randn(t.shape, generator=gen) * 1e-2
    grads = draw(params)
    opt = adamw.AdamWConfig(lr=1e-3, fp8_moments=True)
    one = copy.deepcopy(params)
    state1 = adamw.init(one, opt)
    for _ in range(steps):
        one, state1, _ = adamw.update(one, grads, state1, opt)
    mesh, rules = _mesh_and_rules(world)
    specs = rules.params(params)
    dparams, dgrads = distribute(params, specs, mesh), distribute(grads, specs, mesh)
    state2 = adamw.init(dparams, opt)
    for _ in range(steps):
        dparams, state2, _ = adamw.update(dparams, dgrads, state2, opt)
    whole = [Replicate()] * mesh.ndim
    bad, straddle = [], []

    def walk(a, b, p, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], p[k], f"{path}/{k}")
            return
        if not adamw._moment_layout(p)[3]:
            straddle.append(path)
        if not (_byte_equal(a.data, redistribute(b.data, whole).to_local())
                and _byte_equal(a.scales, redistribute(b.scales, whole).to_local())):
            bad.append(path)
    for name in ("m", "v"):
        walk(getattr(state1, name), getattr(state2, name), dparams, name)
    diff = max(float((x - y.full_tensor()).abs().max())
               for x, y in zip(tree_leaves(one), tree_leaves(dparams)))
    return {"bad": bad, "param_diff": diff, "straddle": sorted(set(straddle))}


def _planted(fault):
    """A context that plants `fault` in the sharded W8A8 linear (None:
    none): "no_reduce" drops the row-parallel sum over the TP group,
    "scale_offset" narrows each weight's scale blocks one block off."""
    import contextlib
    from unittest import mock

    from repro_torch.core import fp8_linear

    if fault is None:
        return contextlib.nullcontext()
    if fault == "no_reduce":
        plan = fp8_linear._sharded_plan
        return mock.patch.object(fp8_linear, "_sharded_plan",
                                 lambda x, w: (*plan(x, w)[:3], []))
    blocks = fp8_linear._local_blocks

    def shifted(w, w_pl):
        data, scales = blocks(w, w_pl)
        return data, scales.roll((1, 1), dims=(-2, -1))
    return mock.patch.object(fp8_linear, "_local_blocks", shifted)


def job_sharded_serve(rank, world, arch, precision, steps, decisive_gap, fault=None):
    """The sharded W8A8 `make_prefill_step` and `steps` `make_serve_step`
    calls of `_serve_cfg` (arch "dense") or `_serve_ssm_cfg` ("ssm") on
    the (2, 4) mesh against the same steps in this process (its synced
    weights distributed), with `fault` planted in the sharded steps
    (`_planted`): each step's largest logit gap and largest logit, the
    argmax agreement on the rows whose top-2 gap exceeds `decisive_gap`
    and their number, the kernel calls a rank made (`count_step`)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import fp8_params
    from repro_torch.core.precision import FULL_FP8_ROLLOUT, PrecisionConfig
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.transformer import Transformer
    from repro_torch.roofline.analysis import count_step

    prec = {"default": PrecisionConfig(), "fp8": FULL_FP8_ROLLOUT}[precision]
    cfg = {"dense": _serve_cfg, "ssm": _serve_ssm_cfg}[arch]()
    roll = fp8_params.quantize_params(Transformer(cfg, "cpu").init_params(0), prec)
    shape = ShapeConfig("p", 16, 4, "prefill")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen),
             "lengths": torch.tensor([12, 11, 9, 12], dtype=torch.int32)}
    logits1, cache1 = steps_mod.make_prefill_step(cfg, shape, prec, device="cpu")(roll, batch)
    serve1 = steps_mod.make_serve_step(cfg, prec, device="cpu")
    mesh, rules = _mesh_and_rules(world)
    droll = distribute(roll, rules.params(roll), mesh)
    with _planted(fault):
        (logits2, cache2), costs = count_step(
            steps_mod.make_prefill_step(cfg, shape, prec, rules=rules), droll, batch)
        serve2 = steps_mod.make_serve_step(cfg, prec, rules=rules)
        gaps, peaks, agree, n_decisive, calls = [], [], [], [], [costs["kernels"]]
        for _ in range(steps + 1):
            full = logits2.full_tensor()
            gaps.append(float((full - logits1).abs().max()))
            peaks.append(float(logits1.abs().max()))
            top2 = torch.topk(logits1, 2, dim=-1).values
            decisive = (top2[:, 0] - top2[:, 1]) > decisive_gap
            agree.append(bool((full.argmax(-1) == logits1.argmax(-1))[decisive].all()))
            n_decisive.append(int(decisive.sum()))
            if len(gaps) > steps:
                break
            tok = logits1.argmax(-1)
            logits1, cache1 = serve1(roll, tok, cache1)
            (logits2, cache2), costs = count_step(serve2, droll, tok, cache2)
            calls.append(costs["kernels"])
    return {"gaps": gaps, "peaks": peaks, "agree": agree, "decisive": n_decisive,
            "calls": calls}


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


def job_nested_rows(rank, world, x, w):
    """`core.fp8_linear`'s rank-local flatten / unflatten of rows that two
    mesh dims shard (the multi-pod batch) around a GEMM, on a ("pod",
    "data", "model") (2, 2, 2) mesh, w replicated and w column-sharded:
    the products and x's gradient, whole."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.fp8_linear import _flatten_rows, _nested_rows, _unflatten_rows
    from repro_torch.distributed.sharding import distribute

    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for name, w_spec in (("replicated", (None, None)), ("column", (None, "model"))):
        xd = distribute(torch.from_numpy(x), (("pod", "data"), None, None), mesh)
        xd.requires_grad_(True)
        wd = distribute(torch.from_numpy(w), w_spec, mesh)
        assert _nested_rows(xd) and xd.placements[:2] == (Shard(0), Shard(0))
        y = _unflatten_rows(torch.mm(_flatten_rows(xd), wd), xd)
        (y.float() * y.float()).sum().backward()
        out[name] = {"y": y.full_tensor().detach().numpy(),
                     "grad": xd.grad.redistribute(mesh, [Replicate()] * 3).to_local().numpy()}
    return out


JOBS = {"compress": job_compress, "pipeline": job_pipeline,
        "dense_step": job_dense_step, "repeat_step": job_repeat_step,
        "moe_step": job_moe_step, "fp8_moments": job_fp8_moments,
        "sharded_serve": job_sharded_serve, "nested_rows": job_nested_rows}


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
        self.pending = {}       # key -> (name, kw), not yet sent
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
        """Register job `name` under `key`; the ranks get it when
        `collect(key)` first asks for it."""
        self.pending[key] = (name, kw)

    def collect(self, key: str) -> list:
        """Send job `key` to every rank if it is still pending, and return
        the ranks' results (kept: a second call returns them again)."""
        if key in self.pending:
            name, kw = self.pending.pop(key)
            for q in self.inboxes:
                q.put((key, name, kw))
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
