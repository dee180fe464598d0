"""The port's serving engine vs the JAX reference's, and vs itself.

Both engines serve the same trace with the same parameters (the
reference's `init_params`, bridged), with `eos_id=None` so the schedule
cannot depend on the tokens:

* the per-step `ScheduleDecision.accounting()` lists are equal, and so
  are the `ServeReport` counters (host-side policy is a copy of the
  reference's, so these are exact);
* greedy tokens are equal up to the first step where the reference's
  top-2 logit gap is under twice the logit tolerance of the model tests
  (0.08 with bf16 linears, 0.4 under W8A8; test_torch_model.py) — past a
  near-tie the two are different sequences.

Traces vs the reference: kernel_config "off" with chunked prefill, an
ondemand budget tight enough to swap, a host tier and shared-prefix
prompts (W8A8 + FP8 KV); "off" one-shot prefill (bf16); one small "all"
trace (FP8 KV; the reference's Pallas kernels in interpret mode); and the
forked-table copy-on-write recipe of
`test_block_manager.py::test_cow_guard_on_forked_partial_block` (no
unforked trace makes the reference's scheduler plan a CoW: a decode write
lands past the prompt's full blocks, which are the only shared ones).

The port against itself, mirroring the reference's contracts: chunked vs
one-shot prefill bit-exact (`test_scheduler.py:71`), every eviction policy
under pressure bit-exact vs uncontended (`:171`), speculative greedy equal
to plain greedy (`test_spec_decode.py:275`), `KernelConfig.parse`
(`test_paged_kernels.py:240`), and the launcher on the CPU.  Last, the
allocator fault the port repairs (`BlockManager.promote_hits`).
"""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precision as jp  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import engine as jengine_mod  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.kernels.config import KernelConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs.tracer import NULL_TRACER, StepTracer  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EVICTION_POLICIES,
    ServingEngine,
    SpecConfig,
    StepBudget,
    kv_bytes_per_token,
)
from repro_torch.serving.engine import Request  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATOL_BF16, ATOL_W8A8 = 0.08, 0.4
PRECISIONS = {
    "bf16": (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT, ATOL_BF16),
    "fp8_kv": (jp.FP8_KV_ONLY_ROLLOUT, tp.FP8_KV_ONLY_ROLLOUT, ATOL_BF16),
    "default": (jp.PrecisionConfig(), tp.PrecisionConfig(), ATOL_W8A8),
}
COUNTERS = ("steps", "preemptions", "wasted_tokens", "emitted_tokens", "budget_tokens",
            "swap_outs", "swap_ins", "peak_blocks_in_use", "prefix_hit_blocks",
            "cow_copies", "prefill_chunks", "spec_steps", "draft_tokens",
            "accepted_tokens", "stalled")

_prompt = jtasks.random_prompt


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.tiny_serving_config()
    params = init_params(cfg, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    rolls = {}
    for name, (jprec, tprec, _) in PRECISIONS.items():
        jroll, _ = jsync(params, jprec)
        troll, _ = tsync(params_from_numpy(np_params, "cpu"), tprec)
        rolls[name] = (jroll, troll)
    return cfg, tconfigs.tiny_serving_config(), rolls


def _top2_gap(row):
    top = np.sort(np.asarray(row, np.float32))[::-1]
    return float(top[0] - top[1])


def _record_reference_gaps(eng, monkeypatch):
    """(rid, token index) -> top-2 gap of the logits the reference engine
    sampled that token from (first tokens off the final prefill logits,
    the rest off the fused decode)."""
    gaps, first = {}, {}
    sample = jengine_mod.sample

    def rec_sample(logits, *args, **kw):
        arr = np.asarray(logits, np.float32)
        if arr.ndim == 1:
            first["row"] = arr
        else:
            for i, r in enumerate(eng.slot_req):
                if r is not None and r.generated and r.prefilled >= len(r.prompt):
                    gaps[(r.rid, len(r.generated))] = _top2_gap(arr[i])
        return sample(logits, *args, **kw)

    commit = eng._commit_first_token

    def rec_commit(req, tok, logp, slot):
        gaps[(req.rid, 0)] = _top2_gap(first.pop("row"))
        return commit(req, tok, logp, slot)

    monkeypatch.setattr(jengine_mod, "sample", rec_sample)
    monkeypatch.setattr(eng, "_commit_first_token", rec_commit)
    return gaps


def _drive(eng, max_steps=400):
    """Step to completion; the per-step accounting and the report."""
    accts = []
    for _ in range(max_steps):
        if not (eng.queue or any(r is not None for r in eng.slot_req)):
            break
        d = eng.step()
        assert not d.is_empty, "stalled"
        accts.append(d.accounting())
    return accts, eng.run(max_steps=max_steps)


def _fork_rid0(eng, request_cls):
    """The reference's CoW recipe: admit rid 0, then give a second request
    a table sharing ALL of rid 0's blocks (a shared partial tail)."""
    eng._try_admit()
    prompt = eng.slot_req[0].prompt
    req_b = request_cls(rid=1, prompt=prompt, max_new=6,
                        prefilled=len(prompt), cached_tokens=len(prompt))
    eng.block_mgr.fork(0, 1)
    slot = eng._free_slot()
    eng._set_table_row(slot, eng.block_mgr.blocks_of(1))
    if isinstance(eng, ServingEngine):
        eng._lengths[slot] = len(prompt)
    else:
        eng.cache["lengths"] = eng.cache["lengths"].at[slot].set(len(prompt))
    eng.pending_tok[slot] = eng.pending_tok[0]
    req_b.generated = [int(eng.pending_tok[0])]
    eng.slot_req[slot] = req_b


def _serve_both(setup, monkeypatch, name, trace, fork=False, **kw):
    """Serve `trace` [(prompt, max_new)] on both engines (with `fork`, the
    CoW recipe forks rid 0 into rid 1) and compare as the module says."""
    cfg, tcfg, rolls = setup
    jroll, troll = rolls[name]
    jprec, tprec, atol = PRECISIONS[name]
    out = []
    for engine, roll, c, prec, req_cls, extra in (
            (JEngine, jroll, cfg, jprec, JRequest, {}),
            (ServingEngine, troll, tcfg, tprec, Request, {"device": "cpu"})):
        eng = engine(roll, c, prec, eos_id=None, **kw, **extra)
        gaps = _record_reference_gaps(eng, monkeypatch) if engine is JEngine else None
        for i, (p, n) in enumerate(trace):
            eng.submit(p, max_new=n, rid=i)
        if fork:
            _fork_rid0(eng, req_cls)
            if gaps is not None:
                gaps[(1, 0)] = gaps[(0, 0)]       # the fork's copied first token
        accts, rep = _drive(eng)
        out.append((eng, accts, rep, gaps))
    (_, jaccts, jrep, gaps), (teng, taccts, trep, _) = out
    assert taccts == jaccts
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.mean_occupancy == pytest.approx(jrep.mean_occupancy)
    jtok = {r.rid: list(r.generated) for r in jrep.completed}
    ttok = {r.rid: list(r.generated) for r in trep.completed}
    assert sorted(ttok) == sorted(jtok) == list(range(len(trace) + fork))
    decisive = 0
    for rid, want in jtok.items():
        got = ttok[rid]
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                assert gaps[(rid, i)] < 2 * atol, (rid, i, gaps[(rid, i)])
                break
            decisive += gaps[(rid, i)] >= 2 * atol
    assert teng.block_mgr.blocks_in_use == 0
    print(f"{name}: {decisive} decisive tokens equal; accounting of "
          f"{len(taccts)} steps equal")
    return trep, ttok


# ---------------------------------------------------------------------------
# the port's engine vs the reference's
# ---------------------------------------------------------------------------

def _shared_prefix_trace():
    """Two groups of two prompts sharing an 8-token prefix (2 full blocks
    of fp8 KV at block_size 2 -> 4 tokens), plus two unrelated prompts."""
    trace = []
    for g in range(2):
        head = _prompt(100 + g, 8)
        for j in range(2):
            tail = _prompt(200 + 2 * g + j, 4 + 3 * j)[1:]
            trace.append((np.concatenate([head, tail]), 8))
    trace += [(_prompt(7, 9), 8), (_prompt(8, 5), 8)]
    return trace


def test_engine_matches_reference_chunked_tight_swap_shared_prefix(setup, monkeypatch):
    """kernel_config "off", chunked prefill, ondemand admission with a budget
    that forces swap-outs, a host tier, shared prefixes (W8A8 + FP8 KV)."""
    cfg = setup[0]
    per = kv_bytes_per_token(cfg, tp.PrecisionConfig())
    rep, _ = _serve_both(
        setup, monkeypatch, "default", _shared_prefix_trace(),
        kernel_config="off", max_slots=4, max_seq_len=32, block_size=2,
        prefill_chunk=4, admission="ondemand", kv_budget_bytes=per * 40,
        host_kv_blocks=4, step_budget=StepBudget(prefill_tokens=8))
    assert rep.preemptions >= 1 and rep.prefix_hit_blocks >= 1
    assert rep.prefill_chunks > 0


def test_engine_matches_reference_one_shot(setup, monkeypatch):
    """kernel_config "off", one-shot prefill, reserve admission (bf16)."""
    trace = [(_prompt(s, int(5 + s % 9)), 6) for s in range(5)]
    _serve_both(setup, monkeypatch, "bf16", trace, kernel_config="off", max_slots=3,
                max_seq_len=32)


def test_engine_matches_reference_all_kernels(setup, monkeypatch):
    """kernel_config "all": the port's kernel plain versions vs the
    reference's Pallas kernels (interpret mode), chunked prefill (FP8 KV)."""
    trace = [(_prompt(1, 13), 5), (_prompt(2, 6), 5), (_prompt(3, 9), 5)]
    _serve_both(setup, monkeypatch, "fp8_kv", trace, kernel_config="all", max_slots=2,
                max_seq_len=32, prefill_chunk=4)


def test_engine_matches_reference_forked_cow(setup, monkeypatch):
    prompt = np.array([jtasks.BOS, 5, 6, 7, 8, 9], np.int32)  # block 1 partial
    rep, got = _serve_both(setup, monkeypatch, "bf16", [(prompt, 6)], fork=True,
                           kernel_config="off", max_slots=2, max_seq_len=32)
    assert rep.cow_copies >= 1
    assert got[0] == got[1]                       # donor and fork agree


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

def _serve(setup, name, trace, **kw):
    _, tcfg, rolls = setup
    eng = ServingEngine(rolls[name][1], tcfg, PRECISIONS[name][1], device="cpu", **kw)
    for i, (p, n) in enumerate(trace):
        eng.submit(p, max_new=n, rid=i)
    rep = eng.run(max_steps=500)
    assert len(rep.completed) == len(trace) and not rep.stalled
    assert eng.block_mgr.blocks_in_use == 0
    return eng, rep, {r.rid: list(r.generated) for r in rep.completed}


@pytest.mark.parametrize("name", ["bf16", "fp8_kv"])
def test_chunked_prefill_bit_exact_vs_one_shot(setup, name):
    trace = [(_prompt(s, int(5 + s % 9)), 6) for s in range(6)]
    outs, scales = {}, {}
    for mode, kw in (("one_shot", {}),
                     ("chunked", dict(prefill_chunk=4,
                                      step_budget=StepBudget(prefill_tokens=8)))):
        eng, _, outs[mode] = _serve(setup, name, trace, kernel_config="off",
                                    max_slots=4, max_seq_len=32, **kw)
        scales[mode] = eng.cache["slots"]["s0"]["kv"].k_scale.clone()
    assert outs["chunked"] == outs["one_shot"]
    assert torch.equal(scales["chunked"], scales["one_shot"])


@pytest.mark.parametrize("kernel_config", ["off", "all"])
@pytest.mark.parametrize("policy", sorted(EVICTION_POLICIES))
def test_policies_bit_exact_under_pressure(setup, policy, kernel_config):
    cfg = setup[0]
    trace = [(_prompt(s, int(5 + s % 8)), 8) for s in range(6)]
    per = kv_bytes_per_token(cfg, tp.BF16_ROLLOUT)
    runs = {}
    for budget in (400, 40):
        _, runs[budget], _ = _serve(setup, "bf16", trace, kernel_config=kernel_config,
                                    max_slots=4, max_seq_len=32, admission="ondemand",
                                    kv_budget_bytes=per * budget, eviction=policy,
                                    prefill_chunk=4)
    assert runs[400].preemptions == 0 and runs[40].preemptions >= 1
    assert {r.rid: r.generated for r in runs[40].completed} == \
        {r.rid: r.generated for r in runs[400].completed}


def _spec_trace(n, seed):
    """Repetitive prompts the n-gram drafter can guess from."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        motif = rng.integers(4, 19, size=3)
        out.append((np.concatenate([[jtasks.BOS], np.tile(motif, 4)]).astype(np.int32), 8))
    return out


@pytest.mark.parametrize("kernel_config", ["off", "all"])
@pytest.mark.parametrize("name", ["bf16", "fp8_kv"])
def test_spec_greedy_equals_plain_greedy(setup, name, kernel_config):
    trace = _spec_trace(3, seed=0)
    outs = {}
    for spec in (None, SpecConfig(num_draft_tokens=4)):
        _, rep, outs[spec is not None] = _serve(
            setup, name, trace, kernel_config=kernel_config, max_slots=4,
            max_seq_len=48, prefill_chunk=4, eos_id=None, spec=spec)
        if spec is not None:
            assert rep.spec_steps > 0 and rep.accepted_tokens > 0
    assert outs[True] == outs[False]


def test_kernel_config_parse():
    assert KernelConfig.parse("off") == KernelConfig()
    assert KernelConfig.parse("decode") == KernelConfig(decode=True)
    assert KernelConfig.parse("prefill") == KernelConfig(prefill=True)
    assert KernelConfig.parse("all") == KernelConfig(prefill=True, decode=True)
    kc = KernelConfig(decode=True)
    assert KernelConfig.parse(kc) is kc
    assert not KernelConfig().any and KernelConfig(prefill=True).any
    with pytest.raises(ValueError, match="unknown kernel_config"):
        KernelConfig.parse("paged")


def test_engine_refuses_what_is_not_ported(setup):
    _, tcfg, rolls = setup
    troll = rolls["bf16"][1]

    # the recording tracer is ported: the engine takes it (its events are
    # held to the reference's in test_torch_obs.py)
    recording = StepTracer()
    assert ServingEngine(troll, tcfg, tp.BF16_ROLLOUT, device="cpu",
                         tracer=recording).tracer is recording
    assert ServingEngine(troll, tcfg, tp.BF16_ROLLOUT, device="cpu",
                         tracer=NULL_TRACER).tracer is NULL_TRACER
    # a VLM has no engine path: the reference's engine never passes patches
    # (SSM, hybrid and enc-dec serve: test_torch_hybrid_serving.py,
    # test_torch_encdec.py)
    with pytest.raises(NotImplementedError, match="patch"):
        ServingEngine(troll, tcfg.reduced(frontend="vision_patches", frontend_len=4),
                      tp.BF16_ROLLOUT, device="cpu")


def test_launcher_serves_on_cpu():
    out = tserve.run(["--reduced", "--device", "cpu", "--prefill-chunk", "4",
                      "--requests", "6", "--max-new", "6", "--slots", "4",
                      "--budget-tokens", "40", "--admission", "ondemand",
                      "--spec-k", "2"])
    assert out["completed"] == 6 and not out["stalled"]
    # the default --precision fp8 resolves the default kernels to "off"
    assert out["kernel_config"] == "off" and out["prefill_chunks"] > 0
    assert out["device"] == "cpu"


# ---------------------------------------------------------------------------
# the allocator fault the port repairs
# ---------------------------------------------------------------------------

def _revival_with_cached_hits(block_manager_cls):
    """A prefix of 4 blocks whose first two were demoted to the host tier
    and whose last two sit in the evictor cache ahead of an unrelated
    cached block, with one free row: reviving it needs two rows for the
    host hits.  Returns the revived table."""
    bm = block_manager_cls(num_blocks=8, block_size=2, host_blocks=4)
    bm.set_host_callbacks(demote_copy=lambda dev, host: None)
    prompt_a, prompt_b = np.arange(1, 9), np.arange(20, 22)
    bm.allocate(0, 4)
    bm.register_prefix(0, prompt_a)
    bm.free(0)                              # cached: a0 a1 a2 a3
    bm.allocate(1, 4)                       # takes the 4 free rows
    bm.allocate(1, 2)                       # evicts a0, a1 to the host tier
    bm.free(1)
    bm.allocate(3, 4)                       # leaves two free rows
    bm.allocate(4, 1)
    bm.register_prefix(4, prompt_b)
    bm.free(4)                              # cached: a2 a3 b0; one free row
    hits = bm.lookup_prefix(prompt_a)
    assert [bm.tier(b) for b in hits] == ["host", "host", "device", "device"]
    table, moves, n = bm.promote_hits(2, hits)
    assert n == 2
    return table, hits


def test_prefix_revival_never_aliases_a_cached_hit():
    """Promoting the host hits of a prefix must not evict a cached device
    hit of the same prefix: the port pins the device hits first, so the
    revived table has four distinct rows and keeps the device hits.  The
    reference's `promote_hits` acquires in table order, evicts the cached
    hit for the second promotion, and puts that row at two positions."""
    from repro.serving.block_manager import BlockManager as JBlockManager
    from repro_torch.serving import BlockManager
    table, hits = _revival_with_cached_hits(BlockManager)
    assert len(set(table)) == 4 and table[2:] == hits[2:]
    ref_table, _ = _revival_with_cached_hits(JBlockManager)
    assert len(set(ref_table)) == 3


def test_dropped_engine_is_freed_by_refcount(setup):
    """A dropped engine (pool, allocator and host tier included) is freed
    when its last reference goes, with the collector off: its allocator's
    hooks hold it weakly, so no reference cycle keeps it for
    `gc.collect()`."""
    import gc
    import weakref
    _, tcfg, rolls = setup
    trace = [(_prompt(s, int(5 + s % 8)), 8) for s in range(6)]
    per = kv_bytes_per_token(tcfg, tp.BF16_ROLLOUT)
    eng = ServingEngine(rolls["bf16"][1], tcfg, tp.BF16_ROLLOUT, device="cpu",
                        max_slots=4, max_seq_len=32, admission="ondemand",
                        kv_budget_bytes=per * 40, host_kv_blocks=8, prefill_chunk=4,
                        tracer=StepTracer())
    for i, (p, n) in enumerate(trace):
        eng.submit(p, max_new=n, rid=i)
    assert eng.run(max_steps=500).swap_outs >= 1        # the host hooks ran
    refs = [weakref.ref(eng), weakref.ref(eng.block_mgr),
            weakref.ref(eng.cache["slots"]["s0"]["kv"])]
    gc.disable()
    try:
        del eng
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()
