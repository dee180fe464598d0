"""The port's serving engine on SSM and hybrid layer patterns (slot-indexed
recurrent state: reset on admission, swapped with its request, written
back around the fused decode) vs the reference's engine.

Parameters: `repro.models.init_params` of the reference's
`tiny_ssm_serving_config` (attention-free) and
`tiny_hybrid_serving_config` (one attention and one SSM layer), bridged
with `params_from_numpy`, under BF16_ROLLOUT.  The pressured trace is
the reference's canonical preemption recipe, written out here: 5
requests of 5-9 tokens (`tasks.random_prompt(i, 5 + i % 5)`), 8 greedy
tokens each, 4 slots, max_seq_len 48, on-demand admission, a budget of
~2.5 requests' state (+ 40 tokens of KV) shrunk to 60% at decode step 4;
the roomy run has room for everything.  The reference engine's model
calls run jitted.  With `eos_id=None` no schedule depends on a token, so
the accounting (steps, preemptions, swap-ins, `wasted_tokens`, the
per-step `state_block_equiv` gauge) must be equal exactly; tokens must
equal the reference's up to the first step whose top-2 logit gap (the
reference's) is under 2 x LOGIT_ATOL = 0.32 (test_torch_ssm.py's bf16
logits band).  Port-only contracts are bit-exact (one intra-op thread):
preempted = roomy, a fresh occupant starts from zero state, a
piggybacked decode leaves a mid-prefill slot's state alone.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precision as jp  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import engine as jengine_mod  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.serving import ServingEngine, SpecConfig, StepBudget  # noqa: E402
from repro_torch.serving import kv_bytes_per_token, request_state_bytes  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LOGIT_ATOL = 0.16
PATTERNS = ("ssm", "hybrid")


@pytest.fixture(scope="module")
def models():
    """pattern -> (reference cfg, port cfg, reference params, port params)."""
    out = {}
    for pattern in PATTERNS:
        name = f"tiny_{pattern}_serving_config"
        jcfg, tcfg = getattr(jconfigs, name)(), getattr(tconfigs, name)()
        params = jax.jit(init_params, static_argnums=0)(jcfg, jax.random.key(0))
        out[pattern] = (jcfg, tcfg, params,
                        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    return out


@pytest.fixture
def jit_reference_engine():
    """The reference engine's model calls jitted (eagerly, each step
    would trace its layer scan again)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine_mod, "prefill", jax.jit(
            jengine_mod.prefill, static_argnums=(3, 4),
            static_argnames=("want_routing", "remat")))
        mp.setattr(jengine_mod, "decode_step", jax.jit(
            jengine_mod.decode_step, static_argnums=(3, 4),
            static_argnames=("want_routing", "use_kernel")))
        yield


def _engine(cls, params, cfg, budget_bytes, **kw):
    prec = jp.BF16_ROLLOUT if cls is JEngine else tp.BF16_ROLLOUT
    eng = cls(params, cfg, prec, max_slots=4, max_seq_len=48, admission="ondemand",
              eos_id=None, kv_budget_bytes=budget_bytes, **kw)
    for i in range(5):
        eng.submit(jtasks.random_prompt(i, 5 + i % 5), max_new=8, rid=i)
    return eng


def _drive(eng, shrink_at=None):
    """Step to completion (shrinking the budget to 60% at decode step
    `shrink_at`); the run's accounting, tokens and per-step gauge."""
    full = eng.budget_tokens
    gauge = []
    for _ in range(3000):
        if shrink_at is not None and eng.stats["steps"] >= shrink_at:
            eng.budget_tokens = int(full * 0.6)
            shrink_at = None
        if eng.step().is_empty:
            break
        gauge.append(eng.gauge_snapshot()["state_block_equiv"])
    keys = ("steps", "preemptions", "swap_outs", "swap_ins", "wasted_tokens", "emitted")
    return dict({k: eng.stats[k] for k in keys}, gauge=gauge,
                tokens={r.rid: [int(t) for t in r.generated] for r in eng.done})


def _budgets(tcfg):
    per = max(kv_bytes_per_token(tcfg, tp.BF16_ROLLOUT), 1)
    state = request_state_bytes(tcfg, tp.BF16_ROLLOUT)
    return per * 4 * 200 + 16 * state, per * 4 * 10 + int(2.5 * state)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_engine_matches_reference_with_and_without_preemption(
        models, pattern, jit_reference_engine, monkeypatch):
    jcfg, tcfg, params, tparams = models[pattern]
    roomy, tight = _budgets(tcfg)
    gaps, rows = {}, {}
    sample = jengine_mod.sample

    def rec_sample(logits, *args, **kw):
        arr = np.asarray(logits, np.float32)
        top = np.sort(arr, axis=-1)[..., ::-1]
        rows["gap"] = top[..., 0] - top[..., 1]
        return sample(logits, *args, **kw)
    monkeypatch.setattr(jengine_mod, "sample", rec_sample)
    runs = {}
    for name, budget, shrink in (("roomy", roomy, None), ("tight", tight, 4)):
        jeng = _engine(JEngine, params, jcfg, budget)
        real_commit = jeng._commit_first_token

        def commit(req, tok, logp, slot, _real=real_commit, _name=name):
            gaps[(_name, req.rid, 0)] = float(rows["gap"])
            return _real(req, tok, logp, slot)
        jeng._commit_first_token = commit
        real_decode = jeng._exec_decode

        def decode(slots, _eng=jeng, _real=real_decode, _name=name):
            before = {i: (_eng.slot_req[i].rid, len(_eng.slot_req[i].generated))
                      for i in slots if _eng.slot_req[i] is not None}
            _real(slots)
            for i, (rid, n) in before.items():
                gaps[(_name, rid, n)] = float(rows["gap"][i])
        jeng._exec_decode = decode
        runs[("ref", name)] = _drive(jeng, shrink)
        runs[("port", name)] = _drive(_engine(ServingEngine, tparams, tcfg, budget,
                                              device="cpu"), shrink)
    for name in ("roomy", "tight"):
        ref, port = runs[("ref", name)], runs[("port", name)]
        for key in ("steps", "preemptions", "swap_outs", "swap_ins", "wasted_tokens",
                    "emitted", "gauge"):
            assert port[key] == ref[key], (name, key)
        assert sorted(port["tokens"]) == sorted(ref["tokens"]) == list(range(5))
        equal = 0
        for rid, want in ref["tokens"].items():
            for i, (a, b) in enumerate(zip(port["tokens"][rid], want)):
                if a != b:
                    assert gaps[(name, rid, i)] < 2 * LOGIT_ATOL, (name, rid, i)
                    break
                equal += 1
        print(f"\n{pattern} {name}: {equal} of 40 tokens equal; preemptions "
              f"{port['preemptions']}, swap-ins {port['swap_ins']}, wasted "
              f"{port['wasted_tokens']}, state blocks at most {max(port['gauge'])}")
    tight = runs[("port", "tight")]
    assert runs[("port", "roomy")]["preemptions"] == 0
    assert tight["preemptions"] >= 1 and tight["swap_ins"] >= 1
    # the preempted run decodes the roomy run's tokens bit for bit (the
    # victims' SSM rows went to the host and came back)
    assert tight["tokens"] == runs[("port", "roomy")]["tokens"]


def test_fresh_admission_resets_the_slot_state(models):
    _, tcfg, _, tparams = models["hybrid"]
    prompt = jtasks.random_prompt(7, 9)
    eng = ServingEngine(tparams, tcfg, tp.BF16_ROLLOUT, max_slots=1, max_seq_len=32,
                        eos_id=None, device="cpu")
    eng.submit(prompt, max_new=6, rid=0)
    eng.run(max_steps=50)
    st = eng.cache["slots"]["s1"]["ssm"]
    assert float(st.h.abs().max()) > 0          # the first occupant's state
    eng.submit(prompt, max_new=6, rid=1)
    eng.run(max_steps=50)
    got = {r.rid: list(r.generated) for r in eng.done}
    assert got[0] == got[1]


def test_piggybacked_decode_keeps_a_mid_prefill_slot_state(models):
    _, tcfg, _, tparams = models["hybrid"]
    long_prompt = jtasks.random_prompt(3, 20)
    eng = ServingEngine(tparams, tcfg, tp.BF16_ROLLOUT, max_slots=2, max_seq_len=48,
                        prefill_chunk=4, eos_id=None, device="cpu")
    eng.submit(long_prompt, max_new=5, rid=0)
    alone = eng.run(max_steps=100).completed[0].generated
    eng = ServingEngine(tparams, tcfg, tp.BF16_ROLLOUT, max_slots=2, max_seq_len=48,
                        prefill_chunk=4, step_budget=StepBudget(prefill_tokens=4),
                        eos_id=None, device="cpu")
    eng.submit(jtasks.random_prompt(9, 5), max_new=12, rid=1)
    eng.step()                                  # rid 1 admitted and decoding
    eng.submit(long_prompt, max_new=5, rid=0)
    rep = eng.run(max_steps=100)
    assert rep.prefill_chunks >= 5              # decode steps ran between its chunks
    got = {r.rid: list(r.generated) for r in rep.completed}
    assert got[0] == list(alone)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_chunked_prefill_serves_the_oneshot_tokens(models, pattern):
    _, tcfg, _, tparams = models[pattern]
    prompts = [jtasks.random_prompt(s, 5 + s % 9) for s in range(4)]
    outs = {}
    for mode, kw in (("oneshot", {}), ("chunked", dict(
            prefill_chunk=4, step_budget=StepBudget(prefill_tokens=8)))):
        eng = ServingEngine(tparams, tcfg, tp.BF16_ROLLOUT, max_slots=4, max_seq_len=32,
                            eos_id=None, device="cpu", **kw)
        assert not eng._chunk_skip_ok and not eng._spec_ok
        for i, p in enumerate(prompts):
            eng.submit(p, max_new=6, rid=i)
        rep = eng.run(max_steps=400)
        assert len(rep.completed) == len(prompts) and not rep.stalled
        outs[mode] = {r.rid: list(r.generated) for r in rep.completed}
    assert outs["chunked"] == outs["oneshot"]


def test_state_bytes_gate_admission_and_speculation_is_refused(models):
    """Attention-free requests take no KV blocks, but their state is real
    memory: a budget of ~2.5 requests' state admits 2 at a time.  An SSM
    pattern's state cannot be rewound: speculation is refused."""
    _, tcfg, _, tparams = models["ssm"]
    state = request_state_bytes(tcfg, tp.BF16_ROLLOUT)
    eng = ServingEngine(tparams, tcfg, tp.BF16_ROLLOUT, max_slots=4, max_seq_len=32,
                        eos_id=None, kv_budget_bytes=int(2.5 * state), device="cpu")
    assert "block_tables" not in eng.cache and not eng.has_paged_kv
    for i in range(4):
        eng.submit(jtasks.random_prompt(i, 6), max_new=8, rid=i)
    peak = 0
    for _ in range(200):
        if eng.step().is_empty:
            break
        peak = max(peak, sum(r is not None for r in eng.slot_req))
        assert eng.gauge_snapshot()["state_block_equiv"] <= 2 * eng.state_blocks
    assert len(eng.done) == 4 and peak == 2
    for pattern in PATTERNS:
        _, cfg, _, params = models[pattern]
        with pytest.raises(ValueError):
            ServingEngine(params, cfg, tp.BF16_ROLLOUT, spec=SpecConfig(num_draft_tokens=2),
                          device="cpu")
