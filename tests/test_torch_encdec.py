"""The port's encoder-decoder path (seamless-m4t-medium's layer kinds: the
bidirectional encoder over frames, cross attention, cross caches through
`prefill` / `decode_step` / `generate`, the engine, the fleet and the
launchers) vs the JAX reference.

Parameters: `repro.models.init_params` of the reference's
`tiny_encdec_serving_config` (2 + 2 layers, d 64, 4/2 heads of 16),
bridged with `params_from_numpy`; inputs made with numpy from a seed; the
reference runs jitted, one jit per function for the module.  Tolerances,
measured on the CPU:

* cross K/V payload and scales bit-equal, calibrated and seeded (the
  projections are exact: wk and wv select columns, so both packages
  quantize the same K/V);
* `cross_attention_decode` over one cross cache (its q and wo linears
  W8A8) within ATTN_ATOL_W8A8 = 0.05, three bf16 ulps at |y| 2-4
  (measured 0.0254 at max|y| 2.45), and under FULL_FP8, where a
  last-bit difference in q can flip an e4m3 rounding of q or P, within
  ATTN_ATOL_FULL_FP8 = 0.15 (measured 0.078 at max|y| 2.5);
* `_encode` within ENC_ATOL_BF16 = 0.05 in bf16 and ENC_ATOL_W8A8 = 0.25
  under W8A8 (normed outputs of magnitude ~4; measured 0.023 and 0.145);
* logits (`forward_train`, prefill, decode steps, `generate`'s rollout
  logprobs) within LOGIT_ATOL = 0.5, the W8A8 band of the dense model
  (measured at most 0.25 here); greedy tokens equal up to the first step
  whose top-2 logit gap is under 2 x LOGIT_ATOL (a near-tie may break
  either way).
The engine is compared with the reference's engine on the reference's
pressured trace (`benchmarks/hybrid_serving.pressured_vs_oracle`'s recipe,
written out: 5 requests with 6 frames each, 8 greedy tokens, 4 slots, a
budget of ~2.5 requests' state + 40 tokens of KV shrunk to 60% at decode
step 4) under BF16_ROLLOUT with `eos_id=None`: the accounting must be
equal exactly, tokens up to a near-tie; the port's preempted run equals
its roomy run bit for bit (one intra-op thread).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precision as jp  # noqa: E402
from repro.core.fp8_params import quantize_params as jquantize  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import engine as jengine_mod  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import kv_cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.data import tasks as ttasks  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.rl import SamplerConfig as TSampler  # noqa: E402
from repro_torch.rl import generate as tgenerate  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CrashFault,
    FaultInjector,
    FaultPlan,
    ServingEngine,
    ServingFrontend,
    kv_bytes_per_token,
    request_state_bytes,
)

jax.config.update("jax_platform_name", "cpu")

ATTN_ATOL_W8A8, ATTN_ATOL_FULL_FP8 = 0.05, 0.15
ENC_ATOL_BF16, ENC_ATOL_W8A8 = 0.05, 0.25
LOGIT_ATOL = 0.5
PRECISIONS = {"bf16": (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT),
              "w8a8": (jp.PrecisionConfig(), tp.PrecisionConfig())}
SRC = 6


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, {precision: (reference
    rollout params, port rollout params)})."""
    jcfg, tcfg = jconfigs.tiny_encdec_serving_config(), tconfigs.tiny_encdec_serving_config()
    params = jax.jit(init_params, static_argnums=0)(jcfg, jax.random.key(0))
    rolls = {"bf16": (params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))}
    jroll = jax.jit(lambda p: jquantize(p, jp.PrecisionConfig()))(params)
    rolls["w8a8"] = (jroll, params_from_numpy(jax.tree.map(np.asarray, jroll), "cpu"))
    return jcfg, tcfg, params, rolls


def _frames(b, s, d, seed=0):
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _raw(x):
    return x.contiguous().view(torch.uint8).numpy()


def _jraw(a):
    return np.asarray(a).view(np.uint8)


# ---------------------------------------------------------------------------
# cross attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calibrate", [True, False], ids=["calibrated", "seeded"])
def test_cross_attention_cache_bit_equal(model, calibrate):
    """Cross K/V quantized once: payload and per-tensor scales bit-equal,
    recalibrated from their amax, or kept at the seeded (pool-wide)
    scales when `calculate_kv_scales` is off."""
    jcfg, tcfg, _, _ = model
    d, kvd = jcfg.d_model, jcfg.n_kv_heads * jcfg.d_head
    sel = np.zeros((d, kvd), np.float32)
    sel[np.arange(kvd) * 2 % d, np.arange(kvd)] = 1.0
    p = {"wk": sel, "wv": np.roll(sel, 1, axis=0)}
    jprec = jp.FP8_KV_ONLY_ROLLOUT.replace(calculate_kv_scales=calibrate)
    tprec = tp.FP8_KV_ONLY_ROLLOUT.replace(calculate_kv_scales=calibrate)
    jx, tx = _frames(2, SRC, d, seed=3)
    jp_ = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp_ = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    seed = (jnp.float32(0.01), jnp.float32(0.02))
    jc = jax.jit(lambda x, p: jattn.cross_attention_cache(
        x, p, jcfg, jprec, k_scale=seed[0], v_scale=seed[1]))(jx, jp_)
    cache = tattn.init_kv_cache(2, SRC, jcfg.n_kv_heads, jcfg.d_head, tprec, repeats=1,
                                device="cpu").layer(0)
    cache.k_scale.fill_(0.01)
    cache.v_scale.fill_(0.02)
    tc = tattn.cross_attention_cache(tx, tp_, tcfg, tprec, cache)
    assert tc is cache
    for f in ("k", "v"):
        np.testing.assert_array_equal(_raw(getattr(tc, f)), _jraw(getattr(jc, f)))
    for f in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    assert (np.float32(tc.k_scale.item()) != np.float32(0.01)) == calibrate


@pytest.mark.parametrize("prec", ["w8a8", "full_fp8"])
def test_cross_attention_decode_matches_reference(model, prec):
    """One layer's cross attention over a bridged cross cache (keys past
    `src_lengths` masked), the QDQ branch under FULL_FP8_ROLLOUT."""
    jcfg, tcfg, _, rolls = model
    jprec, tprec = (jp.PrecisionConfig(), tp.PrecisionConfig()) if prec == "w8a8" else \
        (jp.FULL_FP8_ROLLOUT, tp.FULL_FP8_ROLLOUT)
    jroll, troll = rolls["w8a8"]
    jpc = jax.tree.map(lambda a: a[0], jroll["blocks"]["s0"]["cross"])
    tpc = ttr._layer(troll["blocks"]["s0"]["cross"], 0)
    jenc, _ = _frames(2, SRC, jcfg.d_model, seed=4)
    jc = jax.jit(lambda e, p: jattn.cross_attention_cache(e, p, jcfg, jprec))(jenc, jpc)
    tc = kv_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    jx, tx = _frames(2, 3, jcfg.d_model, seed=5)
    src = np.array([SRC, 4], np.int32)
    want = jax.jit(lambda x, p, c, s: jattn.cross_attention_decode(x, p, jcfg, c, s, jprec))(
        jx, jpc, jc, jnp.asarray(src))
    got = tattn.cross_attention_decode(tx, tpc, tcfg, tc, torch.from_numpy(src), tprec)
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    print(f"\ncross decode {prec}: max abs err {err:.5f}, max|y| "
          f"{np.abs(np.asarray(want, np.float32)).max():.3f}")
    assert err <= (ATTN_ATOL_W8A8 if prec == "w8a8" else ATTN_ATOL_FULL_FP8)


@pytest.mark.parametrize("name", ["bf16", "w8a8"])
def test_encode_matches_reference(model, name):
    """The bidirectional encoder over frames projected by w_patch, padded
    rows masked by `src_lengths`."""
    jcfg, tcfg, _, rolls = model
    jprec, tprec = PRECISIONS[name]
    jroll, troll = rolls[name]
    jx, tx = _frames(2, SRC, jcfg.d_model, seed=6)
    src = np.array([SRC, 3], np.int32)
    want = jax.jit(lambda p, x, s: jtr._encode(p, x, jcfg, jprec, s))(jroll, jx, jnp.asarray(src))
    got = ttr._encode(troll, tx, tcfg, tprec, torch.from_numpy(src))
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    print(f"\n_encode {name}: max abs err {err:.5f}")
    assert err <= (ENC_ATOL_BF16 if name == "bf16" else ENC_ATOL_W8A8)


# ---------------------------------------------------------------------------
# the model: forward_train, prefill + decode, generate
# ---------------------------------------------------------------------------

def _inputs(jcfg, b=2, t=7):
    rng = np.random.default_rng(11)
    tokens = rng.integers(4, jcfg.vocab_size, (b, t)).astype(np.int32)
    lengths = np.array([t, t - 2], np.int32)[:b]
    src = np.array([SRC, 4], np.int32)[:b]
    jx, tx = _frames(b, SRC, jcfg.d_model, seed=12)
    j = {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths),
         "frames": jx, "src_lengths": jnp.asarray(src)}
    t_ = {"tokens": torch.from_numpy(tokens), "lengths": torch.from_numpy(lengths),
          "frames": tx, "src_lengths": torch.from_numpy(src)}
    return j, t_


def _close(want, got, what):
    err = np.abs(np.asarray(want, np.float32) - got.float().numpy()).max()
    print(f"\n{what}: max abs err {err:.4f}")
    assert err <= LOGIT_ATOL, what
    return err


@pytest.mark.parametrize("name", ["bf16", "w8a8"])
def test_forward_train_and_token_logprobs_match_reference(model, name):
    jcfg, tcfg, _, rolls = model
    jprec, tprec = PRECISIONS[name]
    jroll, troll = rolls[name]
    jin, tin = _inputs(jcfg)
    jin.pop("lengths")
    tin.pop("lengths")
    want = jax.jit(lambda p, i: jtr.token_logprobs(p, i, jcfg, jprec)[0])(jroll, jin)
    with torch.no_grad():
        got, aux = ttr.token_logprobs(troll, tin, tcfg, tprec)
    assert "prefix_len" not in aux and got.shape == (2, 6)
    _close(want, got, f"token_logprobs {name}")


def test_prefill_and_decode_match_reference(model, page_size=4):
    """W8A8 + FP8 KV on a paged cache (the contiguous one: the launchers'
    test and test_torch_vlm.py): the prefill's logits and calibrated
    cross scales, then 3 greedy decode steps (the reference's tokens fed
    to both)."""
    jcfg, tcfg, _, rolls = model
    jroll, troll = rolls["w8a8"]
    jprec, tprec = jp.PrecisionConfig(), tp.PrecisionConfig()
    jin, tin = _inputs(jcfg)
    jcache = jtr.init_cache(jcfg, 2, 12, jprec, src_len=SRC, page_size=page_size)
    jlog, jcache = jax.jit(lambda p, i, c: jtr.prefill(p, i, c, jcfg, jprec))(
        jroll, jin, jcache)
    m = Transformer(tcfg, "cpu")
    tcache = m.init_cache(2, 12, tprec, page_size=page_size, src_len=SRC)
    with torch.no_grad():
        tlog, tcache = m.prefill(troll, tin, tcache, tprec)
        _close(jlog, tlog, "prefill")
        np.testing.assert_array_equal(tcache["src_lengths"].numpy(), [SRC, 4])
        for name, sd in tcache["slots"].items():
            jcr = jcache["slots"][name]["cross"]
            np.testing.assert_allclose(sd["cross"].k_scale.numpy(), np.asarray(jcr.k_scale),
                                       rtol=0.05)
        jstep = jax.jit(lambda p, t, c: jtr.decode_step(p, t, c, jcfg, jprec)[:2])
        tok = jnp.argmax(jlog, -1)
        for i in range(3):
            jl, jcache = jstep(jroll, tok, jcache)
            tl, tcache = m.decode_step(troll, torch.from_numpy(np.array(tok)), tcache, tprec)
            _close(jl, tl, f"decode step {i}")
            tok = jnp.argmax(jl, -1)


def _equal_prefix(tokens, want, gaps):
    for i, (a, b) in enumerate(zip(tokens, want)):
        if a != b:
            assert gaps[i] < 2 * LOGIT_ATOL, (i, gaps[i])
            return i
    return len(want)


def test_generate_matches_reference(model, group=2):
    """Greedy `generate` with frames through the GRPO fork (group 2: the
    prompts prefilled once, cross caches and source lengths tiled 2-fold)
    against the reference's: tokens equal up to a near-tie, logprobs
    within LOGIT_ATOL there; a group's greedy samples are one sample."""
    jcfg, tcfg, _, rolls = model
    jroll, troll = rolls["w8a8"]
    jprec, tprec = jp.PrecisionConfig(), tp.PrecisionConfig()
    jin, tin = _inputs(jcfg)
    g = 5
    jt = jrollout.generate(jroll, jin["tokens"], jin["lengths"], jax.random.key(0), jcfg, jprec,
                           jrollout.SamplerConfig(max_new_tokens=g, temperature=0.0),
                           extra_inputs={"frames": jin["frames"],
                                         "src_lengths": jin["src_lengths"]},
                           page_size=4, num_samples_per_prompt=group)
    tt = tgenerate(troll, tin["tokens"], tin["lengths"], None, tcfg, tprec,
                   TSampler(max_new_tokens=g, temperature=0.0), page_size=4,
                   num_samples_per_prompt=group,
                   extra_inputs={"frames": tin["frames"], "src_lengths": tin["src_lengths"]},
                   device="cpu")
    jtok, jlp = np.asarray(jt.response_tokens), np.asarray(jt.rollout_logps)
    assert tt.response_tokens.shape == jtok.shape == (2 * group, g)
    # the port's own logits along the reference's tokens give each step's gap
    packed = torch.from_numpy(np.array(jrollout.packed_sequences(jt)))
    reps = {k: torch.repeat_interleave(tin[k], group, dim=0) for k in ("frames", "src_lengths")}
    with torch.no_grad():
        logits, _ = ttr.forward_train(troll, {"tokens": packed, **reps}, tcfg, tprec)
    equal = worst = 0
    lengths = tin["lengths"].numpy()
    for row in range(2 * group):
        lo = int(lengths[row // group]) - 1
        top2 = logits[row, lo:lo + g].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).numpy()
        n = _equal_prefix(tt.response_tokens[row].tolist(), jtok[row].tolist(), gaps)
        equal += n
        if n:
            worst = max(worst, float(np.abs(tt.rollout_logps[row, :n].numpy()
                                            - jlp[row, :n]).max()))
    if group > 1:
        assert torch.equal(tt.response_tokens[0], tt.response_tokens[1])
    print(f"\ngenerate group {group}: {equal} of {2 * group * g} tokens equal, logp gap "
          f"{worst:.4f}")
    assert equal >= group * g and worst <= LOGIT_ATOL


# ---------------------------------------------------------------------------
# the engine against the reference's engine
# ---------------------------------------------------------------------------

_JIT_PREFILL = jax.jit(jengine_mod.prefill, static_argnums=(3, 4),
                       static_argnames=("want_routing", "remat"))
_JIT_DECODE = jax.jit(jengine_mod.decode_step, static_argnums=(3, 4),
                      static_argnames=("want_routing", "use_kernel"))


def _engine(cls, params, cfg, budget_bytes, **kw):
    prec = jp.BF16_ROLLOUT if cls is JEngine else tp.BF16_ROLLOUT
    eng = cls(params, cfg, prec, max_slots=4, max_seq_len=48, admission="ondemand",
              eos_id=None, kv_budget_bytes=budget_bytes, **kw)
    for i in range(5):
        eng.submit(jtasks.random_prompt(i, 5 + i % 5), max_new=8, rid=i,
                   frames=jtasks.random_frames(100 + i, SRC, cfg.d_model))
    return eng


def _drive(eng, shrink_at=None):
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
    state = request_state_bytes(tcfg, tp.BF16_ROLLOUT, src_len=8)
    return per * 4 * 200 + 16 * state, per * 4 * 10 + int(2.5 * state)


@pytest.mark.parametrize("run", ["roomy", "tight"])
def test_engine_matches_reference(model, run, monkeypatch):
    """The pressured trace (tight: preemptions, the victims' cross rows to
    the host and back) and its roomy oracle, port vs reference engine:
    accounting equal, tokens equal up to a near-tie of the reference's
    logits; the port's tight run equals its roomy run bit for bit."""
    jcfg, tcfg, params, rolls = model
    monkeypatch.setattr(jengine_mod, "prefill", _JIT_PREFILL)
    monkeypatch.setattr(jengine_mod, "decode_step", _JIT_DECODE)
    gaps, rows = {}, {}
    sample = jengine_mod.sample

    def rec_sample(logits, *args, **kw):
        top = np.sort(np.asarray(logits, np.float32), axis=-1)[..., ::-1]
        rows["gap"] = top[..., 0] - top[..., 1]
        return sample(logits, *args, **kw)
    monkeypatch.setattr(jengine_mod, "sample", rec_sample)
    roomy, tight = _budgets(tcfg)
    budget, shrink = (roomy, None) if run == "roomy" else (tight, 4)
    jeng = _engine(JEngine, params, jcfg, budget)
    real_commit, real_decode = jeng._commit_first_token, jeng._exec_decode

    def commit(req, tok, logp, slot):
        gaps[(req.rid, 0)] = float(rows["gap"])
        return real_commit(req, tok, logp, slot)

    def decode(slots):
        before = {i: (jeng.slot_req[i].rid, len(jeng.slot_req[i].generated))
                  for i in slots if jeng.slot_req[i] is not None}
        real_decode(slots)
        for i, (rid, n) in before.items():
            gaps[(rid, n)] = float(rows["gap"][i])
    jeng._commit_first_token, jeng._exec_decode = commit, decode
    ref = _drive(jeng, shrink)
    port_eng = _engine(ServingEngine, rolls["bf16"][1], tcfg, budget, device="cpu")
    assert not port_eng.block_mgr.enable_prefix_sharing
    port = _drive(port_eng, shrink)
    for key in ("steps", "preemptions", "swap_outs", "swap_ins", "wasted_tokens", "emitted",
                "gauge"):
        assert port[key] == ref[key], key
    assert sorted(port["tokens"]) == sorted(ref["tokens"]) == list(range(5))
    equal = 0
    for rid, want in ref["tokens"].items():
        for i, (a, b) in enumerate(zip(port["tokens"][rid], want)):
            if a != b:
                assert gaps[(rid, i)] < 2 * LOGIT_ATOL, (rid, i)
                break
            equal += 1
    print(f"\nengine {run}: {equal} of 40 tokens equal; preemptions {port['preemptions']}, "
          f"swap-ins {port['swap_ins']}, wasted {port['wasted_tokens']}")
    if run == "tight":
        assert port["preemptions"] >= 1 and port["swap_ins"] >= 1
        oracle = _drive(_engine(ServingEngine, rolls["bf16"][1], tcfg, roomy, device="cpu"))
        assert oracle["preemptions"] == 0
        assert port["tokens"] == oracle["tokens"]     # bit for bit after the swaps


def test_engine_frames_rules(model):
    """The reference's enc-dec engine rules: frames required and checked,
    no chunked prefill, prefix sharing and speculation off, the same
    prompt with other frames decodes otherwise, the cross scales
    calibrated by the first prefill and kept, cross KV priced into the
    state bytes (FP8 halves it)."""
    _, tcfg, _, rolls = model
    troll = rolls["bf16"][1]
    eng = ServingEngine(troll, tcfg, tp.BF16_ROLLOUT, max_slots=2, max_seq_len=32,
                        max_src_len=8, device="cpu")
    frames = ttasks.random_frames
    with pytest.raises(ValueError, match="frames"):
        eng.submit(jtasks.random_prompt(0, 5), max_new=4)
    with pytest.raises(ValueError, match="d_model"):
        eng.submit(jtasks.random_prompt(0, 5), max_new=4,
                   frames=np.zeros((4, tcfg.d_model + 1), np.float32))
    with pytest.raises(ValueError, match="max_src_len"):
        eng.submit(jtasks.random_prompt(0, 5), max_new=4,
                   frames=np.zeros((9, tcfg.d_model), np.float32))
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(troll, tcfg, tp.BF16_ROLLOUT, prefill_chunk=4, device="cpu")
    assert not eng._spec_ok and not eng._chunk_skip_ok
    dense = tconfigs.tiny_serving_config()
    dense_eng = ServingEngine(Transformer(dense, "cpu").init_params(0), dense,
                              tp.BF16_ROLLOUT, max_slots=2, max_seq_len=32, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        dense_eng.submit(jtasks.random_prompt(0, 5), max_new=4,
                         frames=np.zeros((4, dense.d_model), np.float32))
    prompt = jtasks.random_prompt(5, 8)
    eng = ServingEngine(troll, tcfg, tp.BF16_ROLLOUT, max_slots=2, max_seq_len=32,
                        eos_id=None, device="cpu")
    eng.submit(prompt, max_new=8, rid=0, frames=frames(1, 6, tcfg.d_model))
    eng.submit(prompt, max_new=8, rid=1, frames=frames(2, 6, tcfg.d_model))
    got = {r.rid: list(r.generated) for r in eng.run(max_steps=100).completed}
    assert got[0] != got[1]
    eng = ServingEngine(rolls["w8a8"][1], tcfg, tp.FP8_KV_ONLY_ROLLOUT, max_slots=2,
                        max_seq_len=32, eos_id=None, device="cpu")
    eng.submit(jtasks.random_prompt(0, 6), max_new=4, rid=0, frames=frames(3, 6, tcfg.d_model))
    eng.run(max_steps=50)
    s0 = eng.cache["slots"]["s0"]["cross"].k_scale.clone()
    assert bool((s0 > 0).all()) and bool((s0 != 1.0).all())
    eng.submit(jtasks.random_prompt(1, 6), max_new=4, rid=1, frames=frames(4, 6, tcfg.d_model))
    eng.run(max_steps=50)
    assert torch.equal(eng.cache["slots"]["s0"]["cross"].k_scale, s0) and len(eng.done) == 2
    jcfg = jconfigs.tiny_encdec_serving_config()
    from repro.serving import request_state_bytes as jbytes
    for jprec, tprec in ((jp.BF16_ROLLOUT, tp.BF16_ROLLOUT),
                         (jp.FP8_KV_ONLY_ROLLOUT, tp.FP8_KV_ONLY_ROLLOUT)):
        assert request_state_bytes(tcfg, tprec, src_len=8) == jbytes(jcfg, jprec, src_len=8) > 0
    assert request_state_bytes(tcfg, tp.BF16_ROLLOUT, src_len=8) == \
        2 * request_state_bytes(tcfg, tp.FP8_KV_ONLY_ROLLOUT, src_len=8)
    np.testing.assert_array_equal(ttasks.random_frames(3, 5, 8), jtasks.random_frames(3, 5, 8))


def test_frontend_carries_frames_through_failover(model):
    """Two replicas behind the front end, frames on every request; replica
    0 crashes after 3 steps and its requests replay on replica 1 with
    their frames: tokens equal the fault-free fleet's (bf16 cache)."""
    _, tcfg, _, rolls = model
    troll = rolls["bf16"][1]

    def fleet(faults=None):
        engines = [ServingEngine(troll, tcfg, tp.BF16_ROLLOUT, max_slots=4, max_seq_len=32,
                                 eos_id=None, faults=faults, device="cpu")
                   for _ in range(2)]
        fe = ServingFrontend(engines)
        for i in range(4):
            fe.submit(jtasks.random_prompt(20 + i, 6), max_new=6, rid=i,
                      frames=ttasks.random_frames(40 + i, 3 + i, tcfg.d_model))
        rep = fe.run(max_steps=200)
        return {o.rid: list(o.output.token_ids) for o in rep.outputs}, rep

    clean, _ = fleet()
    crashed, rep = fleet(FaultInjector(FaultPlan(crashes=(CrashFault(replica=0, step=3),))))
    assert rep.redispatches >= 1 and crashed == clean and len(clean) == 4


def test_launchers_and_specs():
    """`launch.serve --arch seamless-m4t-medium --reduced` serves synthetic
    frames; `launch.steps`' meta specs of the full config equal the
    reference's shapes (frames and src_lengths, cross caches over S), and
    its reduced prefill + serve steps run."""
    out = tserve.run(["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu",
                      "--precision", "default", "--requests", "4", "--max-new", "4",
                      "--slots", "2", "--src-pad", "6", "--budget-tokens", "40"])
    assert out["completed"] == 4 and not out["stalled"]
    reduced = tconfigs.get_config("seamless-m4t-medium").reduced(vocab_size=ttasks.VOCAB_SIZE)
    assert out["state_bytes_per_request"] == request_state_bytes(
        reduced, tp.PrecisionConfig(), src_len=6) > 0
    jcfg, tcfg = jconfigs.get_config("seamless-m4t-medium"), tconfigs.get_config(
        "seamless-m4t-medium")
    for j, t in ((jcfg, tcfg), (jconfigs.get_config("pixtral-12b"),
                                tconfigs.get_config("pixtral-12b")),
                 (jconfigs.tiny_encdec_serving_config(), tconfigs.tiny_encdec_serving_config())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
    shape = jconfigs.PREFILL_32K
    want = jsteps.input_specs(jcfg, shape)
    got = tsteps.input_specs(tcfg, shape)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    dshape = jconfigs.DECODE_32K
    jc = jsteps.cache_specs(jcfg, dshape, jp.PrecisionConfig())
    tc = tsteps.cache_specs(tcfg, dshape, tp.PrecisionConfig())
    for name, sd in tc["slots"].items():
        assert tuple(sd["cross"].k.shape) == tuple(jc["slots"][name]["cross"].k.shape)
        assert sd["cross"].k.dtype == torch.float8_e4m3fn
    assert tuple(tc["src_lengths"].shape) == tuple(jc["src_lengths"].shape)
    params = tsteps.param_specs(tcfg, tp.PrecisionConfig())
    assert tuple(params["frontend"]["w_patch"].data.shape) == (1024, 1024)
    assert tuple(params["enc"]["blocks"]["s0"]["attn"]["wq"].data.shape) == (12, 1024, 1024)
    small = tconfigs.tiny_encdec_serving_config()
    sshape = tconfigs.ShapeConfig("t", 8, 2, "prefill")
    roll = Transformer(small, "cpu").init_params(0)
    batch = {"tokens": torch.randint(4, 19, (2, 8), dtype=torch.int32),
             "lengths": torch.tensor([8, 5], dtype=torch.int32),
             "frames": _frames(2, 8, small.d_model)[1],
             "src_lengths": torch.tensor([8, 3], dtype=torch.int32)}
    with torch.no_grad():
        logits, cache = tsteps.make_prefill_step(small, sshape, tp.BF16_ROLLOUT, "cpu")(roll, batch)
        serve = tsteps.make_serve_step(small, tp.BF16_ROLLOUT, "cpu")
        logits, cache = serve(roll, logits.argmax(-1), cache)
    assert bool(torch.isfinite(logits).all()) and cache["max_length"] == 9
