"""Full FP8 in the port vs the JAX reference: `qdq`, the quantized
attention of FULL_FP8_ROLLOUT, `fp8_dot` and gradient profiling.

* `core.quant.qdq` / `qdq_weight`: bit-equal to the reference's jitted
  functions at E4M3 and E5M2, FP32 and UE8M0 scales, with D 80 (one padded
  tile) among the shapes.
* `_sdpa` and `_sdpa_chunked` under FULL_FP8_ROLLOUT (q, k, v and P QDQ'd)
  against the reference's jitted functions: within 2e-2, where the QDQ
  itself moves the outputs by about 0.2 (measured 0 to 4e-3: softmax and
  exp differ by f32 ulps, which now and then flip a bf16 or fp8 rounding
  of P).
* Which branch quantizes: the port's default choices (`decode_step`,
  `generate`, the engine, `launch.steps`) take the plain branch with the
  QDQ under `quantize_attention`, as the reference's defaults do; an
  explicit kernel request keeps the kernels (kernels 4-6 skip the QDQ, as
  the reference's kernel branches do), and an explicit `"all"` engine
  under FULL_FP8_ROLLOUT is bit-equal to one under `PrecisionConfig()`.
* `generate` and a default-kernel engine trace under FULL_FP8_ROLLOUT
  against the reference's: greedy tokens equal while the reference's
  top-2 logit gap is decisive (over twice the W8A8 logit tolerance 0.4 of
  test_torch_model.py), rollout logps within twice it.
* `fp8_dot` forward and its `jax.vjp` under both recipes, 2-D and 3-D x:
  within one bf16 rounding (rtol 2**-7 of the largest magnitude; measured:
  one element in a few thousand differs by one ulp, from f32 sum order).
* `tile_exceedance_stats` (fractions and amax exact, the mean's and the
  percentile's last bit free) and `grad_tap`.
* One update under E2E_FP8 equals one under FULL_FP8_ROLLOUT bit for bit:
  the trainer's scoring pass takes no precision, as the reference's
  (`src/repro/rl/trainer.py:398-399`), so `fp8_training` reaches no
  linear there.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import fp8_linear as jfl  # noqa: E402
from repro.core import grad_profile as jgp  # noqa: E402
from repro.core import precision as jp  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import engine as jengine_mod  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.core import fp8_linear as tfl  # noqa: E402
from repro_torch.core import grad_profile as tgp  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.config import KernelConfig  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.rl import rollout as trollout  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402
from repro_torch.rl import trainer as ttrainer  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATTN_ATOL = 2e-2
# logits under W8A8 + FP8 KV (test_torch_model.py); the attention QDQ is
# bit-equal and adds no gap of its own beyond the softmax ulps above
ATOL = 0.4
PAGE, MAX_NEW = 4, 8


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.tiny_serving_config()
    params = init_params(cfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jroll, _ = jsync(params, jp.FULL_FP8_ROLLOUT)
    troll, _ = tsync(tparams, tp.FULL_FP8_ROLLOUT)
    return cfg, tconfigs.tiny_serving_config(), jroll, troll


# ---------------------------------------------------------------------------
# qdq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["FP32", "UE8M0"])
@pytest.mark.parametrize("fp8", ["E4M3", "E5M2"])
def test_qdq_bit_equal_to_reference(fp8, fmt):
    rng = np.random.default_rng(3)
    for shape, dtype in (((3, 5, 80), jnp.bfloat16), ((2, 7, 4, 128), jnp.bfloat16),
                         ((4, 300), jnp.float32), ((6, 33), jnp.bfloat16)):
        x = rng.standard_normal(shape) * np.exp(rng.uniform(-8, 8, shape))
        x[0, :2] = 0.0                                   # an all-zero tile edge
        jx = jnp.asarray(x, dtype)
        want = jax.jit(lambda a: jq.qdq(a, fp8_dtype=getattr(jp, fp8),
                                        scale_format=jp.ScaleFormat[fmt]))(jx)
        got = tq.qdq(_t(jx), fp8_dtype=getattr(tp, fp8), scale_format=tp.ScaleFormat[fmt])
        assert got.dtype == _t(jx).dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        want_w = jax.jit(lambda a: jq.qdq_weight(a, jp.ScaleFormat[fmt], getattr(jp, fp8)))(jx)
        got_w = tq.qdq_weight(_t(jx), tp.ScaleFormat[fmt], getattr(tp, fp8))
        np.testing.assert_array_equal(got_w.float().numpy(), np.asarray(want_w, np.float32))


# ---------------------------------------------------------------------------
# the quantized attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,kvh,g,d", [(2, 37, 2, 2, 16), (2, 150, 1, 3, 80),
                                         (1, 20, 4, 1, 80)])
def test_sdpa_full_fp8_matches_reference(b, s, kvh, g, d):
    rng = np.random.default_rng(s)
    q = jnp.asarray(rng.standard_normal((b, s, kvh * g, d)) * 2, jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, s, kvh, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, s, kvh, d)), jnp.bfloat16)
    lengths = np.array([s, s - 5][:b], np.int32)
    ar = np.arange(s)
    mask = (ar[None, :] <= ar[:, None])[None] & (ar[None, :] < lengths[:, None])[:, None, :]
    valid = ar[None] < lengths[:, None]
    naive = jax.jit(lambda q, k, v, m, prec: jattn._sdpa(q, k, v, m, prec, None),
                    static_argnums=4)
    want = np.asarray(naive(q, k, v, jnp.asarray(mask), jp.FULL_FP8_ROLLOUT), np.float32)
    plain = np.asarray(naive(q, k, v, jnp.asarray(mask), jp.PrecisionConfig()), np.float32)
    got = tattn._sdpa(_t(q), _t(k), _t(v), torch.from_numpy(mask),
                      tp.FULL_FP8_ROLLOUT).float().numpy()
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL)
    assert np.abs(want - plain).max() > 5 * ATTN_ATOL        # the QDQ is there
    for chunk in (16, 64):
        chunked = jax.jit(lambda q, k, v, ln: jattn._sdpa_chunked(
            q, k, v, jp.FULL_FP8_ROLLOUT, None, lengths=ln, kv_chunk=chunk))
        want_c = np.asarray(chunked(q, k, v, jnp.asarray(lengths)), np.float32)
        got_c = tattn._sdpa_chunked(_t(q), _t(k), _t(v), lengths=torch.from_numpy(lengths),
                                    kv_chunk=chunk, precision=tp.FULL_FP8_ROLLOUT)
        np.testing.assert_allclose(got_c.float().numpy()[valid], want_c[valid],
                                   atol=ATTN_ATOL)


def test_kernel_config_resolve():
    assert KernelConfig.resolve(None, tp.PrecisionConfig()) == KernelConfig.parse("all")
    assert KernelConfig.resolve(None, tp.FULL_FP8_ROLLOUT) == KernelConfig()
    assert KernelConfig.resolve(None, tp.E2E_FP8) == KernelConfig()
    for spec in ("off", "decode", "prefill", "all"):
        for prec in (tp.PrecisionConfig(), tp.FULL_FP8_ROLLOUT):
            assert KernelConfig.resolve(spec, prec).name == spec


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(ops, name)
    monkeypatch.setattr(ops, name, lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


def test_defaults_take_the_qdq_branch_and_explicit_kernels_skip_it(setup, monkeypatch):
    """Kernels 4, 5 and 6 are reached by the port's defaults under
    `PrecisionConfig()` and by explicit requests only under
    FULL_FP8_ROLLOUT; the explicit requests compute what the port's
    `PrecisionConfig()` run computes (the kernels skip the QDQ)."""
    _, tcfg, _, troll = setup
    paged = _count_calls(monkeypatch, "fp8_paged_decode_attention")
    chunk = _count_calls(monkeypatch, "fp8_paged_prefill_attention")
    contig = _count_calls(monkeypatch, "fp8_decode_attention")
    prompts = np.array([[1, 5, 6, 7, 8, 9]], np.int32)
    lens = np.array([6], np.int32)
    samp = trollout.SamplerConfig(max_new_tokens=3, temperature=0.0)
    runs = {}
    for prec in (tp.PrecisionConfig(), tp.FULL_FP8_ROLLOUT):
        paged.clear()
        runs[prec.quantize_attention] = trollout.generate(
            troll, prompts, lens, None, tcfg, prec, samp, page_size=PAGE, device="cpu")
        assert bool(paged) != prec.quantize_attention
    assert not torch.equal(runs[True].rollout_logps, runs[False].rollout_logps)
    # a decode step asked for the kernel takes it under FULL_FP8 too, and
    # then equals the PrecisionConfig() step bit for bit
    model = Transformer(tcfg, "cpu")
    logits = {}
    for prec, use_kernel in ((tp.PrecisionConfig(), None), (tp.FULL_FP8_ROLLOUT, True),
                             (tp.FULL_FP8_ROLLOUT, None)):
        cache = model.init_cache(1, 12, prec, page_size=PAGE)
        _, cache = model.prefill(troll, {"tokens": torch.from_numpy(prompts),
                                         "lengths": torch.from_numpy(lens)}, cache,
                                 tp.PrecisionConfig())
        paged.clear()
        logits[(prec.quantize_attention, use_kernel)], _ = model.decode_step(
            troll, torch.tensor([4]), cache, prec, use_kernel=use_kernel)
        assert bool(paged) == (use_kernel is not None or not prec.quantize_attention)
    assert torch.equal(logits[(True, True)], logits[(False, None)])
    assert not torch.equal(logits[(True, None)], logits[(False, None)])
    # the contiguous serve step of launch.steps
    for prec in (tp.PrecisionConfig(), tp.FULL_FP8_ROLLOUT):
        contig.clear()
        cache = model.init_cache(1, 12, prec)
        _, cache = model.prefill(troll, {"tokens": torch.from_numpy(prompts),
                                         "lengths": torch.from_numpy(lens)}, cache, prec)
        tsteps.make_serve_step(tcfg, prec, device="cpu")(troll, torch.tensor([4]), cache)
        assert bool(contig) != prec.quantize_attention
    # the engine: default "off" under FULL_FP8, an explicit "all" equal to
    # PrecisionConfig()'s default run
    trace = [(jtasks.random_prompt(s, 5 + s), 5) for s in range(3)]
    outs = {}
    for prec, kc in ((tp.PrecisionConfig(), None), (tp.FULL_FP8_ROLLOUT, "all"),
                     (tp.FULL_FP8_ROLLOUT, None)):
        paged.clear()
        chunk.clear()
        eng = ServingEngine(troll, tcfg, prec, device="cpu", kernel_config=kc,
                            max_slots=2, max_seq_len=32, prefill_chunk=4, eos_id=None,
                            want_logps=True)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, max_new=n, rid=i)
        rep = eng.run(max_steps=200)
        outs[(prec.quantize_attention, kc)] = {
            r.rid: (r.generated, r.token_logps) for r in rep.completed}
        kernels = kc is not None or not prec.quantize_attention
        assert bool(paged) == bool(chunk) == kernels
    assert outs[(True, "all")] == outs[(False, None)]
    assert outs[(True, None)] != outs[(False, None)]


def _reference_step_logits(roll, cfg, prec, prompts, lens, tokens):
    """The reference's logits behind each greedy token: (steps, N, V)."""
    cache = init_cache(cfg, len(prompts), prompts.shape[1] + MAX_NEW + 1, prec,
                       page_size=PAGE)
    step = jax.jit(lambda p, t, c: decode_step(p, t, c, cfg, prec)[:2])
    logits, cache = jax.jit(lambda p, i, c: prefill(p, i, c, cfg, prec))(
        roll, {"tokens": jnp.asarray(prompts), "lengths": jnp.asarray(lens)}, cache)
    out = [np.asarray(logits)]
    for i in range(tokens.shape[1] - 1):
        logits, cache = step(roll, jnp.asarray(tokens[:, i]), cache)
        out.append(np.asarray(logits))
    return np.stack(out)


def _port_step_logits(roll, tcfg, prompts, lens, tokens):
    """The port's logits along the same tokens (teacher-forced replay)."""
    model = Transformer(tcfg, "cpu")
    cache = model.init_cache(len(prompts), prompts.shape[1] + MAX_NEW + 1,
                             tp.FULL_FP8_ROLLOUT, page_size=PAGE)
    logits, cache = model.prefill(roll, {"tokens": torch.from_numpy(prompts),
                                         "lengths": torch.from_numpy(lens)}, cache,
                                  tp.FULL_FP8_ROLLOUT)
    out = [logits.numpy()]
    for i in range(tokens.shape[1] - 1):
        logits, cache = model.decode_step(roll, torch.tensor(tokens[:, i]), cache,
                                          tp.FULL_FP8_ROLLOUT)
        out.append(logits.numpy())
    return np.stack(out)


def test_generate_full_fp8_matches_reference(setup):
    """Logits along the reference's greedy trajectory within ATOL at every
    step (measured 0.207); `generate`'s own tokens equal while decisive
    (on this tiny random model few steps are: top-2 gaps of 0-0.8)."""
    cfg, tcfg, jroll, troll = setup
    prompts = np.array([[1, 5, 6, 7, 8, 9, 10, 11], [1, 9, 10, 11, 12, 4, 0, 0]], np.int32)
    lens = np.array([8, 6], np.int32)
    jt = jrollout.generate(jroll, jnp.asarray(prompts), jnp.asarray(lens), jax.random.key(0),
                           cfg, jp.FULL_FP8_ROLLOUT,
                           jrollout.SamplerConfig(max_new_tokens=MAX_NEW, temperature=0.0),
                           page_size=PAGE)
    tt = trollout.generate(troll, prompts, lens, None, tcfg, tp.FULL_FP8_ROLLOUT,
                           trollout.SamplerConfig(max_new_tokens=MAX_NEW, temperature=0.0),
                           page_size=PAGE, device="cpu")
    j_tok = np.asarray(jt.response_tokens)
    t_tok = tt.response_tokens.numpy()
    logits = _reference_step_logits(jroll, cfg, jp.FULL_FP8_ROLLOUT, prompts, lens, j_tok)
    np.testing.assert_allclose(_port_step_logits(troll, tcfg, prompts, lens, j_tok),
                               logits, atol=ATOL)
    srt = np.sort(logits, axis=-1)
    decisive = (srt[..., -1] - srt[..., -2]) > 2 * ATOL
    for row in range(2):
        n_ok = MAX_NEW if decisive[:, row].all() else int(np.argmin(decisive[:, row]))
        np.testing.assert_array_equal(t_tok[row, :n_ok], j_tok[row, :n_ok])
        np.testing.assert_allclose(tt.rollout_logps.numpy()[row, :n_ok],
                                   np.asarray(jt.rollout_logps)[row, :n_ok], atol=2 * ATOL)
    np.testing.assert_allclose(tt.kv_scales["s0"]["k_scale"].numpy(),
                               np.asarray(jt.kv_scales["s0"]["k_scale"]), rtol=2 ** -5)


def test_engine_full_fp8_default_kernels_matches_reference(setup, monkeypatch):
    """Both engines with their default kernel choice (the reference's
    gather, the port's resolved "off"), chunked prefill, under
    FULL_FP8_ROLLOUT: the per-step accounting equal; greedy tokens equal
    while the reference's top-2 gap is decisive, and their logps within
    2 x ATOL up to the first token that differs.  The reference's model
    calls run jitted (eagerly each engine step recompiles its layer scan)."""
    cfg, tcfg, jroll, troll = setup
    monkeypatch.setattr(jengine_mod, "decode_step", jax.jit(
        jengine_mod.decode_step, static_argnums=(3, 4),
        static_argnames=("want_routing", "use_kernel")))
    monkeypatch.setattr(jengine_mod, "prefill_chunk", jax.jit(
        jengine_mod.prefill_chunk, static_argnums=(5, 6),
        static_argnames=("use_kernel", "want_all_logits")))
    trace = [(jtasks.random_prompt(s, 5 + 2 * s), 6) for s in range(4)]
    gaps, first, reps = {}, {}, []
    for engine, roll, c, prec, extra in ((JEngine, jroll, cfg, jp.FULL_FP8_ROLLOUT, {}),
                                         (ServingEngine, troll, tcfg, tp.FULL_FP8_ROLLOUT,
                                          {"device": "cpu"})):
        eng = engine(roll, c, prec, eos_id=None, max_slots=3, max_seq_len=32,
                     prefill_chunk=4, want_logps=True, **extra)
        if engine is JEngine:
            sample = jengine_mod.sample

            def rec_sample(logits, *args, eng=eng, **kw):
                arr = np.asarray(logits, np.float32)
                if arr.ndim == 1:
                    first["row"] = arr
                else:
                    for i, r in enumerate(eng.slot_req):
                        if r is not None and r.generated and r.prefilled >= len(r.prompt):
                            top = np.sort(arr[i])[::-1]
                            gaps[(r.rid, len(r.generated))] = top[0] - top[1]
                return sample(logits, *args, **kw)

            commit = eng._commit_first_token

            def rec_commit(req, tok, logp, slot, commit=commit):
                top = np.sort(first.pop("row"))[::-1]
                gaps[(req.rid, 0)] = top[0] - top[1]
                return commit(req, tok, logp, slot)

            monkeypatch.setattr(jengine_mod, "sample", rec_sample)
            monkeypatch.setattr(eng, "_commit_first_token", rec_commit)
        else:
            assert not eng.kernels.any
        for i, (p, n) in enumerate(trace):
            eng.submit(p, max_new=n, rid=i)
        accts = []
        while eng.queue or any(r is not None for r in eng.slot_req):
            accts.append(eng.step().accounting())
        reps.append((accts, {r.rid: (list(r.generated), list(r.token_logps))
                             for r in eng.run().completed}))
    (jaccts, jout), (taccts, tout) = reps
    assert taccts == jaccts
    compared = 0
    for rid, (want, want_lp) in jout.items():
        got, got_lp = tout[rid]
        n_eq = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(want))
        if n_eq < len(want):
            assert gaps[(rid, n_eq)] < 2 * ATOL, (rid, n_eq, gaps[(rid, n_eq)])
        np.testing.assert_allclose(got_lp[:n_eq + 1], want_lp[:n_eq + 1], atol=2 * ATOL)
        compared += n_eq + 1
    print(f"{compared} token logps compared")


# ---------------------------------------------------------------------------
# fp8_dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", ["HYBRID", "E4M3"])
@pytest.mark.parametrize("xshape,n", [((24, 256), 384), ((3, 5, 200), 130)])
def test_fp8_dot_forward_and_vjp_match_reference(recipe, xshape, n):
    rng = np.random.default_rng(n)
    k = xshape[-1]
    x = jnp.asarray(rng.standard_normal(xshape), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal(xshape[:-1] + (n,))
                    * np.exp(rng.uniform(-6, 2, xshape[:-1] + (n,))), jnp.bfloat16)

    def run(a, b, gg):
        y, vjp = jax.vjp(lambda a, b: jfl.fp8_dot(a, b, jp.Fp8Recipe[recipe]), a, b)
        return (y,) + vjp(gg)

    want = [np.asarray(t, np.float32) for t in jax.jit(run)(x, w, g)]
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = tfl.linear(tx, tw, precision=tp.E2E_FP8.replace(recipe=tp.Fp8Recipe[recipe]))
    y.backward(_t(g))
    for name, a, b in (("y", want[0], y), ("dx", want[1], tx.grad), ("dw", want[2], tw.grad)):
        assert b.dtype == torch.bfloat16 and b.shape == a.shape, name
        np.testing.assert_allclose(b.detach().float().numpy(), a, rtol=0,
                                   atol=2 ** -7 * np.abs(a).max(), err_msg=name)


# ---------------------------------------------------------------------------
# gradient profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_scale", [None, 0.01])
@pytest.mark.parametrize("fp8", ["E4M3", "E5M2"])
def test_tile_exceedance_stats_match_reference(fp8, ref_scale):
    rng = np.random.default_rng(1)
    for shape, tile in (((4, 6, 300), 128), ((16, 256), 128), ((5, 80), 32)):
        g = rng.standard_normal(shape) * np.exp(rng.uniform(-14, 4, shape))
        g[0, :3] = 0.0
        jg = jnp.asarray(g, jnp.bfloat16)
        rs = None if ref_scale is None else jnp.float32(ref_scale)
        want = jax.jit(lambda a: jgp.tile_exceedance_stats(a, getattr(jp, fp8), tile, rs))(jg)
        got = tgp.tile_exceedance_stats(
            _t(jg), getattr(tp, fp8), tile,
            None if ref_scale is None else torch.tensor(ref_scale))
        for field in tgp.TileStats._fields:
            a, b = float(getattr(want, field)), float(getattr(got, field))
            if field in ("underflow_frac", "loss_frac", "amax"):
                assert a == b, field
            else:
                assert b == pytest.approx(a, rel=1e-6, abs=1e-7), field


def test_grad_tap_records_the_grad_output():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    x = rng.standard_normal((3, 8)).astype(np.float32)

    def jloss(taps):
        y = jgp.grad_tap(jnp.tanh(jnp.asarray(x) @ w), taps, "fc1")
        y = jgp.grad_tap(y * 2.0, taps, "fc2")
        return (y ** 3).sum()

    jtaps = {}
    jloss(jtaps)
    want = jax.grad(jloss)(jtaps)
    taps = {}
    h = torch.tanh(torch.from_numpy(x) @ torch.from_numpy(w)).requires_grad_(True)
    y = tgp.grad_tap(h, taps, "fc1")
    y = tgp.grad_tap(y * 2.0, taps, "fc2")
    assert torch.equal(y, h.detach() * 2.0)
    (y ** 3).sum().backward()
    for name in ("fc1", "fc2"):
        np.testing.assert_allclose(taps[name].numpy(), np.asarray(want[name]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the trainer: E2E_FP8 trains as FULL_FP8_ROLLOUT does
# ---------------------------------------------------------------------------

def test_e2e_fp8_update_equals_full_fp8_update():
    tcfg = tconfigs.tiny_serving_config()
    trainers = [ttrainer.RLTrainer(tcfg, ttrainer.RLConfig(
        precision=prec, prompt_batch=2, n_per_prompt=2, max_new_tokens=4, seed=0),
        device="cpu") for prec in (tp.FULL_FP8_ROLLOUT, tp.E2E_FP8)]
    rows = [tr.train_step() for tr in trainers]
    for key, val in rows[0].items():
        if not key.endswith(("_ms", "_s", "tokens_per_s")):
            assert rows[1][key] == val, key
    # one update with advantages drawn per GRPO group (random weights tie
    # every reward), on the same batch
    batch = dict(trainers[0].last_update_batch)
    batch["advantages"] = torch.tensor([1.0, -1.0, 0.5, -0.5])
    batch["mask"] = batch["response_mask"]
    stats = [tr.update_fn(tr.params, tr.opt_state, batch)[2] for tr in trainers]
    assert float(stats[0]["grad_norm"]) > 0
    for k in stats[0]:
        assert torch.equal(stats[0][k], stats[1][k]), k
    for a, b in zip(ttrainer.tree_leaves(trainers[0].params),
                    ttrainer.tree_leaves(trainers[1].params)):
        assert torch.equal(a, b)
