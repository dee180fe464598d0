"""The port's MoE slice (`models.moe`, the router casts, routing capture,
the aux loss, the expert-batched kernel-3 path) vs the JAX reference.

Parameters: `repro.models.init_params` of a reduced granite-moe-3b-a800m
(tasks vocab, 2 layers, d_model 128, 4 experts top-2, d_ff 256, the
reduced rule's dropless capacity factor 8), bridged with
`params_from_numpy`; inputs are made with numpy from a seed.  The
reference runs jitted (its compiled form).  Tolerances, measured on this
CPU (run with `-s` to print the gaps):

* `moe_forward` under the reference's own routing (its `topk_idx` passed
  as `forced_topk_idx`), outputs up to |8.8|: with bf16 linears (bf16,
  FP32 and FP8 routers) within MOE_RTOL_BF16 = 2**-7 of the largest
  output (measured 0.0036 of it, one bf16 ulp at |y| 4-8, from bf16 router
  logits one ulp apart; 0.00045 with the f32 router); under W8A8 (kernel
  3's exact fp8 products against the reference's dot of bf16-dequantized
  operands, then the fc2 input's re-quantization) within MOE_RTOL_W8A8 =
  0.04 of it (measured 0.021; mean error 0.023 against bf16's 0.0006).
  The dispatch (the slot of every unit, the kept units) and `dropped_frac`
  are equal at capacity factor 8 and at 1.25, where 1/6 of the units
  drop; the aux scalars within AUX_RTOL = 1e-2 relative (measured 2.1e-3,
  the logits' amax one bf16 ulp apart; the others at most 1e-4).
* free routing: the port's `topk_idx` equals the reference's on every
  decisive token, one whose K-th and (K+1)-th router probabilities are
  more than ROUTE_MARGIN = 1e-3 apart (bf16 logits may differ by one ulp,
  which moves a probability by at most ~4e-4 here).
* the stable top-k on planted ties: indices equal to `jax.lax.top_k`'s.
* `forward_train` logits within 0.08 (test_torch_model.py's bf16 logits
  tolerance) under forced routing, every aux leaf stacked (R,) and within
  1e-2 relative + 1e-3; routing equal on decisive tokens.
* `generate(want_routing=True)`: the reference's layout, routing equal to
  the reference's prefill routing on decisive tokens.
* one engine trace (W8A8 + FP8 KV, chunked prefill, kernel config "all")
  against the reference's engine, tokens equal up to a near-tie as in
  test_torch_serving.py.
* one update with `moe_aux_coef` against the reference's jitted
  `update_fn`, with test_torch_train.py's bounds.
* `quantize_params`' router casts bit-equal, and the reference's synced
  MoE tree (f32 and FP8 routers) bridged bit for bit; the launchers' `--arch
  granite-moe-3b-a800m --reduced --rrr`; meta specs of qwen3-30b-a3b and
  grok-1-314b against the reference's shapes.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import precision as jp  # noqa: E402
from repro.core.fp8_params import quantize_params as jquantize_params  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro.models import forward_train as jforward_train  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro.rl import trainer as jtrainer  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import engine as jengine_mod  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.core.fp8_params import quantize_params as tquantize_params  # noqa: E402
from repro_torch.core.fp8_params import tree_leaves  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import forward_train as tforward_train  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import _layer  # noqa: E402
from repro_torch.optim import AdamWConfig as TAdamWConfig  # noqa: E402
from repro_torch.rl import SamplerConfig as TSampler  # noqa: E402
from repro_torch.rl import generate as tgenerate  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402
from repro_torch.rl import trainer as ttrainer  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

MOE_RTOL_BF16, MOE_RTOL_W8A8 = 2 ** -7, 0.04
AUX_RTOL = 1e-2
ROUTE_MARGIN = 1e-3
LOGIT_ATOL = 0.08
ENGINE_LOGIT_ATOL = 0.4    # W8A8 logits (test_torch_model.py's ATOL_W8A8)
STAT_RTOL, STAT_ATOL = 1e-2, 5e-3
LR = 3e-4
ARCH = "granite-moe-3b-a800m"
RD = jp.RouterDtype
# name -> (reference precision, port precision, output tolerance as a
# share of the largest output)
PRECISIONS = {
    "bf16": (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT, MOE_RTOL_BF16),
    "w8a8": (jp.PrecisionConfig(), tp.PrecisionConfig(), MOE_RTOL_W8A8),
    "router_fp32": (jp.BF16_ROLLOUT.replace(router_dtype=RD.FP32),
                    tp.BF16_ROLLOUT.replace(router_dtype=tp.RouterDtype.FP32), MOE_RTOL_BF16),
    "router_fp8": (jp.BF16_ROLLOUT.replace(router_dtype=RD.FP8),
                   tp.BF16_ROLLOUT.replace(router_dtype=tp.RouterDtype.FP8), MOE_RTOL_BF16),
}


def _cfgs(**kw):
    kw = dict(vocab_size=jtasks.VOCAB_SIZE, n_layers=2, **kw)
    return jget_config(ARCH).reduced(**kw), tconfigs.get_config(ARCH).reduced(**kw)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    params = init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float64)


def _decisive(probs, k, margin=ROUTE_MARGIN):
    """Tokens whose K-th and (K+1)-th router probabilities are more than
    `margin` apart (flattened rows of `probs` (N, E))."""
    top = np.sort(probs, axis=-1)[:, ::-1]
    return top[:, k - 1] - top[:, k] > margin


def _ref_probs(x, router, jcfg):
    xf = jnp.asarray(x).reshape(-1, jcfg.d_model)
    return np.asarray(jax.nn.softmax(jmoe.router_logits(xf, router), axis=-1))


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [8.0, 1.25])
@pytest.mark.parametrize("name", list(PRECISIONS))
def test_moe_forward_matches_reference(setup, name, capacity):
    jcfg, tcfg, params, np_params = setup
    jcfg, tcfg = _cfgs(capacity_factor=capacity)
    jprec, tprec, rtol = PRECISIONS[name]
    jroll, _ = jsync(params, jprec)
    troll, _ = tsync(params_from_numpy(np_params, "cpu"), tprec)
    jp0 = jax.tree.map(lambda a: a[0], jroll["blocks"]["s0"]["moe"])
    tp0 = _layer(troll["blocks"]["s0"]["moe"], 0)
    rng = np.random.default_rng(3)
    # a shared component over the tokens skews the routing, so that at
    # capacity factor 1.25 some experts overflow
    x = (rng.normal(size=(4, 24, jcfg.d_model)) + 1.5 * rng.normal(size=jcfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)

    def jfwd(x_, forced=None):
        return jmoe.moe_forward(x_, jp0, jcfg, jprec, forced_topk_idx=forced)
    jout, jaux = jax.jit(jfwd)(xj)
    jidx = np.asarray(jaux["topk_idx"])
    # under the reference's routing: the same dispatch, drops and outputs
    tout, taux = tmoe.moe_forward(xt, tp0, tcfg, tprec,
                                  forced_topk_idx=torch.from_numpy(jidx))
    err = np.abs(_np(tout) - _np(jout)).max() / np.abs(_np(jout)).max()
    for g_rows, t_rows in ((4, 24), (1, 96)):          # sequence rows; decode's one group
        idx = jidx.reshape(g_rows, t_rows, -1)
        cap = jmoe.group_capacity(t_rows, jcfg)
        want = jax.vmap(lambda ti: jmoe._dispatch_one_group(None, ti, cap, jcfg.n_experts))(
            jnp.asarray(idx))
        got = tmoe._dispatch(torch.from_numpy(idx).long(), cap, tcfg.n_experts)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    aux_err = {k: abs(float(taux[k]) / float(jaux[k]) - 1)
               for k in ("aux_loss", "router_entropy", "router_logits_amax")}
    # free routing: equal on decisive tokens
    free, faux = tmoe.moe_forward(xt, tp0, tcfg, tprec)
    decisive = _decisive(_ref_probs(xj, jp0["router"], jcfg), jcfg.top_k)
    tidx = faux["topk_idx"].numpy().reshape(-1, jcfg.top_k)
    same = (tidx == jidx.reshape(-1, jcfg.top_k)).all(-1)
    print(f"\n{name} capacity {capacity}: forced max|port - ref| / max|ref| {err:.4f} "
          f"(tol {rtol:.4f}); "
          f"dropped {float(jaux['dropped_frac']):.4f}; free routing equal on "
          f"{int(same[decisive].sum())} of {int(decisive.sum())} decisive tokens "
          f"({int(same.sum())} of {same.size} all); aux rel err {aux_err}")
    assert err <= rtol
    assert max(aux_err.values()) <= AUX_RTOL
    assert same[decisive].all()
    assert tout.dtype == torch.bfloat16 and taux["topk_idx"].shape == (4, 24, jcfg.top_k)
    if capacity == 1.25:
        assert float(jaux["dropped_frac"]) > 0       # the drop path ran


def test_top_k_ties_rank_the_lower_expert_first():
    rng = np.random.default_rng(0)
    # rows with planted ties: bf16-rounded values from a few levels
    probs = rng.choice(np.float32([0.5, 0.25, 0.125, 0.0625]), size=(64, 128))
    probs[:, ::7] = 0.5
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 8)
    got_v, got_i = tmoe.top_k(torch.from_numpy(probs), 8)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


def test_group_capacity_matches_reference():
    for full in ("qwen3-30b-a3b", "granite-moe-3b-a800m", "grok-1-314b"):
        jc, tc = jget_config(full), tconfigs.get_config(full)
        for n in (1, 7, 8, 64, 128, 1024):
            assert tmoe.group_capacity(n, tc) == jmoe.group_capacity(n, jc), (full, n)


# ---------------------------------------------------------------------------
# weight sync: router casts
# ---------------------------------------------------------------------------

def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
        return x.view(bits).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("router", ["bf16", "fp32", "fp8"])
@pytest.mark.parametrize("linears", [True, False], ids=["w8a8", "bf16"])
def test_quantize_params_router_casts_bit_equal(setup, router, linears):
    _, _, params, np_params = setup
    jprec = jp.PrecisionConfig(router_dtype=RD(router), quantize_linears=linears)
    tprec = tp.PrecisionConfig(router_dtype=tp.RouterDtype(router), quantize_linears=linears)
    jr = jax.jit(lambda p: jquantize_params(p, jprec))(params)["blocks"]["s0"]["moe"]
    tr = tquantize_params(params_from_numpy(np_params, "cpu"), tprec)["blocks"]["s0"]["moe"]
    for key in ("router", "fc1", "fc2"):
        j, t = jr[key], tr[key]
        assert isinstance(t, QuantizedTensor) == hasattr(j, "scales"), key
        if isinstance(t, QuantizedTensor):
            assert np.array_equal(_bits(t.data), _bits(j.data))
            assert np.array_equal(_bits(t.scales), _bits(j.scales))
        else:
            assert str(t.dtype).split(".")[-1] == str(j.dtype), key
            assert np.array_equal(_bits(t), _bits(j))
    # the sync skips only where nothing changes: bf16 router, no fp8
    troll, stats = tsync(params_from_numpy(np_params, "cpu"),
                         tp.BF16_ROLLOUT.replace(router_dtype=tp.RouterDtype(router)))
    assert (stats["sync_ms"] == 0.0) == (router == "bf16")
    got = troll["blocks"]["s0"]["moe"]["router"]
    if router == "fp8":
        assert isinstance(got, QuantizedTensor)
    else:
        assert got.dtype == {"bf16": torch.bfloat16, "fp32": torch.float32}[router]


@pytest.mark.parametrize("router", ["fp32", "fp8"])
def test_bridge_carries_moe_rollout_trees(setup, router):
    """`params_from_numpy` carries the reference's synced MoE tree across:
    an f32 router as f32, an FP8 router and the experts as
    `QuantizedTensor`s with the reference's bits (row-major, where the
    port's own sync stores K-major), and the layer computes the same
    function on either tree."""
    jcfg, tcfg, params, np_params = setup
    jprec = jp.PrecisionConfig(router_dtype=RD(router))
    tprec = tp.PrecisionConfig(router_dtype=tp.RouterDtype(router))
    jroll = jax.jit(lambda p: jquantize_params(p, jprec))(params)
    bridged = params_from_numpy(jax.tree.map(np.asarray, jroll), "cpu")
    own = tquantize_params(params_from_numpy(np_params, "cpu"), tprec)
    for key in ("router", "fc1", "fc2"):
        b, o = bridged["blocks"]["s0"]["moe"][key], own["blocks"]["s0"]["moe"][key]
        assert isinstance(b, QuantizedTensor) == isinstance(o, QuantizedTensor), key
        if isinstance(b, QuantizedTensor):
            assert b.block == o.block and np.array_equal(_bits(b.data), _bits(o.data))
            assert np.array_equal(_bits(b.scales), _bits(o.scales))
        else:
            assert b.dtype == o.dtype == torch.float32 and torch.equal(b, o)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 6, jcfg.d_model))).to(
        torch.bfloat16)
    yb, ab = tmoe.moe_forward(x, _layer(bridged["blocks"]["s0"]["moe"], 1), tcfg, tprec)
    yo, ao = tmoe.moe_forward(x, _layer(own["blocks"]["s0"]["moe"], 1), tcfg, tprec)
    assert torch.equal(yb, yo) and torch.equal(ab["topk_idx"], ao["topk_idx"])


# ---------------------------------------------------------------------------
# forward_train, generate, the engine
# ---------------------------------------------------------------------------

def _tokens(b, t, seed):
    return np.stack([jtasks.random_prompt(seed + i, t) for i in range(b)]).astype(np.int32)


def test_forward_train_aux_and_forced_routing_match_reference(setup):
    jcfg, tcfg, params, np_params = setup
    tokens = _tokens(3, 12, 40)
    tparams = params_from_numpy(np_params, "cpu")
    jl, jaux = jax.jit(lambda p, t: jforward_train(p, {"tokens": t}, jcfg, want_routing=True))(
        params, jnp.asarray(tokens))
    jroute = {k: np.asarray(v) for k, v in jaux["routing"].items()}
    forced = {k: torch.from_numpy(v) for k, v in jroute.items()}
    tl, taux = tforward_train(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg,
                              forced_routing=forced, want_routing=True)
    err = np.abs(_np(tl) - _np(jl)).max()
    assert set(taux) == set(jaux) == {"moe", "routing"}
    assert set(taux["moe"]) == set(jaux["moe"]) == {"s0"}
    worst = 0.0
    for k, want in jaux["moe"]["s0"].items():
        got = taux["moe"]["s0"][k]
        assert tuple(got.shape) == tuple(want.shape) == (2,), k
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-3, err_msg=k)
        worst = max(worst, float(np.abs(_np(got) - _np(want)).max()))
    assert torch.equal(taux["routing"]["s0"], forced["s0"].to(torch.int32))
    # free routing, with autograd on (each layer checkpointed): decisive
    # tokens route as the reference's
    with torch.enable_grad():
        leaves = list(tree_leaves(tparams))
        for p in leaves:
            p.requires_grad_(True)
        tl2, taux2 = tforward_train(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg,
                                    want_routing=True)
        tl2.float().sum().backward()
        for p in leaves:
            p.requires_grad_(False)
    got, want = taux2["routing"]["s0"].numpy(), jroute["s0"]
    same = (got == want).all(-1)
    print(f"\nforward_train: logits max|port - ref| {err:.4f} (forced), aux max diff "
          f"{worst:.2e}; free routing equal on {int(same.sum())} of {same.size} tokens")
    assert err <= LOGIT_ATOL
    # layer 0's router input is the embedding + attention: decisive tokens
    # must agree there
    jx = _layer0_router_probs(params, tokens, jcfg)
    assert same[0].reshape(-1)[_decisive(jx, jcfg.top_k)].all()


def _layer0_router_probs(params, tokens, jcfg):
    """The reference's layer-0 router probabilities of `tokens`, (N, E)."""
    from repro.models import attention as jattn
    from repro.models.common import rms_norm
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])["s0"]
    x = jnp.take(params["emb"], jnp.asarray(tokens), axis=0)

    def fn(x):
        pa = p0["attn"]
        h = jattn.attention_forward(rms_norm(x, pa["norm_scale"], jcfg.norm_eps), pa, jcfg,
                                    None, positions=jnp.arange(x.shape[1])[None, :])
        x = x + h
        xn = rms_norm(x, p0["moe"]["norm_scale"], jcfg.norm_eps)
        return jax.nn.softmax(jmoe.router_logits(xn.reshape(-1, jcfg.d_model),
                                                 p0["moe"]["router"]), axis=-1)
    return np.asarray(jax.jit(fn)(x))


@pytest.mark.parametrize("group", [1, 2])
def test_generate_routing_matches_reference_layout(setup, group):
    jcfg, tcfg, params, np_params = setup
    prompts = np.zeros((2, 6), np.int32)
    prompts[0, :6] = _tokens(1, 6, 60)[0]
    prompts[1, :4] = _tokens(1, 4, 61)[0]
    lengths = np.array([6, 4], np.int32)
    sampler = jrollout.SamplerConfig(max_new_tokens=4, temperature=0.0)
    jt = jrollout.generate(params, jnp.asarray(prompts), jnp.asarray(lengths),
                           jax.random.key(0), jcfg, jp.BF16_ROLLOUT, sampler,
                           want_routing=True, page_size=4, num_samples_per_prompt=group,
                           shared_prefix_blocks=1 if group > 1 else None)
    tt = tgenerate(params_from_numpy(np_params, "cpu"), prompts, lengths, None, tcfg,
                   tp.BF16_ROLLOUT, TSampler(max_new_tokens=4, temperature=0.0),
                   want_routing=True, page_size=4, num_samples_per_prompt=group,
                   shared_prefix_blocks=1 if group > 1 else None, device="cpu")
    for part in ("prefill", "decode"):
        assert set(tt.routing[part]) == set(jt.routing[part]) == {"s0"}
        got, want = tt.routing[part]["s0"], np.asarray(jt.routing[part]["s0"])
        assert tuple(got.shape) == want.shape and got.dtype == torch.int32, part
    assert tuple(tt.routing["prefill"]["s0"].shape) == (2, 2, 6, tcfg.top_k)   # (R, B, P, K)
    assert tuple(tt.routing["decode"]["s0"].shape) == (4, 2, 2 * group, 1, tcfg.top_k)
    # layer 0 of the prefill routes as the reference's on decisive tokens
    probs = _layer0_router_probs(params, prompts, jcfg)
    got = tt.routing["prefill"]["s0"][0].numpy().reshape(-1, tcfg.top_k)
    want = np.asarray(jt.routing["prefill"]["s0"][0]).reshape(-1, tcfg.top_k)
    valid = (np.arange(6)[None, :] < lengths[:, None]).reshape(-1)
    keep = valid & _decisive(probs, tcfg.top_k)
    assert (got == want).all(-1)[keep].all()
    # without MoE layers, or without asking, there is no routing
    assert tgenerate(params_from_numpy(np_params, "cpu"), prompts, lengths, None, tcfg,
                     tp.BF16_ROLLOUT, TSampler(max_new_tokens=2, temperature=0.0),
                     device="cpu").routing is None


@pytest.fixture
def jit_reference_engine():
    """The reference engine's model calls jitted (eagerly each step would
    compile its layer scan again)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine_mod, "decode_step", jax.jit(
            jengine_mod.decode_step, static_argnums=(3, 4),
            static_argnames=("want_routing", "use_kernel")))
        mp.setattr(jengine_mod, "prefill_chunk", jax.jit(
            jengine_mod.prefill_chunk, static_argnums=(5, 6),
            static_argnames=("use_kernel", "want_all_logits")))
        yield


def test_engine_trace_matches_reference(setup, jit_reference_engine, monkeypatch):
    jcfg, tcfg, params, np_params = setup
    jroll, _ = jsync(params, jp.PrecisionConfig())
    troll, _ = tsync(params_from_numpy(np_params, "cpu"), tp.PrecisionConfig())
    trace = [(jtasks.random_prompt(80 + i, n), m) for i, (n, m) in
             enumerate(((9, 5), (14, 4), (5, 6)))]
    gaps, first = {}, {}
    sample = jengine_mod.sample
    out = []
    for engine, roll, c, prec, extra in (
            (JEngine, jroll, jcfg, jp.PrecisionConfig(), {}),
            (ServingEngine, troll, tcfg, tp.PrecisionConfig(), {"device": "cpu"})):
        eng = engine(roll, c, prec, eos_id=None, max_slots=3, max_seq_len=32,
                     block_size=4, prefill_chunk=8, kernel_config="all", **extra)
        if engine is JEngine:
            def rec_sample(logits, *args, _eng=eng, **kw):
                arr = np.asarray(logits, np.float32)
                if arr.ndim == 1:
                    first["row"] = arr
                else:
                    for i, r in enumerate(_eng.slot_req):
                        if r is not None and r.generated and r.prefilled >= len(r.prompt):
                            top = np.sort(arr[i])[::-1]
                            gaps[(r.rid, len(r.generated))] = float(top[0] - top[1])
                return sample(logits, *args, **kw)
            commit = eng._commit_first_token

            def rec_commit(req, tok, logp, slot, _commit=commit):
                top = np.sort(first.pop("row"))[::-1]
                gaps[(req.rid, 0)] = float(top[0] - top[1])
                return _commit(req, tok, logp, slot)
            monkeypatch.setattr(jengine_mod, "sample", rec_sample)
            monkeypatch.setattr(eng, "_commit_first_token", rec_commit)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, max_new=n, rid=i)
        out.append(eng.run(max_steps=200))
    jrep, trep = out
    assert trep.steps == jrep.steps and trep.prefill_chunks == jrep.prefill_chunks
    jtok = {r.rid: list(r.generated) for r in jrep.completed}
    ttok = {r.rid: list(r.generated) for r in trep.completed}
    assert sorted(ttok) == sorted(jtok) == [0, 1, 2]
    decisive = 0
    for rid, want in jtok.items():
        assert len(ttok[rid]) == len(want)
        for i, (a, b) in enumerate(zip(ttok[rid], want)):
            if a != b:
                assert gaps[(rid, i)] < 2 * ENGINE_LOGIT_ATOL, (rid, i, gaps[(rid, i)])
                break
            decisive += 1
    print(f"\nengine: {decisive} tokens equal, {trep.steps} steps")


# ---------------------------------------------------------------------------
# the trainer: the aux loss in one update, --rrr
# ---------------------------------------------------------------------------

def test_update_with_moe_aux_loss_matches_reference(setup):
    jcfg, tcfg, params, np_params = setup
    rng = np.random.default_rng(7)
    b, p, g = 4, 6, 5
    lengths = rng.integers(3, p + 1, size=b).astype(np.int32)
    packed = _tokens(b, p + g, 90)
    mask = (np.arange(g)[None, :] < rng.integers(2, g + 1, size=b)[:, None]).astype(np.float32)
    batch = dict(packed_tokens=packed, prompt_lengths=lengths,
                 rollout_logps=(np.log(rng.uniform(0.05, 1.0, size=(b, g))) * mask)
                 .astype(np.float32),
                 advantages=np.repeat(rng.normal(size=b // 2), 2).astype(np.float32),
                 mask=mask, response_mask=mask)
    opt = dict(lr=LR, b2=0.98, grad_clip=1.0)
    jrl = jtrainer.RLConfig(precision=jp.PrecisionConfig(), optimizer=JAdamWConfig(**opt))
    trl = ttrainer.RLConfig(precision=tp.PrecisionConfig(), optimizer=TAdamWConfig(**opt))
    assert trl.moe_aux_coef == jrl.moe_aux_coef == 1e-2
    jtr = jtrainer.RLTrainer(jcfg, jrl, params=params)
    jparams, _, jstats = jtr._update_fn(params, jtr.opt_state,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
    ttr = ttrainer.RLTrainer(tcfg, trl, params=params_from_numpy(np_params, "cpu"),
                             device="cpu")
    tparams, _, tstats = ttr.update_fn(ttr.params, ttr.opt_state,
                                       {k: torch.tensor(v) for k, v in batch.items()})
    assert "moe_aux_loss" in tstats and set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=k)
    n_diff = n_all = 0
    for a, b_ in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
        a, b_ = np.asarray(a).astype(np.float32), b_.float().numpy()
        d = np.abs(a - b_)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
        assert np.all(d <= ulp + 2 * LR * 1.01), "a param moved apart"
        n_diff += int((d > 0).sum())
        n_all += d.size
    print(f"\nupdate: moe_aux_loss {float(tstats['moe_aux_loss']):.6f} vs "
          f"{float(jstats['moe_aux_loss']):.6f}; params differing {n_diff} of {n_all}")
    assert n_diff <= 1e-2 * n_all


def test_launch_train_rrr_records_routing(monkeypatch):
    seen = []
    real = ttrainer.generate

    def spy(*args, **kw):
        traj = real(*args, **kw)
        seen.append(traj.routing)
        return traj
    monkeypatch.setattr(ttrainer, "generate", spy)
    rows = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
                         "--precision", "default", "--rrr", "--prompt-batch", "2",
                         "--n-per-prompt", "2", "--max-new-tokens", "3",
                         "--eval-every", "100"])
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"])
    assert np.isfinite(rows[0]["moe_aux_loss"])
    routing = seen[0]
    assert set(routing) == {"prefill", "decode"}
    assert routing["decode"]["s0"].shape[2:] == (4, 1, 2)       # (G, R, B*n, 1, K)


def test_launch_serve_runs_moe():
    report = tserve.run(["--arch", ARCH, "--reduced", "--device", "cpu", "--precision",
                         "default", "--requests", "3", "--max-new", "3",
                         "--prefill-chunk", "8"])
    assert report["completed"] == 3


def test_iter_params_holds_no_leaf_it_has_handed_out():
    """`Transformer.iter_params` draws `init_params`' leaves in the same
    order and keeps none of them once yielded, so a leafwise sync holds
    one bf16 leaf at a time (at full width qwen3-30b-a3b's fc1 is 38.7
    GB)."""
    import weakref
    _, tcfg = _cfgs()
    model = Transformer(tcfg, "cpu")
    whole = model.init_params(1)
    prev = None
    for path, leaf in model.iter_params(1):
        # the leaf before this one died when the caller dropped it
        assert prev is None or prev[1]() is None, prev[0]
        want = whole
        for k in path:
            want = want[k]
        assert torch.equal(leaf, want), path
        prev = path, weakref.ref(leaf)
        del leaf


@pytest.mark.parametrize("arch", ["qwen3-30b-a3b", "grok-1-314b"])
def test_meta_specs_match_reference_shapes(arch):
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    want = jax.eval_shape(lambda: init_params(jcfg, jax.random.key(0)))
    got = tsteps.param_specs(tcfg)
    flat = {"/".join(str(p.key) for p in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                mine[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    walk(got)
    assert mine == flat
    assert all(v.is_meta for v in tree_leaves(got))
    roll = tsteps.param_specs(tcfg, tp.PrecisionConfig(router_dtype=tp.RouterDtype.FP8))
    moe = roll["blocks"]["s0"]["moe"]
    assert isinstance(moe["fc1"], QuantizedTensor) and isinstance(moe["router"], QuantizedTensor)
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(moe["fc1"].scales.shape) == (tcfg.n_layers, e, -(-d // 128), -(-2 * f // 128))
    cache = tsteps.cache_specs(tcfg, tconfigs.DECODE_32K, tp.PrecisionConfig())
    assert cache["slots"]["s0"]["kv"].k.is_meta
    assert Transformer(tcfg, "meta").repeats == tcfg.n_layers
