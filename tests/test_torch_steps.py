"""The contiguous-cache path of the port (`launch.steps`, `KVCache`,
kernel 6 at decode, the chunked attention impl) vs the JAX reference.

Parameters come from `repro.models.init_params` (`tiny_serving_config`)
and cross through `repro_torch.bridge`; a reference cache crosses through
`bridge.kv_cache_from_numpy`.  Checked:

* `ShapeConfig` cells, and `input_specs` / `cache_specs` / `param_specs`
  at full qwen3-8b for the four cells: the port's meta tensors have the
  shapes and dtypes of the reference's `jax.eval_shape` results;
* `_sdpa_chunked` and one-layer `attention_prefill` under
  `attention_impl("chunked")` vs the reference's (causal, with and
  without lengths, KV chunks smaller than S, equal to it and larger):
  bf16 outputs within 2 ulps of their scale (sum order; measured 0),
  the written cache bit-equal;
* `attention_decode` on a contiguous cache, one layer, from the
  reference's exact cache state, both of the port's paths (kernel 6's
  plain version, the dequantized full-S_max `_sdpa`) against both of the
  reference's (the Pallas kernel in interpret mode, its jnp path): the
  written cache bytes bit-equal; outputs within 3 bf16 ulps of their
  scale (kernel 6 dequantizes in f32 where the jnp paths round the
  dequantized K/V to bf16; measured up to 1);
* the whole slice: the port's `make_prefill_step` + 6 `make_serve_step`s
  vs the reference's jitted ones on the same bridged parameters and
  ragged prompts, with naive and chunked prefill attention.  Bands as
  the paged path's (test_torch_model.py): 0.08 with bf16 linears (measured
  up to 0.039 here) and 0.4 under W8A8 (measured up to 0.226); argmax equal
  wherever the reference's top-2 gap exceeds twice the band;
* port only: a serve step past S_max raises on the host and leaves the
  cache as it was; `apply_kv_scales` on a contiguous cache.
Run with `-s` to print the measured gaps.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precision as jp  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn_mod  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.rl import calibration as jcal  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    kv_cache_from_numpy,
    params_from_numpy,
    tensor_from_numpy,
)
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import attention as tattn_mod  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402
from repro_torch.rl.calibration import apply_kv_scales  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATOL_BF16, ATOL_W8A8 = 0.08, 0.4
PRECISIONS = {
    "bf16": (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT, ATOL_BF16),
    "default": (jp.PrecisionConfig(), tp.PrecisionConfig(), ATOL_W8A8),
}


def _t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ulp_gap(t, j):
    """max |t - j| in bf16 ulps at j's largest magnitude."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(j).max())) - 7)
    return float(np.abs(t - j).max() / ulp)


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.tiny_serving_config()
    params = init_params(cfg, jax.random.key(0))
    return cfg, params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# shape cells and specs
# ---------------------------------------------------------------------------

def test_shape_configs_mirror_the_reference():
    assert len(tconfigs.ALL_SHAPES) == len(jconfigs.ALL_SHAPES)
    for t, j in zip(tconfigs.ALL_SHAPES, jconfigs.ALL_SHAPES):
        assert (t.name, t.seq_len, t.global_batch, t.kind, t.is_decode) \
            == (j.name, j.seq_len, j.global_batch, j.kind, j.is_decode)
    assert tconfigs.LONG_500K.seq_len == 524288 and tconfigs.LONG_500K.global_batch == 1


def _spec(x):
    return tuple(x.shape), np.dtype(x.dtype).name if not isinstance(x, torch.Tensor) \
        else str(x.dtype).split(".")[-1]


def _same_specs(j, t, path=""):
    """Walk the reference's eval_shape tree and the port's meta tree."""
    if isinstance(j, dict):
        assert set(j) <= set(t), path
        for k in j:
            _same_specs(j[k], t[k], f"{path}/{k}")
        return
    if hasattr(j, "_fields") or hasattr(j, "scales"):        # KVCache, QuantizedTensor
        fields = ("k", "v", "k_scale", "v_scale") if hasattr(j, "k_scale") \
            else ("data", "scales")
        for f in fields:
            _same_specs(getattr(j, f), getattr(t, f), f"{path}/{f}")
        return
    assert isinstance(t, torch.Tensor) and t.device.type == "meta", path
    assert _spec(t) == (tuple(j.shape), j.dtype.name), (path, _spec(t), j)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_input_and_cache_specs_match_reference(shape):
    jshape = next(s for s in jconfigs.ALL_SHAPES if s.name == shape)
    tshape = next(s for s in tconfigs.ALL_SHAPES if s.name == shape)
    jcfg, tcfg = jconfigs.get_config("qwen3-8b"), tconfigs.get_config("qwen3-8b")
    _same_specs(jsteps.input_specs(jcfg, jshape), tsteps.input_specs(tcfg, tshape))
    tcache = tsteps.cache_specs(tcfg, tshape, tp.PrecisionConfig())
    _same_specs(jsteps.cache_specs(jcfg, jshape, jp.PrecisionConfig()), tcache)
    # the port's only extra key: the host's bound on the lengths
    assert set(tcache) == {"slots", "lengths", "max_length"} and tcache["max_length"] == 0


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "w8a8"])
def test_param_specs_match_reference(quantized):
    jcfg, tcfg = jconfigs.get_config("qwen3-8b"), tconfigs.get_config("qwen3-8b")
    jprec, tprec = (jp.PrecisionConfig(), tp.PrecisionConfig()) if quantized else (None, None)
    tspecs = tsteps.param_specs(tcfg, tprec)
    _same_specs(jsteps.param_specs(jcfg, jprec), tspecs)
    wq = tspecs["blocks"]["s0"]["attn"]["wq"]
    assert isinstance(wq, QuantizedTensor) == quantized


# ---------------------------------------------------------------------------
# the chunked attention impl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_lengths", [False, True], ids=["causal", "lengths"])
@pytest.mark.parametrize("kv_chunk", [4, 5, 11, 64])
def test_sdpa_chunked_matches_reference(kv_chunk, with_lengths):
    cfg = jconfigs.tiny_serving_config()
    rng = np.random.default_rng(kv_chunk)
    b, s, h, kvh, dh = 3, 11, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = (jnp.asarray(rng.standard_normal(sh).astype(np.float32)).astype(jnp.bfloat16)
               for sh in ((b, s, h, dh), (b, s, kvh, dh), (b, s, kvh, dh)))
    lengths = np.array([11, 6, 1], np.int32) if with_lengths else None
    out_j = jattn_mod._sdpa_chunked(
        q, k, v, None, cfg, kv_chunk=kv_chunk,
        lengths=None if lengths is None else jnp.asarray(lengths))
    out_t = tattn_mod._sdpa_chunked(
        _t(q), _t(k), _t(v), kv_chunk=kv_chunk,
        lengths=None if lengths is None else torch.from_numpy(lengths))
    out_j, out_t = _f32(out_j), _f32(out_t)
    if lengths is not None:     # rows past a length are never read
        keep = np.arange(s)[None, :] < lengths[:, None]
        out_j, out_t = out_j[keep], out_t[keep]
    gap = _ulp_gap(out_t, out_j)
    print(f"_sdpa_chunked C={kv_chunk} lengths={with_lengths}: max gap {gap:.2f} bf16 ulps")
    assert gap <= 2


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("name", ["bf16", "default"])
def test_attention_prefill_contiguous_matches_reference(setup, name, impl):
    """One layer's prefill into a contiguous cache: the written cache
    (positions [0, S), padding included) bit-equal to the reference's and
    the attention output within 2 bf16 ulps of its scale."""
    cfg, params, _ = setup
    jprec, tprec, _ = PRECISIONS[name]
    layer = jax.tree.map(lambda a: a[0], params["blocks"]["s0"]["attn"])
    tlayer = params_from_numpy(jax.tree.map(np.asarray, layer), "cpu")
    tcfg = tconfigs.tiny_serving_config()
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((3, 9, cfg.d_model)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    lengths = np.array([9, 5, 7], np.int32)
    jcache = jattn_mod.init_kv_cache(3, 12, cfg.n_kv_heads, cfg.d_head, jprec)
    tcache = tattn_mod.init_kv_cache(3, 12, cfg.n_kv_heads, cfg.d_head, tprec,
                                     repeats=1, device="cpu").layer(0)
    with jattn_mod.attention_impl(impl):
        hj, jcache = jattn_mod.attention_prefill(x, layer, cfg, jcache, jprec,
                                                 lengths=jnp.asarray(lengths))
    with tattn_mod.attention_impl(impl):
        ht = tattn_mod.attention_prefill(_t(x), tlayer, tcfg, tcache, tprec,
                                         lengths=torch.from_numpy(lengths),
                                         positions=torch.arange(9)[None])
    keep = np.arange(9)[None, :] < lengths[:, None]
    gap = _ulp_gap(_f32(ht)[keep], _f32(hj)[keep])
    print(f"attention_prefill {name} {impl}: max gap {gap:.2f} bf16 ulps")
    assert gap <= 2
    jc = kv_cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    if jprec.kv_quantized:
        np.testing.assert_allclose(_f32(tcache.k_scale), _f32(jc.k_scale), rtol=2 ** -7)
    for ours, theirs in ((tcache.k, jc.k), (tcache.v, jc.v)):
        assert torch.equal(ours.view(torch.uint8), theirs.view(torch.uint8))


def test_attention_impl_rejects_unported_names():
    with pytest.raises(ValueError, match="naive, chunked and repeat"):
        with tattn_mod.attention_impl("flash"):
            pass


@pytest.mark.parametrize("kvh", [1, 2, 4])
def test_sdpa_repeat_matches_reference(kvh):
    """`attention_impl("repeat")`: K/V repeated to the flat heads, against
    the reference's `_sdpa` under the same impl (causal mask; one and two
    KV groups, and none)."""
    rng = np.random.default_rng(kvh)
    b, s, h, dh = 2, 9, 4, 16
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, dh), (b, s, kvh, dh), (b, s, kvh, dh)))
    mask = np.tril(np.ones((s, s), bool))[None]
    with jattn_mod.attention_impl("repeat"):
        want = jax.jit(lambda *a: jattn_mod._sdpa(*a, None, None))(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(mask))
    with tattn_mod.attention_impl("repeat"):
        got = tattn_mod._sdpa(*(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                              torch.tensor(mask), None)
    assert _ulp_gap(_f32(got), _f32(want)) <= 1
    with tattn_mod.attention_impl("naive"):
        naive = tattn_mod._sdpa(*(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                                torch.tensor(mask), None)
    assert _ulp_gap(_f32(got), _f32(naive)) <= 1


# ---------------------------------------------------------------------------
# decode on a contiguous cache, one layer, from the reference's cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port_kernel", [True, False], ids=["port_kernel6", "port_sdpa"])
@pytest.mark.parametrize("ref_kernel", [True, False], ids=["ref_pallas", "ref_jnp"])
@pytest.mark.parametrize("name", ["bf16", "default"])
def test_attention_decode_contiguous_matches_reference(setup, name, ref_kernel,
                                                       port_kernel):
    cfg, params, _ = setup
    jprec, tprec, _ = PRECISIONS[name]
    layer = jax.tree.map(lambda a: a[0], params["blocks"]["s0"]["attn"])
    tlayer = params_from_numpy(jax.tree.map(np.asarray, layer), "cpu")
    tcfg = tconfigs.tiny_serving_config()
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((3, 8, cfg.d_model)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    lengths = np.array([8, 5, 3], np.int32)
    jcache = jattn_mod.init_kv_cache(3, 12, cfg.n_kv_heads, cfg.d_head, jprec)
    _, jcache = jattn_mod.attention_prefill(x, layer, cfg, jcache, jprec,
                                            lengths=jnp.asarray(lengths))
    tcache = kv_cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    gap = 0.0
    for step in range(4):
        x1 = jnp.asarray(rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
                         ).astype(jnp.bfloat16)
        ln = lengths + step
        hj, jcache = jattn_mod.attention_decode(x1, layer, cfg, jcache, jnp.asarray(ln),
                                                jprec, use_kernel=ref_kernel)
        ht = tattn_mod.attention_decode(_t(x1), tlayer, tcfg, tcache,
                                        torch.from_numpy(ln), tprec, use_kernel=port_kernel)
        gap = max(gap, _ulp_gap(_f32(ht), _f32(hj)))
        jc = jax.tree.map(np.asarray, jcache)
        np.testing.assert_array_equal(tcache.k.view(torch.uint8).numpy(),
                                      np.ascontiguousarray(jc.k).view(np.uint8))
        np.testing.assert_array_equal(tcache.v.view(torch.uint8).numpy(),
                                      np.ascontiguousarray(jc.v).view(np.uint8))
    print(f"attention_decode {name} ref {'pallas' if ref_kernel else 'jnp'} port "
          f"{'kernel 6' if port_kernel else 'sdpa'}: max gap {gap:.2f} bf16 ulps")
    assert gap <= 3


# ---------------------------------------------------------------------------
# the whole slice: launch.steps against the reference's jitted steps
# ---------------------------------------------------------------------------

SEQ_LEN, STEPS = 12, 6
PROMPT_LENS = np.array([7, 4, 6], np.int32)     # 7 + 6 steps = the 13-slot cache


def _prompts():
    rng = np.random.default_rng(2)
    toks = rng.integers(4, 19, (3, SEQ_LEN)).astype(np.int32)
    toks[:, 0] = 1
    for i, n in enumerate(PROMPT_LENS):
        toks[i, n:] = 0
    return toks


def _check_logits(j, t, atol, where):
    j = np.asarray(j, np.float32)
    t = t.numpy()
    assert t.shape == j.shape and np.isfinite(t).all(), where
    np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=where)
    for row_j, row_t in zip(j, t):
        top2 = np.sort(row_j)[::-1][:2]
        if top2[0] - top2[1] > 2 * atol:
            assert row_t.argmax() == row_j.argmax(), where
    return float(np.abs(t - j).max())


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("name", list(PRECISIONS))
def test_steps_match_reference(setup, name, impl):
    cfg, params, np_params = setup
    jprec, tprec, atol = PRECISIONS[name]
    jroll, _ = jsync(params, jprec)
    troll, _ = tsync(params_from_numpy(np_params, "cpu"), tprec)
    tcfg = tconfigs.tiny_serving_config()
    jshape = jconfigs.ShapeConfig("steps_test", SEQ_LEN, 3, "prefill")
    tshape = tconfigs.ShapeConfig("steps_test", SEQ_LEN, 3, "prefill")
    toks = _prompts()
    with jattn_mod.attention_impl(impl):
        jl, jcache = jax.jit(jsteps.make_prefill_step(cfg, jshape, jprec))(
            jroll, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(PROMPT_LENS)})
    with tattn_mod.attention_impl(impl):
        tl, tcache = tsteps.make_prefill_step(tcfg, tshape, tprec, device="cpu")(
            troll, {"tokens": torch.from_numpy(toks),
                    "lengths": torch.from_numpy(PROMPT_LENS)})
    gap = _check_logits(jl, tl, atol, "prefill")
    assert tcache["slots"]["s0"]["kv"].k.shape == (cfg.n_layers, 3, SEQ_LEN + 1,
                                                   cfg.n_kv_heads, cfg.d_head)
    jserve = jax.jit(jsteps.make_serve_step(cfg, jprec))
    tserve = tsteps.make_serve_step(tcfg, tprec, device="cpu")
    for step in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jserve(jroll, jnp.asarray(tok), jcache)
        tl, tcache = tserve(troll, torch.from_numpy(tok), tcache)
        gap = max(gap, _check_logits(jl, tl, atol, f"serve step {step}"))
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    assert tcache["max_length"] == SEQ_LEN + 1
    print(f"steps {name} {impl}: max |logit gap| over prefill + {STEPS} serve steps "
          f"{gap:.4f} (tol {atol})")


def test_serve_step_past_the_cache_raises(setup):
    """The reference's scatter drops a write past S_max; the port raises on
    the host before any write and leaves the cache as it was."""
    _, _, np_params = setup
    tcfg = tconfigs.tiny_serving_config()
    prec = tp.PrecisionConfig()
    troll, _ = tsync(params_from_numpy(np_params, "cpu"), prec)
    shape = tconfigs.ShapeConfig("t", 4, 2, "prefill")
    logits, cache = tsteps.make_prefill_step(tcfg, shape, prec, device="cpu")(
        troll, {"tokens": torch.tensor([[1, 5, 6, 7], [1, 8, 0, 0]], dtype=torch.int32),
                "lengths": torch.tensor([4, 2], dtype=torch.int32)})
    serve = tsteps.make_serve_step(tcfg, prec, device="cpu")
    logits, cache = serve(troll, logits.argmax(-1), cache)      # writes position 4
    kv = cache["slots"]["s0"]["kv"]
    before = (kv.k.clone(), cache["lengths"].clone())
    with pytest.raises(ValueError, match="past the cache"):
        serve(troll, logits.argmax(-1), cache)
    assert torch.equal(kv.k.view(torch.uint8), before[0].view(torch.uint8))
    assert torch.equal(cache["lengths"], before[1]) and cache["max_length"] == 5
    with pytest.raises(ValueError, match="exceed the cache"):
        Transformer(tcfg, "cpu").prefill(
            troll, {"tokens": torch.ones((1, 6), dtype=torch.int32),
                    "lengths": torch.tensor([6])},
            Transformer(tcfg, "cpu").init_cache(1, 5, prec), prec)


def test_apply_kv_scales_on_a_contiguous_cache(setup):
    """Trainer-side scales go into a contiguous cache as into the
    reference's, and a prefill without recalibration keeps them."""
    cfg, _, np_params = setup
    tcfg = tconfigs.tiny_serving_config()
    prec = tp.PrecisionConfig(calculate_kv_scales=False)
    r = cfg.n_layers
    scales = {"s0": {"k_scale": np.linspace(0.01, 0.02, r).astype(np.float32),
                     "v_scale": np.linspace(0.03, 0.05, r).astype(np.float32)}}
    model = Transformer(tcfg, "cpu")
    cache = apply_kv_scales(model.init_cache(2, 8, prec), scales)
    jcache = jcal.apply_kv_scales(
        jsteps.init_cache(cfg, 2, 8, jp.PrecisionConfig(calculate_kv_scales=False)),
        {"s0": {k: jnp.asarray(v) for k, v in scales["s0"].items()}})
    kv, jkv = cache["slots"]["s0"]["kv"], jcache["slots"]["s0"]["kv"]
    np.testing.assert_array_equal(kv.k_scale.numpy(), np.asarray(jkv.k_scale))
    np.testing.assert_array_equal(kv.v_scale.numpy(), np.asarray(jkv.v_scale))
    troll, _ = tsync(params_from_numpy(np_params, "cpu"), prec)
    model.prefill(troll, {"tokens": torch.tensor([[1, 5, 6], [1, 7, 0]], dtype=torch.int32),
                          "lengths": torch.tensor([3, 2], dtype=torch.int32)}, cache, prec)
    np.testing.assert_array_equal(kv.k_scale.numpy(), scales["s0"]["k_scale"])
    assert kv.k[:, :, :3].float().abs().sum() > 0


def test_kv_cache_bridge_is_bit_exact(setup):
    cfg, _, _ = setup
    rng = np.random.default_rng(0)
    k = jnp.asarray(rng.standard_normal((2, 3, 6, 2, 16)).astype(np.float32))
    kv = jattn_mod.KVCache(k=k.astype(jnp.float8_e4m3fn), v=(-k).astype(jnp.float8_e4m3fn),
                           k_scale=jnp.array([0.5, 2.0], jnp.float32),
                           v_scale=jnp.array([1.5, 3.0], jnp.float32))
    t = kv_cache_from_numpy(jax.tree.map(np.asarray, kv), "cpu")
    assert t.quantized and t.max_len == 6 and t.layer(1).k.shape == (3, 6, 2, 16)
    np.testing.assert_array_equal(t.k.view(torch.uint8).numpy(),
                                  np.asarray(kv.k).view(np.uint8))
    np.testing.assert_array_equal(t.v_scale.numpy(), np.asarray(kv.v_scale))


# ---------------------------------------------------------------------------
# the learner-side train step and the optimizer's specs
# ---------------------------------------------------------------------------

def _by_path(tree, prefix=""):
    """{"a/b": leaf} of a nested dict (the reference's or the port's; a
    quantized moment is one leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _jax_tree(tree):
    """A port param tree as the reference's: nested dicts of jax arrays,
    each in its leaf's dtype (an MoE router stays bf16), on copies (a jax
    array may alias a numpy buffer, and the port's step updates in place
    while the reference's may still be running)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.float().numpy().copy()).astype(str(tree.dtype).split(".")[-1])


def _train_cfgs(kind):
    if kind == "dense":
        return jconfigs.tiny_serving_config(), tconfigs.tiny_serving_config()
    name = {"moe": "granite-moe-3b-a800m", "vlm": "pixtral-12b"}[kind]
    kw = dict(n_layers=2, d_model=64, d_ff=64, n_heads=4, n_kv_heads=2, d_head=16,
              vocab_size=64)
    return (jconfigs.get_config(name).reduced(**kw),
            tconfigs.get_config(name).reduced(**kw))


@pytest.mark.parametrize("kind", ["dense", "moe", "vlm"])
def test_train_step_matches_reference(kind):
    """One `make_train_step` (CE after a VLM's prefix, + the MoE aux loss,
    then AdamW) against the reference's jitted one on the same f32 params
    (the port's seeded draw, handed to both): the loss within 1e-5, and
    the updated params within f32 rounding, except where a near-zero
    gradient's sign differs (AdamW's first step moves a param by about
    lr x sign(g): at most 2 lr apart, in under 1% of elements)."""
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import init as jinit

    from repro_torch.optim import adamw as tadamw

    jcfg, tcfg = _train_cfgs(kind)
    tparams = Transformer(tcfg, "cpu", dtype=torch.float32).init_params(0)
    params = _jax_tree(tparams)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)}
    if kind == "vlm":
        batch["patches"] = rng.standard_normal((2, 4, jcfg.d_model)).astype(np.float32)
    lr = 1e-3
    jopt = JAdamWConfig(lr=lr)
    jstep = jax.jit(jsteps.make_train_step(jcfg, opt_cfg=jopt))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams, _, jloss = jstep(params, jinit(params, jopt), jbatch)
    topt = tadamw.AdamWConfig(lr=lr)
    tstep = tsteps.make_train_step(tcfg, opt_cfg=topt, device="cpu")
    tparams, tstate, tloss = tstep(tparams, tadamw.init(tparams, topt),
                                   {k: torch.tensor(v) for k, v in batch.items()})
    assert int(tstate.step) == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    n_far = n_all = 0
    jleaves, tleaves = _by_path(jparams), _by_path(tparams)
    assert set(jleaves) == set(tleaves)
    for path, a in jleaves.items():
        # rounding: f32, or one ulp of a bf16 leaf (an MoE router)
        ulp = 1e-6 * np.abs(np.asarray(a, np.float32)) if a.dtype == jnp.float32 else \
            2.0 ** (np.floor(np.log2(np.maximum(np.abs(np.asarray(a, np.float32)), 1e-30))) - 7)
        a, b = np.asarray(a, np.float32), tleaves[path].float().numpy()
        d = np.abs(a - b)
        assert np.all(d <= 2 * lr * 1.01 + ulp), f"{path} moved apart"
        n_far += int((d > 10 * ulp + 1e-7).sum())
        n_all += d.size
    assert n_far <= 0.01 * n_all, (n_far, n_all)


def _moment_specs(x):
    if isinstance(x, QuantizedTensor) or hasattr(x, "scales"):
        return (_spec(x.data), _spec(x.scales))
    return _spec(x)


# the reference's param specs once per config for the module (its
# `make_opt_specs` calls `param_specs`, an eval_shape of init_params)
_REF_PARAM_SPECS = functools.lru_cache(maxsize=None)(jsteps.param_specs)


@pytest.mark.parametrize("fp8", [False, True], ids=["f32", "fp8"])
def test_opt_specs_match_reference(fp8, monkeypatch):
    """`make_opt_specs` on meta against the reference's `jax.eval_shape`
    of the AdamW state, f32 and fp8 moments, for every registry config."""
    from repro.optim import AdamWConfig as JAdamWConfig

    from repro_torch.optim import adamw as tadamw

    monkeypatch.setattr(jsteps, "param_specs", _REF_PARAM_SPECS)
    for name in sorted(jconfigs.REGISTRY):
        want = jsteps.make_opt_specs(jconfigs.get_config(name), JAdamWConfig(fp8_moments=fp8))
        got = tsteps.make_opt_specs(tconfigs.get_config(name),
                                    tadamw.AdamWConfig(fp8_moments=fp8))
        assert _spec(got.step) == _spec(want.step)
        for moment in ("m", "v"):
            jleaves = _by_path(getattr(want, moment))
            tleaves = _by_path(getattr(got, moment))
            assert set(jleaves) == set(tleaves), name
            for path, a in jleaves.items():
                b = tleaves[path]
                assert (b.data if fp8 else b).is_meta
                assert _moment_specs(b) == _moment_specs(a), (name, path)


def test_loss_and_grads_are_freed_by_refcount():
    """The gradients `make_loss_and_grads` returns die with their last
    reference, the collector off: no reference cycle keeps a step's
    gradients (a full model's worth on the card) alive."""
    import gc
    import weakref

    cfg = tconfigs.tiny_serving_config()
    params = Transformer(cfg, "cpu", dtype=torch.float32).init_params(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    loss_and_grads = tsteps.make_loss_and_grads(cfg, device="cpu")
    loss_and_grads(params, {"tokens": tokens})   # the first call's lazy imports hold frames
    gc.collect()
    gc.disable()
    try:
        loss, grads = loss_and_grads(params, {"tokens": tokens})
        ref = weakref.ref(grads["emb"])
        del loss, grads
        assert ref() is None
    finally:
        gc.enable()
