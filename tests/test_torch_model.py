"""The port's model path vs the JAX reference on bridged parameters.

Parameters come from `repro.models.init_params` (reduced qwen3-8b,
`tiny_serving_config`) and cross through `repro_torch.bridge`.  Checked:

* the bridge round trip (raw bits, dtypes, quantized leaves);
* weight sync: the port's `sync_policy_weights` (kernel 2's plain version
  on the CPU) gives payloads and scales bit-equal to the reference's;
* `prefill` + 6 `decode_step`s fed the same greedy tokens, logits vs the
  reference's `prefill`/`decode_step` (its decode attention through the
  Pallas kernel, interpret mode, when the KV cache is fp8).  Tolerances
  come from measured gaps: bf16 and fp8-KV logits differ by at most
  0.047 (1-3 bf16 ulps at |logit| ~ 2.5; XLA and torch round at a few
  other places and sum in other orders), so ATOL_BF16 = 0.08.  Under
  W8A8 the port's GEMM takes exact fp8 products where the reference
  multiplies bf16-dequantized operands; single linears differ by up to 4
  bf16 ulps (`test_fp8_linear_rollout_matches_reference`) and, through the
  fp8 re-quantization of every activation, the logits by up to 0.32, so
  ATOL_W8A8 = 0.4.  Run with `-s` to print the measured gaps.  Argmax must agree
  wherever the reference's top-2 gap exceeds twice the tolerance.
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
from repro.core import precision as jp  # noqa: E402
from repro.core.quant import QuantizedTensor as JQT  # noqa: E402
from repro.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATOL_BF16, ATOL_W8A8 = 0.08, 0.4
PRECISIONS = {
    "bf16": (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT, ATOL_BF16),
    "fp8_kv": (jp.FP8_KV_ONLY_ROLLOUT, tp.FP8_KV_ONLY_ROLLOUT, ATOL_BF16),
    "default": (jp.PrecisionConfig(), tp.PrecisionConfig(), ATOL_W8A8),
    "fp8_linear": (jp.FP8_LINEAR_ROLLOUT, tp.FP8_LINEAR_ROLLOUT, ATOL_W8A8),
}


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.tiny_serving_config()
    params = init_params(cfg, jax.random.key(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _raw(x):
    if isinstance(x, torch.Tensor):
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
        return x.contiguous().view(bits).numpy().view(np.uint8)
    return np.ascontiguousarray(x).view(np.uint8)


def _walk(a, b, fn, path=""):
    assert isinstance(b, dict) == isinstance(a, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    else:
        fn(path, a, b)


def test_configs_mirror_the_reference():
    j, t = jconfigs.tiny_serving_config(), tconfigs.tiny_serving_config()
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                  "vocab_size", "rope_theta", "norm_eps", "qk_norm", "act"):
        assert getattr(j, field) == getattr(t, field), field
    full_j, full_t = jconfigs.get_config("qwen3-8b"), tconfigs.get_config("qwen3-8b")
    assert full_j.param_count() == full_t.param_count()


def test_bridge_round_trip(setup):
    cfg, params, np_params = setup
    tparams = params_from_numpy(np_params, "cpu")

    def check(path, arr, t):
        assert tuple(t.shape) == arr.shape, path
        assert str(t.dtype).split(".")[-1] == arr.dtype.name, path
        np.testing.assert_array_equal(_raw(t), _raw(arr), err_msg=path)
    _walk(np_params, tparams, check)


def test_bridge_takes_quantized_leaves(setup):
    cfg, params, _ = setup
    roll, _ = jsync(params, jp.PrecisionConfig())
    wq = jax.tree.map(np.asarray, roll["blocks"]["s0"]["attn"]["wq"])
    assert isinstance(wq, JQT)
    for leaf in (wq, (wq.data, wq.scales)):
        t = params_from_numpy({"w": leaf}, "cpu")["w"]
        assert isinstance(t, QuantizedTensor) and t.block == (1, 128, 128)
        assert t.data.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_raw(t.data), _raw(wq.data))
        np.testing.assert_array_equal(t.scales.numpy(), wq.scales)


@pytest.mark.parametrize("name", ["default", "fp8_linear"])
def test_sync_policy_weights_bit_equal(setup, name):
    cfg, params, np_params = setup
    jprec, tprec = {"default": (jp.PrecisionConfig(), tp.PrecisionConfig()),
                    "fp8_linear": (jp.FP8_LINEAR_ROLLOUT, tp.FP8_LINEAR_ROLLOUT)}[name]
    jroll, jstats = jsync(params, jprec)
    tparams = params_from_numpy(np_params, "cpu")
    troll, tstats = tsync(tparams, tprec)
    for key in ("quantized_leaves", "raw_leaves", "quantized_bytes", "raw_bytes"):
        assert tstats[key] == jstats[key], key
    jroll = jax.tree.map(np.asarray, jroll)

    def flatten(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flatten(v, f"{path}/{k}")
        else:
            yield path, tree
    tleaves = dict(flatten(troll))
    n_quant = 0
    for path, jleaf in flatten(jroll):
        tleaf = tleaves[path]
        if isinstance(jleaf, JQT):
            n_quant += 1
            assert isinstance(tleaf, QuantizedTensor), path
            np.testing.assert_array_equal(_raw(tleaf.data), _raw(jleaf.data), err_msg=path)
            np.testing.assert_array_equal(tleaf.scales.numpy(), jleaf.scales, err_msg=path)
        else:
            np.testing.assert_array_equal(_raw(tleaf), _raw(jleaf), err_msg=path)
    assert n_quant == 7
    # unquantized leaves are shared with the training params, not copied
    assert troll["emb"] is tparams["emb"]


@pytest.mark.parametrize("m,k,n", [(27, 64, 64), (27, 64, 128), (27, 128, 64), (5, 256, 384)])
def test_fp8_linear_rollout_matches_reference(m, k, n):
    """One W8A8 linear: bit-equal to the reference's Pallas-GEMM path
    (`fp8_linear_rollout(use_kernel=True)`, interpret mode), and within 6
    bf16 ulps (at the output's largest magnitude; up to 3.9 measured) of
    its default QDQ path, which multiplies bf16-dequantized operands."""
    from repro.core import fp8_linear as jfl
    from repro.core import quant as jq
    from repro_torch.bridge import tensor_from_numpy
    from repro_torch.core import fp8_linear as tfl
    rng = np.random.default_rng(m + k + n)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray((rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
                    ).astype(jnp.bfloat16)
    wq = jax.jit(jq.quantize_weight)(w)
    tw = QuantizedTensor(tensor_from_numpy(np.asarray(wq.data), "cpu"),
                         tensor_from_numpy(np.asarray(wq.scales), "cpu"), (128, 128))
    y = tfl.fp8_linear_rollout(tensor_from_numpy(np.asarray(x), "cpu"), tw).float().numpy()
    y_kernel = np.asarray(jfl.fp8_linear_rollout(x, wq, use_kernel=True), np.float32)
    y_qdq = np.asarray(jfl.fp8_linear_rollout(x, wq), np.float32)
    np.testing.assert_array_equal(y, y_kernel)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(y_qdq).max())) - 7)
    gap = np.abs(y - y_qdq).max() / ulp
    print(f"W8A8 linear {(m, k, n)}: max gap to the QDQ path {gap:.2f} bf16 ulps")
    assert gap <= 6


def _prompts():
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 19, (3, 9)).astype(np.int32)
    toks[:, 0] = 1
    return toks, np.array([9, 5, 7], np.int32)


def _check_logits(j, t, atol, where):
    """allclose + decisive argmax; returns the max |gap| for the report."""
    j = np.asarray(j, np.float32)
    t = t.numpy()
    assert t.shape == j.shape and np.isfinite(t).all(), where
    np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=where)
    for row_j, row_t in zip(j, t):
        top2 = np.sort(row_j)[::-1][:2]
        if top2[0] - top2[1] > 2 * atol:
            assert row_t.argmax() == row_j.argmax(), where
    return float(np.abs(t - j).max())


@pytest.mark.parametrize("name", list(PRECISIONS))
def test_prefill_and_decode_logits_match_reference(setup, name):
    cfg, params, np_params = setup
    jprec, tprec, atol = PRECISIONS[name]
    jroll, _ = jsync(params, jprec)
    troll, _ = tsync(params_from_numpy(np_params, "cpu"), tprec)
    toks, lens = _prompts()
    jcache = init_cache(cfg, 3, 24, jprec, page_size=4)
    jl, jcache = prefill(jroll, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)},
                         jcache, cfg, jprec)
    model = Transformer(tconfigs.tiny_serving_config(), "cpu")
    tcache = model.init_cache(3, 24, tprec, page_size=4)
    tl, tcache = model.prefill(troll, {"tokens": torch.from_numpy(toks),
                                       "lengths": torch.from_numpy(lens)}, tcache, tprec)
    gap = _check_logits(jl, tl, atol, "prefill")
    jkv, tkv = jcache["slots"]["s0"]["kv"], tcache["slots"]["s0"]["kv"]
    # calibrated KV scales: equal up to one bf16 ulp of the K/V amax
    np.testing.assert_allclose(tkv.k_scale.numpy(), np.asarray(jkv.k_scale), rtol=2**-7)
    np.testing.assert_allclose(tkv.v_scale.numpy(), np.asarray(jkv.v_scale), rtol=2**-7)
    for step in range(6):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache, _ = decode_step(jroll, jnp.asarray(tok), jcache, cfg, jprec,
                                    use_kernel=jprec.kv_quantized)
        tl, tcache = model.decode_step(troll, torch.from_numpy(tok), tcache, tprec)
        gap = max(gap, _check_logits(jl, tl, atol, f"decode step {step}"))
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    print(f"{name}: max |logit gap| over prefill + 6 decode steps {gap:.4f} (tol {atol})")


def test_full_fp8_prefill_matches_reference(setup):
    """FULL_FP8_ROLLOUT prefill (q, k, v and P QDQ'd in the attention) of a
    paged and of a contiguous cache against the reference's, with the
    W8A8 tolerance; the QDQ moves the logits (they differ from the
    `PrecisionConfig()` prefill's)."""
    cfg, params, np_params = setup
    jroll, _ = jsync(params, jp.FULL_FP8_ROLLOUT)
    troll = tsync(params_from_numpy(np_params, "cpu"), tp.FULL_FP8_ROLLOUT)[0]
    toks, lens = _prompts()
    model = Transformer(tconfigs.tiny_serving_config(), "cpu")
    inputs = {"tokens": torch.from_numpy(toks), "lengths": torch.from_numpy(lens)}
    for page_size in (4, None):
        jcache = init_cache(cfg, 3, 24, jp.FULL_FP8_ROLLOUT, page_size=page_size)
        jl, _ = jax.jit(lambda p, i, c: prefill(p, i, c, cfg, jp.FULL_FP8_ROLLOUT))(
            jroll, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)}, jcache)
        tl, _ = model.prefill(troll, inputs,
                              model.init_cache(3, 24, tp.FULL_FP8_ROLLOUT,
                                               page_size=page_size),
                              tp.FULL_FP8_ROLLOUT)
        _check_logits(jl, tl, ATOL_W8A8, f"prefill, page size {page_size}")
        plain, _ = model.prefill(troll, inputs,
                                 model.init_cache(3, 24, tp.PrecisionConfig(),
                                                  page_size=page_size),
                                 tp.PrecisionConfig())
        assert not torch.equal(plain, tl)


def test_unported_layer_kinds_raise():
    cfg = tconfigs.tiny_serving_config()
    for kw in (dict(ssm_state=8, attn_period=2),):
        with pytest.raises(NotImplementedError, match="not ported"):
            Transformer(cfg.reduced(**kw), "cpu")


def test_moe_layer_kind_builds():
    """MoE slots are ported (held to the reference in test_torch_moe.py):
    a dense config with experts builds, draws the reference's MoE leaves
    and decodes."""
    cfg = tconfigs.tiny_serving_config().reduced(n_experts=4, top_k=2)
    model = Transformer(cfg, "cpu")
    params = model.init_params(0)
    moe = params["blocks"]["s0"]["moe"]
    assert set(moe) == {"router", "fc1", "fc2", "norm_scale"}
    assert tuple(moe["fc1"].shape) == (2, 4, cfg.d_model, 2 * cfg.d_ff)
    assert moe["router"].dtype == torch.bfloat16 and "mlp" not in params["blocks"]["s0"]
    cache = model.init_cache(2, 8, tp.BF16_ROLLOUT, page_size=4)
    inputs = {"tokens": torch.tensor([[1, 5, 6], [1, 7, 0]]), "lengths": torch.tensor([3, 2])}
    logits, cache = model.prefill(params, inputs, cache, tp.BF16_ROLLOUT)
    logits, _ = model.decode_step(params, logits.argmax(-1), cache, tp.BF16_ROLLOUT)
    assert bool(torch.isfinite(logits).all())


def test_transformer_without_device_needs_cuda():
    if torch.cuda.is_available():
        assert Transformer(tconfigs.tiny_serving_config()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Transformer(tconfigs.tiny_serving_config())
