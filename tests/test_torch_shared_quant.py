"""One activation quantization per distinct linear input.

`core.fp8_linear.linears` projects one `x` through several weights with a
single call of kernel 1 (`ops.quantize_activation`) when every weight is
quantized; `_project_qkv` (q, k, v) and `mlp_forward` (gate, up) use it.
Checked on `tiny_serving_config()`:

* the shared projections are bit-equal to separate `linear` calls, under
  `PrecisionConfig()` (W8A8) and `BF16_ROLLOUT` (bf16 weights: one
  `linear` each);
* kernel 1 runs 4 times a layer per forward (q/k/v, wo, gate/up, wd), and
  the GEMM 7 times;
* prefill plus decode logits still match the JAX reference within
  `test_torch_model.py`'s W8A8 tolerance (0.4).
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
from repro.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import fp8_linear  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models.attention import _project_qkv  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.mlp import _ACT, mlp_forward  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATOL_W8A8 = 0.4        # test_torch_model.py's W8A8 logit tolerance
PRECISIONS = {"w8a8": tp.PrecisionConfig(), "bf16": tp.BF16_ROLLOUT}


@pytest.fixture(scope="module")
def synced():
    cfg = tconfigs.tiny_serving_config()
    params = Transformer(cfg, "cpu").init_params(0)
    return cfg, {name: tsync(params, prec)[0] for name, prec in PRECISIONS.items()}


def _layer0(roll, block):
    return {k: (v.layer(0) if hasattr(v, "layer") else v[0])
            for k, v in roll["blocks"]["s0"][block].items()}


def _x(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((3, 5, cfg.d_model), generator=gen).to(torch.bfloat16)


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("name", list(PRECISIONS))
def test_shared_qkv_quantization_is_bit_equal_to_separate_linears(synced, name):
    cfg, rolls = synced
    prec = PRECISIONS[name]
    p = _layer0(rolls[name], "attn")
    x = _x(cfg, 1)
    got = _project_qkv(x, p, cfg, prec)
    want = [fp8_linear.linear(x, p[w], precision=prec).reshape(3, 5, heads, cfg.d_head)
            for w, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                             ("wv", cfg.n_kv_heads))]
    if cfg.qk_norm and "q_norm_scale" in p:
        want[0] = rms_norm(want[0], p["q_norm_scale"], cfg.norm_eps)
        want[1] = rms_norm(want[1], p["k_norm_scale"], cfg.norm_eps)
    for g, w, name_ in zip(got, want, "qkv"):
        assert torch.equal(_bits(g), _bits(w)), name_


@pytest.mark.parametrize("name", list(PRECISIONS))
def test_shared_gate_up_quantization_is_bit_equal_to_separate_linears(synced, name):
    cfg, rolls = synced
    prec = PRECISIONS[name]
    p = _layer0(rolls[name], "mlp")
    x = _x(cfg, 2)
    got = mlp_forward(x, p, cfg, prec)
    g = fp8_linear.linear(x, p["wg"], precision=prec)
    u = fp8_linear.linear(x, p["wu"], precision=prec)
    want = fp8_linear.linear(_ACT[cfg.act](g) * u, p["wd"], precision=prec)
    assert torch.equal(_bits(got), _bits(want))


def test_kernel_1_runs_four_times_a_layer(synced, monkeypatch):
    """Per forward: q/k/v share one quantization, gate/up another, wo and
    wd one each; the GEMM still runs once per weight."""
    cfg, rolls = synced
    prec = PRECISIONS["w8a8"]
    calls = {"quant": 0, "gemm": 0}
    quant, gemm = ops.quantize_activation, ops.fp8_matmul

    def count_quant(*a, **kw):
        calls["quant"] += 1
        return quant(*a, **kw)

    def count_gemm(*a, **kw):
        calls["gemm"] += 1
        return gemm(*a, **kw)
    monkeypatch.setattr(ops, "quantize_activation", count_quant)
    monkeypatch.setattr(ops, "fp8_matmul", count_gemm)
    model = Transformer(cfg, "cpu")
    toks = torch.tensor([[1, 5, 6, 7], [1, 9, 10, 0]], dtype=torch.int32)
    cache = model.init_cache(2, 8, prec, page_size=4)
    logits, cache = model.prefill(rolls["w8a8"], {"tokens": toks,
                                                  "lengths": torch.tensor([4, 3])},
                                  cache, prec)
    assert calls == {"quant": 4 * cfg.n_layers, "gemm": 7 * cfg.n_layers}
    model.decode_step(rolls["w8a8"], logits.argmax(-1), cache, prec)
    assert calls == {"quant": 8 * cfg.n_layers, "gemm": 14 * cfg.n_layers}


def test_prefill_and_decode_logits_still_match_reference():
    """W8A8 + FP8 KV (`PrecisionConfig()`): prefill and 2 greedy decode
    steps within ATOL_W8A8 of the reference, argmax equal wherever the
    reference's top-2 gap exceeds twice that."""
    cfg = jconfigs.tiny_serving_config()
    params = init_params(cfg, jax.random.key(0))
    jprec, tprec = jp.PrecisionConfig(), tp.PrecisionConfig()
    jroll, _ = jsync(params, jprec)
    troll, _ = tsync(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), tprec)
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 19, (3, 9)).astype(np.int32)
    toks[:, 0] = 1
    lens = np.array([9, 5, 7], np.int32)
    jcache = init_cache(cfg, 3, 16, jprec, page_size=4)
    jl, jcache = prefill(jroll, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)},
                         jcache, cfg, jprec)
    model = Transformer(tconfigs.tiny_serving_config(), "cpu")
    tcache = model.init_cache(3, 16, tprec, page_size=4)
    tl, tcache = model.prefill(troll, {"tokens": torch.from_numpy(toks),
                                       "lengths": torch.from_numpy(lens)}, tcache, tprec)
    for step in range(3):
        j, t = np.asarray(jl, np.float32), tl.numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL_W8A8, err_msg=f"step {step}")
        for row_j, row_t in zip(j, t):
            top2 = np.sort(row_j)[::-1][:2]
            if top2[0] - top2[1] > 2 * ATOL_W8A8:
                assert row_t.argmax() == row_j.argmax(), f"step {step}"
        if step == 2:
            break
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache, _ = decode_step(jroll, jnp.asarray(tok), jcache, cfg, jprec, use_kernel=True)
        tl, tcache = model.decode_step(troll, torch.from_numpy(tok), tcache, tprec)
