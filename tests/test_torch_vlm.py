"""The port's VLM path (pixtral-12b's patch prefix: `frontend/w_patch`,
the prefix-LM mask of `forward_train`, the prefix through `prefill`,
`decode_step`, `generate` and `launch.steps`) vs the JAX reference, and
the two reference faults this path shows.

Parameters: `repro.models.init_params` of reduced pixtral-12b (2 layers,
d 128, 4 heads of 32 over 1 KV head, 8 patches, vocab 512), bridged with
`params_from_numpy`; the reference runs jitted.  Logits within
LOGIT_ATOL = 0.6, the W8A8 band of the dense registry
(test_torch_archs.py; measured here at most 0.53, the prefill's, under
W8A8 + FP8 KV, where the patch projection is one more W8A8 linear);
greedy tokens equal up to the first step whose top-2 gap is under 2 x
LOGIT_ATOL.

The faults, pinned:
* `generate` sizes its cache without the patch prefix in the reference
  (`max_len = p + g + 1`), but the prefill writes prefix + text
  positions; at page size 4 with 8 patches its decode writes past the
  block table land in the last entry's block and its tokens leave its
  own roomy contiguous decode.  The port sizes the table with the prefix
  and decodes the roomy tokens.
* Rollout and training attend differently over the patches: the
  prefix-LM mask in `forward_train`, causal in `prefill`.  In f32 the
  prefill's last logits and `forward_train`'s at that position differ by
  the same amount in both packages (the port keeps the reference's
  semantics).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precision as jp  # noqa: E402
from repro.core.fp8_params import quantize_params as jquantize  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.rl import SamplerConfig as TSampler  # noqa: E402
from repro_torch.rl import generate as tgenerate  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LOGIT_ATOL = 0.6
B, T, P, G = 2, 12, 8, 6


def _cfgs():
    return (jconfigs.get_config("pixtral-12b").reduced(n_layers=2),
            tconfigs.get_config("pixtral-12b").reduced(n_layers=2))


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, {"bf16" | "w8a8": (reference params,
    port params)})."""
    jcfg, tcfg = _cfgs()
    params = jax.jit(init_params, static_argnums=0)(jcfg, jax.random.key(0))
    jroll = jax.jit(lambda p: jquantize(p, jp.PrecisionConfig()))(params)
    return jcfg, tcfg, {
        "bf16": (params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")),
        "w8a8": (jroll, params_from_numpy(jax.tree.map(np.asarray, jroll), "cpu"))}


def _inputs(jcfg, bf16=True, lengths=(T, T - 3)):
    """Tokens, patches (bf16, or f32) and lengths, for both packages."""
    rng = np.random.default_rng(21)
    tokens = rng.integers(4, jcfg.vocab_size, (B, T)).astype(np.int32)
    patches = rng.normal(size=(B, P, jcfg.d_model)).astype(np.float32)
    lengths = np.array(lengths, np.int32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    j = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches, jdt),
         "lengths": jnp.asarray(lengths)}
    t = {"tokens": torch.from_numpy(tokens), "patches": torch.from_numpy(patches).to(tdt),
         "lengths": torch.from_numpy(lengths)}
    return j, t


def _err(want, got):
    return float(np.abs(np.asarray(want, np.float32) - got.float().numpy()).max())


@pytest.mark.parametrize("name", ["bf16", "w8a8"])
def test_forward_train_prefix_lm_and_token_logprobs(model, name):
    """The prefix-LM forward over P patches + T tokens (logits over P + T
    positions, aux prefix_len P), and `token_logprobs` with the prefix
    sliced off: (B, T - 1)."""
    jcfg, tcfg, rolls = model
    jprec, tprec = (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT) if name == "bf16" else \
        (jp.PrecisionConfig(), tp.PrecisionConfig())
    jroll, troll = rolls[name]
    jin, tin = _inputs(jcfg)
    for d in (jin, tin):
        d.pop("lengths")
    jl, jlp = jax.jit(lambda p, i: (jtr.forward_train(p, i, jcfg, jprec)[0],
                                    jtr.token_logprobs(p, i, jcfg, jprec)[0]))(jroll, jin)
    with torch.no_grad():
        tl, aux = ttr.forward_train(troll, tin, tcfg, tprec)
        tlp, _ = ttr.token_logprobs(troll, tin, tcfg, tprec)
    assert aux["prefix_len"] == P and tl.shape == (B, P + T, tcfg.vocab_size)
    assert tlp.shape == (B, T - 1)
    errs = _err(jl, tl), _err(jlp, tlp)
    print(f"\nforward_train {name}: logits {errs[0]:.4f}, logprobs {errs[1]:.4f}")
    assert max(errs) <= LOGIT_ATOL


def test_prefill_and_decode_match_reference(model):
    """W8A8 + FP8 KV on a contiguous cache of prefix + text + decode
    positions: the prefill's logits and lengths (text + P), then 3 greedy
    decode steps on the reference's tokens."""
    jcfg, tcfg, rolls = model
    jroll, troll = rolls["w8a8"]
    jprec, tprec = jp.PrecisionConfig(), tp.PrecisionConfig()
    jin, tin = _inputs(jcfg)
    s_max = P + T + 4
    jlog, jcache = jax.jit(lambda p, i, c: jtr.prefill(p, i, c, jcfg, jprec))(
        jroll, jin, jtr.init_cache(jcfg, B, s_max, jprec))
    m = Transformer(tcfg, "cpu")
    with torch.no_grad():
        tlog, tcache = m.prefill(troll, tin, m.init_cache(B, s_max, tprec), tprec)
        errs = [_err(jlog, tlog)]
        np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
        assert tcache["max_length"] == P + T
        step = jax.jit(lambda p, t, c: jtr.decode_step(p, t, c, jcfg, jprec)[:2])
        tok = jnp.argmax(jlog, -1)
        for _ in range(3):
            jl, jcache = step(jroll, tok, jcache)
            tl, tcache = m.decode_step(troll, torch.from_numpy(np.array(tok)), tcache, tprec)
            errs.append(_err(jl, tl))
            tok = jnp.argmax(jl, -1)
    print(f"\nVLM prefill + 3 decode steps: " + ", ".join(f"{e:.4f}" for e in errs))
    assert max(errs) <= LOGIT_ATOL


@pytest.fixture(scope="module")
def roomy(model):
    """The reference's own greedy decode under BF16_ROLLOUT (`_roomy_
    reference_decode`), once for the module."""
    jcfg, _, rolls = model
    return _roomy_reference_decode(jcfg, rolls["bf16"][0], _inputs(jcfg)[0], jp.BF16_ROLLOUT, G)


def _roomy_reference_decode(jcfg, jroll, jin, prec, g):
    """The reference's own prefill + `decode_step` on a contiguous cache
    with room for every position: its tokens and each step's top-2 gap."""
    cache = jtr.init_cache(jcfg, B, P + T + g + 1, prec)
    logits, cache = jax.jit(lambda p, i, c: jtr.prefill(p, i, c, jcfg, prec))(jroll, jin, cache)
    step = jax.jit(lambda p, t, c: jtr.decode_step(p, t, c, jcfg, prec)[:2])
    toks, gaps = [], []
    for _ in range(g):
        top = np.sort(np.asarray(logits, np.float32), -1)[:, ::-1]
        gaps.append(top[:, 0] - top[:, 1])
        tok = jnp.argmax(logits, -1)
        toks.append(np.asarray(tok))
        logits, cache = step(jroll, tok, cache)
    return np.stack(toks, 1), np.stack(gaps, 1)


def _agree(tokens, want, gaps):
    """Every row equal to `want` up to a step whose top-2 gap is under 2 x
    LOGIT_ATOL (a near-tie may break either way)."""
    for row in range(len(want)):
        for i, (a, b) in enumerate(zip(tokens[row], want[row])):
            if a != b:
                assert gaps[row, i] < 2 * LOGIT_ATOL, (row, i, gaps[row, i])
                break


@pytest.mark.parametrize("page_size", [64, 4], ids=["roomy_pages", "fault1_pages"])
def test_generate_sizes_the_table_with_the_prefix(model, roomy, page_size):
    """Greedy `generate` with 8 patches, BF16_ROLLOUT.  At page size 64 one
    block covers prefix, text and decode: the reference's `generate`
    equals its roomy contiguous decode, and the port's equals both.  At
    page size 4 the reference's table (5 blocks for 12 + 6 + 1 positions)
    misses the prefix: its decode writes land in the last block, and its
    tokens leave its roomy decode (fault 1).  The port's table counts the
    prefix: its tokens stay the roomy decode's."""
    jcfg, tcfg, rolls = model
    jparams, tparams = rolls["bf16"]
    jin, tin = _inputs(jcfg)
    want, gaps = roomy
    jt = jrollout.generate(jparams, jin["tokens"], jin["lengths"], jax.random.key(0), jcfg,
                           jp.BF16_ROLLOUT,
                           jrollout.SamplerConfig(max_new_tokens=G, temperature=0.0),
                           extra_inputs={"patches": jin["patches"]}, page_size=page_size)
    tt = tgenerate(tparams, tin["tokens"], tin["lengths"], None, tcfg, tp.BF16_ROLLOUT,
                   TSampler(max_new_tokens=G, temperature=0.0), page_size=page_size,
                   extra_inputs={"patches": tin["patches"]}, device="cpu")
    ref = np.asarray(jt.response_tokens)
    print(f"\npage size {page_size}: roomy {want[0].tolist()}, reference generate "
          f"{ref[0].tolist()}, port generate {tt.response_tokens[0].tolist()}")
    _agree(tt.response_tokens.numpy(), want, gaps)
    if page_size == 64:
        np.testing.assert_array_equal(ref, want)
    else:
        assert not np.array_equal(ref, want)


def test_prefill_attends_causally_over_the_patches(model):
    """Fault 2, kept as the reference's semantics: in f32 the prefill's
    last logits (causal over the patches) and `forward_train`'s at the
    same position (the prefix-LM mask) differ, by the same amount in both
    packages."""
    jcfg, tcfg, rolls = model
    params = jax.tree.map(lambda a: a.astype(jnp.float32), rolls["bf16"][0])
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jin, tin = _inputs(jcfg, bf16=False, lengths=(T, T))
    prec = jp.BF16_ROLLOUT
    jlast, _ = jax.jit(lambda p, i, c: jtr.prefill(p, i, c, jcfg, prec))(
        params, jin, jtr.init_cache(jcfg, B, P + T + 1, prec))
    jft = jax.jit(lambda p, i: jtr.forward_train(p, i, jcfg, prec)[0])(
        params, {k: v for k, v in jin.items() if k != "lengths"})
    m = Transformer(tcfg, "cpu")
    with torch.no_grad():
        tlast, _ = m.prefill(tparams, tin, m.init_cache(B, P + T + 1, tp.BF16_ROLLOUT),
                             tp.BF16_ROLLOUT)
        tft, _ = ttr.forward_train(tparams, {k: v for k, v in tin.items() if k != "lengths"},
                                   tcfg, tp.BF16_ROLLOUT)
    jgap = float(np.abs(np.asarray(jlast) - np.asarray(jft)[:, -1]).max())
    tgap = float((tlast - tft[:, -1]).abs().max())
    print(f"\nprefill vs forward_train at the last position (f32): reference {jgap:.4f}, "
          f"port {tgap:.4f}, max|logit| {float(np.abs(np.asarray(jlast)).max()):.3f}")
    assert jgap > 0.1 and abs(tgap - jgap) <= 0.01 * jgap


def test_engine_refusal_and_specs(model):
    """The engine refuses a VLM (the reference's engine never passes
    patches); `launch.steps`' meta specs of the full config equal the
    reference's shapes (P = min(1024, S // 2) patches ahead of S - P
    tokens), and a reduced prefill step with patches runs its serve step."""
    _, tcfg, rolls = model
    with pytest.raises(NotImplementedError, match="patch"):
        ServingEngine(rolls["bf16"][1], tcfg, tp.BF16_ROLLOUT, device="cpu")
    jfull, tfull = jconfigs.get_config("pixtral-12b"), tconfigs.get_config("pixtral-12b")
    for shape in (jconfigs.TRAIN_4K, jconfigs.PREFILL_32K, jconfigs.DECODE_32K):
        want = {k: tuple(v.shape) for k, v in jsteps.input_specs(jfull, shape).items()}
        got = {k: tuple(v.shape) for k, v in tsteps.input_specs(tfull, shape).items()}
        assert got == want, shape.name
    assert tsteps.input_specs(tfull, jconfigs.PREFILL_32K)["patches"].dtype == torch.bfloat16
    spec = tsteps.cache_specs(tfull, jconfigs.DECODE_32K, tp.PrecisionConfig())
    assert "src_lengths" not in spec and all("cross" not in sd for sd in spec["slots"].values())
    roll = tsteps.param_specs(tfull, tp.PrecisionConfig())
    assert tuple(roll["frontend"]["w_patch"].data.shape) == (5120, 5120)
    assert roll["frontend"]["w_patch"].data.dtype == torch.float8_e4m3fn
    shape = tconfigs.ShapeConfig("t", 2 * P, B, "prefill")
    _, tin = _inputs(tcfg, lengths=(P, P - 3))
    batch = {"tokens": tin["tokens"][:, :P], "patches": tin["patches"], "lengths": tin["lengths"]}
    with torch.no_grad():
        logits, cache = tsteps.make_prefill_step(tcfg, shape, tp.PrecisionConfig(), "cpu")(
            rolls["w8a8"][1], batch)
        logits, cache = tsteps.make_serve_step(tcfg, tp.PrecisionConfig(), "cpu")(
            rolls["w8a8"][1], logits.argmax(-1), cache)
    assert bool(torch.isfinite(logits).all()) and cache["max_length"] == 2 * P + 1
