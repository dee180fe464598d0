"""The port's rollout (`repro_torch.rl.generate`) vs the JAX reference.

* Greedy `generate` on bridged params, group 1 and a GRPO group of 3 with
  shared prefix blocks, against the reference's `generate`: tokens, masks
  and lengths equal up to the first step where the reference's top-2
  logit gap is not decisive (> 2x the logits tolerance of
  `test_torch_model.py`), rollout logps within 2x that tolerance (a
  log-softmax moves by at most twice the largest logit error).
* The GRPO fork (shared prefix blocks + copy-on-write of the boundary
  block) equals the tiled group-1 path bit for bit at temperature 1, as
  `tests/test_prefix_sharing.py` asserts for the reference.
* Pool layout helpers equal the reference's.
* An entry point asked for no device on a machine without CUDA raises.
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
from repro.core import sampling as jsampling  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro.rl.calibration import apply_kv_scales  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.core import sampling as tsampling  # noqa: E402
from repro_torch.rl import rollout as trollout  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# logits tolerances of test_torch_model.py (measured there)
ATOL = {"bf16": 0.08, "trainer_kv": 0.08, "default": 0.4}
# calibrated KV scales: under W8A8 a deeper layer's K amax moves by up to
# two bf16 ulps (1.5% measured), elsewhere they are equal
SCALE_RTOL = {"bf16": 0.0, "trainer_kv": 0.0, "default": 2 ** -5}
PRECISIONS = {"bf16": (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT),
              # trainer-side calibration: fp8 KV with scales handed in
              "trainer_kv": (jp.FP8_KV_ONLY_ROLLOUT.replace(calculate_kv_scales=False),
                             tp.FP8_KV_ONLY_ROLLOUT.replace(calculate_kv_scales=False)),
              "default": (jp.PrecisionConfig(), tp.PrecisionConfig())}
KV_SCALES = np.array([0.011, 0.013], np.float32)   # per layer, for "trainer_kv"
PAGE, MAX_NEW = 4, 8


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.tiny_serving_config()
    params = init_params(cfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, tparams


def _prompts():
    prompts = np.array([[1, 5, 6, 7, 8, 9, 10, 11],
                        [1, 9, 10, 11, 12, 4, 0, 0]], np.int32)
    return prompts, np.array([8, 6], np.int32)


def _reference_step_logits(roll, cfg, prec, prompts, lens, tokens, group, scales):
    """Replay the reference's trajectory with its prefill/decode_step to
    get the logits behind every sampled token: (steps, N, V)."""
    prompts, lens = np.repeat(prompts, group, 0), np.repeat(lens, group, 0)
    cache = init_cache(cfg, len(prompts), prompts.shape[1] + MAX_NEW + 1, prec,
                       page_size=PAGE)
    if scales is not None:
        cache = apply_kv_scales(cache, jax.tree.map(jnp.asarray, scales))
    logits, cache = prefill(roll, {"tokens": jnp.asarray(prompts),
                                   "lengths": jnp.asarray(lens)}, cache, cfg, prec)
    out = [np.asarray(logits)]
    for i in range(tokens.shape[1] - 1):
        logits, cache, _ = decode_step(roll, jnp.asarray(tokens[:, i]), cache, cfg, prec)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("name,group,shared", [
    ("bf16", 1, None), ("bf16", 3, 1), ("default", 1, None), ("default", 3, 1),
    ("trainer_kv", 1, None)])
def test_greedy_generate_matches_reference(setup, name, group, shared):
    cfg, params, tparams = setup
    jprec, tprec = PRECISIONS[name]
    atol = ATOL[name]
    prompts, lens = _prompts()
    jroll, _ = jsync(params, jprec)
    troll, _ = tsync(tparams, tprec)
    kw = dict(page_size=PAGE, num_samples_per_prompt=group, shared_prefix_blocks=shared)
    scales = None
    if name == "trainer_kv":
        scales = {"s0": {"k_scale": KV_SCALES, "v_scale": KV_SCALES[::-1].copy()}}
    jt = jrollout.generate(jroll, jnp.asarray(prompts), jnp.asarray(lens),
                           jax.random.key(0), cfg, jprec,
                           jrollout.SamplerConfig(max_new_tokens=MAX_NEW, temperature=0.0),
                           kv_scales=jax.tree.map(jnp.asarray, scales), **kw)
    tt = trollout.generate(troll, prompts, lens, None, tconfigs.tiny_serving_config(), tprec,
                           trollout.SamplerConfig(max_new_tokens=MAX_NEW, temperature=0.0),
                           kv_scales=scales, device="cpu", **kw)
    j_tok = np.asarray(jt.response_tokens)
    t_tok = tt.response_tokens.numpy()
    assert t_tok.shape == j_tok.shape == (2 * group, MAX_NEW)
    np.testing.assert_array_equal(tt.prompt_tokens.numpy(), np.asarray(jt.prompt_tokens))
    logits = _reference_step_logits(jroll, cfg, jprec, prompts, lens, j_tok, group,
                                    scales)
    srt = np.sort(logits, axis=-1)
    decisive = (srt[..., -1] - srt[..., -2]) > 2 * atol            # (steps, N)
    j_mask = np.asarray(jt.response_mask)
    compared = 0
    for row in range(2 * group):
        n_ok = int(np.argmin(decisive[:, row])) if not decisive[:, row].all() \
            else MAX_NEW
        np.testing.assert_array_equal(t_tok[row, :n_ok], j_tok[row, :n_ok])
        np.testing.assert_array_equal(tt.response_mask.numpy()[row, :n_ok],
                                      j_mask[row, :n_ok])
        np.testing.assert_allclose(tt.rollout_logps.numpy()[row, :n_ok],
                                   np.asarray(jt.rollout_logps)[row, :n_ok],
                                   atol=2 * atol)
        if n_ok == MAX_NEW:
            assert tt.response_lengths[row] == jt.response_lengths[row]
        compared += n_ok
    print(f"{name} group {group}: {compared} of {2 * group * MAX_NEW} tokens decisive")
    assert compared > 0
    # every sample of a greedy group decodes the same continuation
    for i in range(2):
        for s in range(1, group):
            np.testing.assert_array_equal(t_tok[i * group + s], t_tok[i * group])
    for slot, sc in tt.kv_scales.items():
        assert sc["k_scale"].shape == (cfg.n_layers,)
        np.testing.assert_allclose(sc["k_scale"].numpy(),
                                   np.asarray(jt.kv_scales[slot]["k_scale"]),
                                   rtol=SCALE_RTOL[name])
        if scales is not None:      # handed-in scales are used, not recalibrated
            np.testing.assert_array_equal(sc["k_scale"].numpy(), scales[slot]["k_scale"])


@pytest.mark.parametrize("name", ["bf16", "default"])
def test_group_fork_equals_tiled_group1_path(setup, name):
    """Temperature 1, same generator seed: the forked-table group run must
    equal the naive tiled run token for token and logprob for logprob."""
    _, _, tparams = setup
    _, tprec = PRECISIONS[name]
    troll, _ = tsync(tparams, tprec)
    cfg = tconfigs.tiny_serving_config()
    prompts = np.array([[1, 5, 6, 7, 8, 9], [1, 9, 10, 11, 12, 4]], np.int32)
    lens = np.array([6, 6], np.int32)
    samp = trollout.SamplerConfig(max_new_tokens=6, temperature=1.0)
    group = 3
    t_g = trollout.generate(troll, prompts, lens, torch.Generator().manual_seed(7), cfg,
                            tprec, samp, page_size=PAGE, num_samples_per_prompt=group,
                            shared_prefix_blocks=1, device="cpu")
    t_ref = trollout.generate(troll, np.repeat(prompts, group, 0),
                              np.repeat(lens, group, 0), torch.Generator().manual_seed(7),
                              cfg, tprec, samp, page_size=PAGE, device="cpu")
    for field in ("response_tokens", "rollout_logps", "response_mask", "prompt_tokens"):
        assert torch.equal(getattr(t_g, field), getattr(t_ref, field)), field
    resp = t_g.response_tokens.numpy()
    assert any(not np.array_equal(resp[i * group], resp[i * group + 1]) for i in range(2))


def test_pool_layout_helpers_match_reference():
    b, group, p, g, ps = 2, 4, 8, 7, 4
    for shared in (None, 2, 99):
        assert trollout._group_layout(p, g, ps, shared) == \
            jrollout._group_layout(p, g, ps, shared)
    fp, priv, w = trollout._group_layout(p, g, ps, 2)
    np.testing.assert_array_equal(trollout._prefill_tables(b, group, w, fp, priv).numpy(),
                                  np.asarray(jrollout._prefill_tables(b, group, w, fp, priv)))
    jcache = {"slots": {}, "lengths": jnp.full((b,), p, jnp.int32),
              "block_tables": jnp.zeros((b, w), jnp.int32)}
    tcache = {"slots": {}, "lengths": torch.full((b,), p, dtype=torch.int32),
              "block_tables": torch.zeros((b, w), dtype=torch.int32)}
    jf = jrollout._fork_group(jcache, b, group, p, ps, fp, priv, w)
    tf = trollout._fork_group(tcache, b, group, p, ps, fp, priv, w)
    np.testing.assert_array_equal(tf["block_tables"].numpy(), np.asarray(jf["block_tables"]))
    np.testing.assert_array_equal(tf["lengths"].numpy(), np.asarray(jf["lengths"]))


def test_generate_without_device_needs_cuda(setup):
    _, _, tparams = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    prompts, lens = _prompts()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trollout.generate(tparams, prompts, lens, None, tconfigs.tiny_serving_config(),
                          tp.BF16_ROLLOUT)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_top_k_ties_break_to_the_lower_index_like_reference(k):
    """Heavily tied logits: the kept support is exactly k entries and the
    same ones as `lax.top_k` picks (ties to the lower index)."""
    rng = np.random.default_rng(k)
    logits = rng.integers(0, 3, (16, 12)).astype(np.float32)
    j = np.asarray(jsampling._top_k_mask(jnp.asarray(logits), k))
    t = tsampling._top_k_mask(torch.from_numpy(logits), k).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t.sum(-1) == k).all()


def test_greedy_sample_ties_and_logps_match_reference():
    logits = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0]], np.float32)
    jt, jl = jsampling.sample(jnp.asarray(logits), None, 0.0)
    tt, tl = tsampling.sample(torch.from_numpy(logits), None, 0.0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
