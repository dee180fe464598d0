"""The port's RL training path (`repro_torch.rl`, `models.forward_train`,
`launch.train`) vs the JAX reference.

Parameters: `repro.models.init_params` of the reduced qwen3-8b that
`launch.train --reduced` builds (tasks vocab, 2 layers, d_model 128,
4 heads over 1 KV head, d_head 32), bridged with `params_from_numpy`;
every other input is made with numpy from a seed.  Tolerances, measured
on this CPU (run with `-s` to print the gaps):

* correction, advantages, loss and every stat on the same f32 inputs:
  within 1e-6 (relative for values above 1);
* rewards, the prompt pipeline, `packed_sequences` and
  `gather_response_logps`: equal;
* `forward_train` logits and `token_logprobs` in bf16: at most 0.027 and
  0.022 apart (1-2 bf16 ulps at |logit| 3), held at 0.08, the bf16 logits
  tolerance of `test_torch_model.py`;
* `calibrate_kv_scales`: equal (held at one bf16 rounding, 2**-7);
* one update (scoring pass, DAPO loss with TIS, backward, AdamW) on the
  same trajectory batch against the reference's jitted `update_fn`.
  With f32 params the per-leaf gradients agree to 1.8e-6 in relative
  norm (held at 1e-5): the same function.  With bf16 params, as the
  trainer runs, each framework is 1.1-1.8% (relative norm) from the f32
  gradient and the port's distance is at most 1.04x the reference's (held
  at 1.25x); port and reference bf16 gradients are at most 1.7% apart
  (held at 3%).  The loss is 3.9e-4 apart, the stats at most 4e-3
  relative (bf16 logprobs through exp), held at 1e-2 relative + 5e-3;
  0.39% of the new params differ (held at 1%), each by at most one bf16
  ulp + 2 lr (a step-1 AdamW update is lr x sign(g), and g's sign flips
  where g is near 0).

`RLTrainer.train_step` on the CPU is held to itself: its GRPO group
rollout equals the tiled group-1 `generate` with the same generator, a
restored checkpoint continues bit for bit, and `launch.train.main`
returns one metrics row per step.
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
from repro.data import PromptPipeline as JPipeline  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro.models import forward_train as jforward_train  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import token_logprobs as jtoken_logprobs  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.rl import advantage as jadv  # noqa: E402
from repro.rl import correction as jcorr  # noqa: E402
from repro.rl import rewards as jrewards  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro.rl import trainer as jtrainer  # noqa: E402
from repro.rl.calibration import calibrate_kv_scales as jcalibrate  # noqa: E402
from repro.rl.loss import dapo_token_loss as jloss  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import fp8_linear  # noqa: E402
from repro_torch.core.fp8_params import tree_leaves  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.data import PromptPipeline as TPipeline  # noqa: E402
from repro_torch.data import tasks as ttasks  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import forward_train as tforward_train  # noqa: E402
from repro_torch.models import token_logprobs as ttoken_logprobs  # noqa: E402
from repro_torch.models.attention import attention_impl  # noqa: E402
from repro_torch.optim import AdamWConfig as TAdamWConfig  # noqa: E402
from repro_torch.rl import advantage as tadv  # noqa: E402
from repro_torch.rl import correction as tcorr  # noqa: E402
from repro_torch.rl import rewards as trewards  # noqa: E402
from repro_torch.rl import rollout as trollout  # noqa: E402
from repro_torch.rl import trainer as ttrainer  # noqa: E402
from repro_torch.rl.calibration import calibrate_kv_scales as tcalibrate  # noqa: E402
from repro_torch.rl.loss import dapo_token_loss as tloss  # noqa: E402
from repro_torch.rl.weight_sync import sync_policy_weights as tsync  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

F32_TOL = 1e-6
LOGIT_ATOL = 0.08          # bf16 logits (test_torch_model.py's ATOL_BF16)
SCALE_RTOL = 2 ** -7       # kv scales: one bf16 rounding of the amax
STAT_RTOL, STAT_ATOL = 1e-2, 5e-3
GRAD32_RTOL = 1e-5         # f32 params: per-leaf gradient rel-norm error
GRAD_RTOL = 3e-2           # bf16 params: port against reference
BF16_ERR_RATIO = 1.25      # bf16 params: port's distance to the f32 gradient
PARAM_DIFF_FRAC = 1e-2
LR = 3e-4
CORRECTIONS = {"none": jp.RolloutCorrection.NONE, "tis": jp.RolloutCorrection.TIS,
               "mis": jp.RolloutCorrection.MIS}


def _cfgs():
    kw = dict(vocab_size=jtasks.VOCAB_SIZE, n_layers=2, d_model=128)
    return (jget_config("qwen3-8b").reduced(**kw),
            tconfigs.get_config("qwen3-8b").reduced(**kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    params = init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _tparams(np_params):
    return params_from_numpy(np_params, "cpu")


def _close(got, want, rtol=F32_TOL, atol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _logps(rng, shape):
    """Per-token log-probs and a nearby rollout version (ratios 0.3-3)."""
    train = np.log(rng.uniform(0.05, 1.0, size=shape)).astype(np.float32)
    rollout = (train + rng.normal(0, 0.4, size=shape)).astype(np.float32)
    return train, np.minimum(rollout, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# plain tensor math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corr", list(CORRECTIONS))
def test_correction_and_loss_match_reference(corr):
    rng = np.random.default_rng(0)
    b, g, n_ver = 8, 6, 3
    logp_train, logp_roll = _logps(rng, (b, g))
    logp_theta = (logp_train + rng.normal(0, 0.2, size=(b, g))).astype(np.float32)
    mask = (rng.uniform(size=(b, g)) < 0.8).astype(np.float32)
    loss_mask = mask * np.repeat([1.0, 0.0, 1.0, 1.0], 2)[:, None].astype(np.float32)
    adv = rng.normal(size=b).astype(np.float32)
    versions = rng.integers(0, n_ver + 1, size=(b, g)).astype(np.int32)  # one out of range
    jprec = jp.PrecisionConfig(correction=CORRECTIONS[corr])
    tprec = tp.PrecisionConfig(correction=tp.RolloutCorrection(CORRECTIONS[corr].value))
    J = {k: jnp.asarray(v) for k, v in dict(a=logp_train, r=logp_roll, th=logp_theta,
                                            m=mask, lm=loss_mask, adv=adv,
                                            ver=versions).items()}
    T = {k: torch.tensor(np.asarray(v)) for k, v in J.items()}

    _close(tcorr.importance_weights(T["a"], T["r"]), jcorr.importance_weights(J["a"], J["r"]))
    _close(tcorr.tis_weights(T["a"], T["r"], 1.5), jcorr.tis_weights(J["a"], J["r"], 1.5))
    _close(tcorr.mis_mask(T["a"], T["r"], 0.6, 1.7), jcorr.mis_mask(J["a"], J["r"], 0.6, 1.7))
    _close(tcorr.correction_weights(T["a"], T["r"], tprec),
           jcorr.correction_weights(J["a"], J["r"], jprec))
    for normalize in (True, False):
        _close(tcorr.versioned_correction_weights(T["a"], T["r"], T["ver"], T["m"], tprec,
                                                  num_versions=n_ver, normalize=normalize),
               jcorr.versioned_correction_weights(J["a"], J["r"], J["ver"], J["m"], jprec,
                                                  num_versions=n_ver, normalize=normalize))
    for k, v in jcorr.mismatch_kl(J["r"], J["a"], J["m"]).items():
        _close(tcorr.mismatch_kl(T["r"], T["a"], T["m"])[k], v)
    tv = tcorr.versioned_mismatch_stats(T["r"], T["a"], T["ver"], T["m"], num_versions=n_ver)
    for k, v in jcorr.versioned_mismatch_stats(J["r"], J["a"], J["ver"], J["m"],
                                               num_versions=n_ver).items():
        _close(tv[k], v)

    for versioned in (False, True):
        kw = dict(token_versions=J["ver"], num_versions=n_ver) if versioned else {}
        tkw = dict(token_versions=T["ver"], num_versions=n_ver) if versioned else {}
        jl, js = jloss(J["th"], J["a"], J["r"], J["adv"], J["lm"], jprec,
                       metrics_mask=J["m"], **kw)
        th = T["th"].clone().requires_grad_(True)
        tl, ts = tloss(th, T["a"], T["r"], T["adv"], T["lm"], tprec,
                       metrics_mask=T["m"], **tkw)
        _close(float(tl.detach()), float(jl))
        assert set(ts) == set(js)
        for k in js:
            _close(ts[k], js[k])
        # the gradient flows through logp_theta only
        jgrad = jax.grad(lambda x: jloss(x, J["a"], J["r"], J["adv"], J["lm"], jprec,
                                         metrics_mask=J["m"], **kw)[0])(J["th"])
        tl.backward()
        _close(th.grad, jgrad)


def test_advantages_match_reference():
    rng = np.random.default_rng(1)
    n = 4
    rewards = rng.choice([0.0, 0.1, 1.0], size=32).astype(np.float32)
    rewards[:n] = 1.0                                   # one tied group
    _close(tadv.group_advantages(torch.from_numpy(rewards), n),
           jadv.group_advantages(jnp.asarray(rewards), n))
    ds = tadv.dynamic_sampling_mask(torch.from_numpy(rewards), n)
    np.testing.assert_array_equal(ds.numpy(),
                                  np.asarray(jadv.dynamic_sampling_mask(jnp.asarray(rewards), n)))
    assert ds[:n].sum() == 0
    lens = rng.integers(0, 13, size=32).astype(np.int32)
    _close(tadv.overlong_penalty(torch.from_numpy(lens), 12),
           jadv.overlong_penalty(jnp.asarray(lens), 12))


def test_pipeline_and_rewards_match_reference():
    jpipe, tpipe = JPipeline(8, 12, seed=5), TPipeline(8, 12, seed=5)
    rng = np.random.default_rng(2)
    for _ in range(2):
        jb, tb = jpipe.next_batch(), tpipe.next_batch()
        np.testing.assert_array_equal(tb.tokens, jb.tokens)
        np.testing.assert_array_equal(tb.lengths, jb.lengths)
        assert [(p.prompt_ids, p.answer) for p in tb.problems] == \
            [(p.prompt_ids, p.answer) for p in jb.problems]
        # responses: gold, a wrong number, malformed, noise
        resp = np.zeros((8, 8), np.int32)
        lens = np.zeros(8, np.int32)
        for i, p in enumerate(tb.problems):
            ids = {0: ttasks.solution_ids(p),
                   1: [ttasks.ANS] + ttasks.encode("7") + [ttasks.EOS],
                   2: ttasks.encode(p.answer)}.get(i % 4, list(rng.integers(0, 19, 6)))
            ids = ids[:8]
            resp[i, :len(ids)] = ids
            lens[i] = len(ids)
            assert ttasks.decode_ids(ids) == jtasks.decode_ids(ids)
        np.testing.assert_array_equal(trewards.batch_rewards(tb.problems, resp, lens),
                                      jrewards.batch_rewards(jb.problems, resp, lens))
        assert trewards.exact_match_accuracy(tb.problems, resp, lens) == \
            jrewards.exact_match_accuracy(jb.problems, resp, lens)
    assert tpipe.state_dict() == jpipe.state_dict()
    again = TPipeline(1, 1)
    again.load_state_dict(jpipe.state_dict())
    np.testing.assert_array_equal(again.next_batch().tokens, jpipe.next_batch().tokens)


def _trajectory(rng, b=8, p=8, g=6):
    lens = rng.integers(3, p + 1, size=b).astype(np.int32)
    prompt = np.zeros((b, p), np.int32)
    for i in range(b):
        prompt[i, :lens[i]] = rng.integers(4, 19, size=lens[i])
    rlen = rng.integers(1, g + 1, size=b).astype(np.int32)
    resp = np.zeros((b, g), np.int32)
    mask = np.zeros((b, g), np.float32)
    for i in range(b):
        resp[i, :rlen[i]] = rng.integers(2, 19, size=rlen[i])
        mask[i, :rlen[i]] = 1.0
    return dict(prompt_tokens=prompt, prompt_lengths=lens, response_tokens=resp,
                response_mask=mask, rollout_logps=np.zeros((b, g), np.float32),
                response_lengths=rlen, routing=None, kv_scales=None)


def _as(mod, traj, conv):
    return mod.Trajectory(**{k: (conv(v) if v is not None else None) for k, v in traj.items()})


def test_packed_and_gather_match_reference():
    traj = _trajectory(np.random.default_rng(3))
    jt, tt = _as(jrollout, traj, jnp.asarray), _as(trollout, traj, torch.from_numpy)
    packed = trollout.packed_sequences(tt)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jrollout.packed_sequences(jt)))
    score = np.random.default_rng(4).normal(size=(8, 13)).astype(np.float32)
    np.testing.assert_array_equal(
        trollout.gather_response_logps(torch.from_numpy(score), tt).numpy(),
        np.asarray(jrollout.gather_response_logps(jnp.asarray(score), jt)))


# ---------------------------------------------------------------------------
# model: forward_train / token_logprobs / calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_lengths", [False, True], ids=["causal", "lengths"])
def test_forward_train_matches_reference(setup, with_lengths):
    jcfg, tcfg, params, np_params = setup
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 19, size=(4, 20)).astype(np.int32)
    inputs = {"tokens": tokens}
    if with_lengths:
        inputs["lengths"] = np.array([20, 13, 7, 16], np.int32)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    jlogits, _ = jax.jit(lambda p, x: jforward_train(p, x, jcfg))(params, jin)
    jlogp, _ = jax.jit(lambda p, x: jtoken_logprobs(p, x, jcfg))(params, jin)
    tparams = _tparams(np_params)
    tlogits, aux = tforward_train(tparams, tin, tcfg)
    tlogp, _ = ttoken_logprobs(tparams, tin, tcfg)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (4, 20, tcfg.vocab_size)
    assert aux == {"moe": {}}
    d_logits = np.abs(tlogits.numpy() - np.asarray(jlogits)).max()
    d_logp = np.abs(tlogp.numpy() - np.asarray(jlogp)).max()
    print(f"\nforward_train ({'lengths' if with_lengths else 'causal'}): logits {d_logits}, "
          f"token_logprobs {d_logp}")
    assert d_logits <= LOGIT_ATOL and d_logp <= LOGIT_ATOL
    # the chunked attention impl (online softmax) computes the same logits
    with attention_impl("chunked"):
        chunked, _ = tforward_train(tparams, tin, tcfg)
    assert np.abs(chunked.numpy() - np.asarray(jlogits)).max() <= LOGIT_ATOL
    # recorded by autograd (each layer under torch.utils.checkpoint), the
    # same values as without it
    leaf = tparams["blocks"]["s0"]["mlp"]["wd"].clone().requires_grad_(True)
    p = dict(tparams, blocks={"s0": dict(tparams["blocks"]["s0"],
                                         mlp=dict(tparams["blocks"]["s0"]["mlp"], wd=leaf))})
    out, _ = ttoken_logprobs(p, tin, tcfg)
    assert out.requires_grad
    with torch.no_grad():
        assert torch.equal(out, ttoken_logprobs(tparams, tin, tcfg)[0])


def test_calibrate_kv_scales_matches_reference(setup):
    jcfg, tcfg, params, np_params = setup
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, 19, size=(4, 14)).astype(np.int32)
    lengths = np.array([14, 9, 5, 12], np.int32)
    js = jcalibrate(params, {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths)},
                    jcfg)
    ts = tcalibrate(_tparams(np_params), {"tokens": torch.from_numpy(tokens),
                                          "lengths": torch.from_numpy(lengths)}, tcfg)
    assert set(ts) == set(js) == {"s0"}
    for k in ("k_scale", "v_scale"):
        assert ts["s0"][k].shape == (2,)
        np.testing.assert_allclose(ts["s0"][k].numpy(), np.asarray(js["s0"][k]), rtol=SCALE_RTOL)


def test_dot_backward_is_the_card_gemm_on_meta():
    """`_dot` on the card is `aten::mm.dtype`, which has no derivative of
    its own; "meta" takes the card's branch, so its backward runs here."""
    x = torch.empty((2, 3, 8), dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty((8, 4), dtype=torch.bfloat16, device="meta", requires_grad=True)
    out = fp8_linear._dot(x, w)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 4)
    nodes, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None:
            nodes.add(type(fn).__name__)
            todo.extend(f for f, _ in fn.next_functions)
    assert "_MmF32Backward" in nodes, nodes
    out.float().sum().backward()
    assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16
    assert w.grad.shape == w.shape and w.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the update and the trainer
# ---------------------------------------------------------------------------

def _update_batch(jcfg, params, rng, n=4):
    traj = _trajectory(rng)
    jt = _as(jrollout, traj, jnp.asarray)
    packed = np.asarray(jrollout.packed_sequences(jt))
    lp, _ = jtrainer._score_logprobs(params, {"tokens": jnp.asarray(packed)}, jcfg)
    resp_lp = np.asarray(jrollout.gather_response_logps(lp, jt))
    mask = traj["response_mask"]
    rollout = ((resp_lp + rng.normal(0, 0.3, size=resp_lp.shape)) * mask).astype(np.float32)
    adv = np.repeat(rng.normal(size=len(mask) // n), n).astype(np.float32)
    return dict(packed_tokens=packed, prompt_lengths=traj["prompt_lengths"],
                rollout_logps=rollout, advantages=adv, mask=mask, response_mask=mask)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jgrads(params, jbatch, jcfg, precision):
    """The reference update_fn's gradient, jitted."""
    def loss(p):
        lp = jtrainer._gather(jtrainer._score_logprobs(
            p, {"tokens": jbatch["packed_tokens"]}, jcfg)[0], jbatch)
        return jloss(lp, jax.lax.stop_gradient(lp), jbatch["rollout_logps"],
                     jbatch["advantages"], jbatch["mask"], precision,
                     metrics_mask=jbatch["response_mask"])[0]
    return jax.jit(jax.grad(loss))(params)


def _grad_errors(jgrads, tgrads, jtruth=None):
    """Per leaf: rel-norm error of the port's grads against the reference's
    (against `jtruth` for both, as a pair, when given)."""
    out = {}
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        keys = [p.key for p in path]
        tg, truth = tgrads, jtruth
        for k in keys:
            tg = tg[k]
            truth = truth[k] if truth is not None else None
        tg = tg.float().numpy()
        jg = np.asarray(jg, np.float32)
        out["/".join(keys)] = (_rel_norm(tg, jg) if truth is None else
                               (_rel_norm(tg, truth), _rel_norm(jg, truth)))
    return out


def test_update_matches_reference(setup):
    jcfg, tcfg, params, np_params = setup
    batch = _update_batch(jcfg, params, np.random.default_rng(7))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    jrl = jtrainer.RLConfig(precision=jp.PrecisionConfig(),
                            optimizer=JAdamWConfig(lr=LR, b2=0.98, grad_clip=1.0))
    trl = ttrainer.RLConfig(precision=tp.PrecisionConfig(),
                            optimizer=TAdamWConfig(lr=LR, b2=0.98, grad_clip=1.0))

    # the same function: with f32 params the gradients agree to f32 sums
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jg32 = _jgrads(params32, jbatch, jcfg, jrl.precision)
    tr32 = ttrainer.RLTrainer(tcfg, trl, device="cpu",
                              params=_tparams(jax.tree.map(np.asarray, params32)))
    f32_err = _grad_errors(jg32, tr32.loss_and_grads(tr32.params, tbatch)[2])
    assert max(f32_err.values()) <= GRAD32_RTOL, f32_err

    # bf16, as the trainer runs: each framework's own bf16 error
    jtr = jtrainer.RLTrainer(jcfg, jrl, params=params)
    jgrads = _jgrads(params, jbatch, jcfg, jrl.precision)
    jparams, _, jstats = jtr._update_fn(params, jtr.opt_state, jbatch)
    ttr = ttrainer.RLTrainer(tcfg, trl, params=_tparams(np_params), device="cpu")
    _, _, tgrads = ttr.loss_and_grads(ttr.params, tbatch)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(tgrads))
    grad_err = _grad_errors(jgrads, tgrads)
    truth = jax.tree.map(lambda a: np.asarray(a, np.float32), jg32)
    vs_f32 = _grad_errors(jgrads, tgrads, truth)
    timings = {}
    tparams, _, tstats = ttr.update_fn(ttr.params, ttr.opt_state, tbatch, timings)
    assert set(timings) == {"score_backward_ms", "optimizer_ms"}

    assert set(tstats) == set(jstats)
    stat_err = {k: abs(float(tstats[k]) - float(jstats[k])) for k in jstats}
    for k in jstats:
        _close(float(tstats[k]), float(jstats[k]), rtol=STAT_RTOL, atol=STAT_ATOL)
    n_diff = n_all = 0
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
        a, b = np.asarray(a).astype(np.float32), b.float().numpy()
        d = np.abs(a - b)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
        assert np.all(d <= ulp + 2 * LR * 1.01), "a param moved apart"
        n_diff += int((d > 0).sum())
        n_all += d.size
    print(f"\nupdate: stats {stat_err}\nf32 grad errors {f32_err}\n"
          f"bf16 grad errors {grad_err}\nbf16 vs f32 (port, reference) {vs_f32}\n"
          f"params differing {n_diff} of {n_all}")
    assert max(grad_err.values()) <= GRAD_RTOL
    for port, ref in vs_f32.values():
        assert port <= BF16_ERR_RATIO * ref
    assert n_diff <= PARAM_DIFF_FRAC * n_all


def _trainer(tcfg, **kw):
    defaults = dict(precision=tp.FP8_LINEAR_ROLLOUT, prompt_batch=2, n_per_prompt=3,
                    max_new_tokens=6, seed=0)
    defaults.update(kw)
    return ttrainer.RLTrainer(tcfg, ttrainer.RLConfig(**defaults), device="cpu")


def test_train_step_runs_and_its_rollout_is_the_tiled_path(setup):
    """The trainer's GRPO group rollout (prefill once, fork) equals group-1
    `generate` on tiled prompts with the same generator, bit for bit."""
    _, tcfg, _, _ = setup
    tr, twin = _trainer(tcfg), _trainer(tcfg)
    m = tr.train_step()
    for k in ("loss", "reward_mean", "accuracy", "mismatch_kl", "corr_weight_ess",
              "response_len_mean", "grad_norm", "rollout_tokens_per_s", "sync_ms",
              "score_backward_ms", "optimizer_ms"):
        assert np.isfinite(m[k]), k
    assert m["step"] == 1 and m["mismatch_kl"] >= 0

    batch = twin.pipeline.next_batch()
    roll, _ = tsync(twin.params, twin.rl.precision)
    n = twin.rl.n_per_prompt
    traj = trollout.generate(roll, np.repeat(batch.tokens, n, 0), np.repeat(batch.lengths, n),
                             twin.generator, tcfg, twin.rl.precision, twin.sampler,
                             device="cpu")
    ub = tr.last_update_batch
    assert torch.equal(ub["packed_tokens"], trollout.packed_sequences(traj))
    assert torch.equal(ub["rollout_logps"], traj.rollout_logps)
    assert torch.equal(ub["response_mask"], traj.response_mask)


def test_trainer_checkpoint_restart_bitwise(setup, tmp_path):
    _, tcfg, _, _ = setup
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=2, prompt_batch=4, n_per_prompt=4,
              optimizer=TAdamWConfig(lr=3e-3, fp8_moments=True))
    tr1 = _trainer(tcfg, **kw)
    for _ in range(2):
        tr1.train_step()                      # checkpoint at step 2
    m_next = tr1.train_step()
    tr2 = _trainer(tcfg, **kw)
    assert tr2.restore_checkpoint() and tr2.step_idx == 2
    assert tr2.pipeline.step == 2 and int(tr2.opt_state.step) == 2
    m_resume = tr2.train_step()
    for k in ("loss", "reward_mean", "grad_norm", "mismatch_kl", "response_len_mean"):
        assert m_resume[k] == m_next[k], k
    for a, b in zip(tree_leaves(tr1.params), tree_leaves(tr2.params)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_trainer_side_calibration_runs(setup):
    _, tcfg, _, _ = setup
    tr = _trainer(tcfg, precision=tp.PrecisionConfig(), calibration="trainer")
    tr.train_step()
    assert set(tr.kv_scales) == {"s0"} and tr.kv_scales["s0"]["k_scale"].shape == (2,)
    assert np.isfinite(tr.train_step()["loss"])
    assert 0.0 <= tr.evaluate(n_problems=4) <= 1.0


def test_launch_train_returns_a_row_per_step(capsys):
    rows = tlaunch.main(["--reduced", "--device", "cpu", "--steps", "2",
                         "--precision", "fp8-linear"])
    assert [r["step"] for r in rows] == [1, 2]
    assert "eval_accuracy" in rows[0] and np.isfinite(rows[1]["loss"])
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


@pytest.mark.parametrize("argv", [[], ["--precision", "e2e-fp8"]], ids=["fp8", "e2e-fp8"])
def test_launch_train_full_fp8_presets_run(argv):
    """The reference's default `--precision fp8` (FULL_FP8_ROLLOUT) and
    `e2e-fp8` run, and train alike: the scoring pass takes no precision."""
    rows = tlaunch.main(["--reduced", "--device", "cpu", "--steps", "2", "--prompt-batch",
                         "2", "--n-per-prompt", "2", "--max-new-tokens", "4"] + argv)
    assert [r["step"] for r in rows] == [1, 2]
    assert np.isfinite(rows[1]["loss"]) and np.isfinite(rows[0]["mismatch_kl"])


def test_fleet_backend_and_no_device_raise(setup):
    """The fleet backend is ported (held to the reference in
    test_torch_fleet.py); a fleet of no replicas and an unknown backend
    raise, and so does a trainer asked for no device without CUDA."""
    _, tcfg, _, _ = setup
    with pytest.raises(ValueError, match="fleet_replicas 0"):
        _trainer(tcfg, rollout_backend="fleet", fleet_replicas=0)
    with pytest.raises(ValueError, match="rollout_backend 'async'"):
        _trainer(tcfg, rollout_backend="async")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.RLTrainer(tcfg, ttrainer.RLConfig(precision=tp.PrecisionConfig()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--reduced", "--steps", "1", "--precision", "default"])
