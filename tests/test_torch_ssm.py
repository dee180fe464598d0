"""The port's SSM slice (`models.ssm`, SSM slots through the model,
`generate`, the trainer and the launchers) vs the JAX reference.

Parameters: `repro.models.init_params` of the reference's
`tiny_ssm_serving_config` (mamba2-780m reduced: 2 layers, d_model 64,
d_inner 128, 8 heads of 16, state 8, conv 4, tasks vocab) and
`tiny_hybrid_serving_config` (jamba reduced: one attention and one SSM
layer), bridged with `params_from_numpy`; inputs are made with numpy from
a seed.  The reference runs jitted (its compiled form), one jit per
function and module fixture.  Tolerances, measured on the CPU (run with
`-s` to print the gaps):

* the SSD pieces: `_causal_conv` (bf16 out, f32 sums of four taps)
  within CONV_ATOL = 2**-6 absolute, one bf16 ulp at |y| 2-4 (measured
  bit-equal), its tail bit-equal (a gather); `ssd_scan` (f32, the
  intra-chunk operands rounded to bf16) within SCAN_RTOL = 1e-3 of the
  largest output and the final state within 1e-3 relative (measured
  1.2e-5 and 3.4e-5: other summation orders).
* `ssm_forward` (from a state, with `lengths`) and `ssm_decode`, one
  layer: bf16 outputs within SSM_RTOL_BF16 = 2**-6 of the largest output
  (measured 0.0041 and 0.0058, one bf16 ulp), states within STATE_RTOL =
  1e-2 of their largest entry (measured h 6e-6, the conv tail bit-equal);
  under W8A8 (kernel 3's exact fp8 products against the reference's dot
  of dequantized bf16 operands, then w_out's input quantized on either
  side of an fp8 rounding boundary) outputs within SSM_RTOL_W8A8 = 0.06
  (measured 0.040 forward, 0.022 decode), states within STATE_RTOL
  (measured 3.7e-3).
* logits (`forward_train`, `generate`'s scoring) within LOGIT_ATOL =
  0.16, five bf16 ulps of |logits| ~4 (measured 0.039 SSM, 0.117 hybrid;
  test_torch_model.py's bf16 band is 0.08 for attention alone: one
  hybrid period adds an SSM layer and an MLP whose one-ulp flips, in half
  the elements of each layer's output, compound);
  greedy tokens equal to the reference's up to the first step whose
  top-2 logit gap is under 2 x LOGIT_ATOL.
* chunked = one-shot prefill state within STATE_RTOL, next-token logits
  within LOGIT_ATOL (measured 4.2e-3 and 0.008); decode after prefill =
  teacher forcing within LOGIT_ATOL (measured 0.026 SSM, 0.047 hybrid; a
  chunk boundary changes the SSD's summation order).
* greedy `generate` (measured: every token equal, rollout logprobs within
  0.022).
* one update: test_torch_train.py's bounds (stats within 1e-2 relative +
  5e-3, every param within a bf16 ulp + 2 lr of the reference's;
  measured 199 of 56592 params differing).
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
from repro.data import tasks as jtasks  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import forward_train as jforward_train  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro.rl import trainer as jtrainer  # noqa: E402
from repro.serving import request_state_bytes as jstate_bytes  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy, ssm_state_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.core.fp8_params import tree_leaves  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels.config import KernelConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import forward_train as tforward_train  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.transformer import _layer  # noqa: E402
from repro_torch.optim import AdamWConfig as TAdamWConfig  # noqa: E402
from repro_torch.rl import SamplerConfig as TSampler  # noqa: E402
from repro_torch.rl import generate as tgenerate  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402
from repro_torch.rl import trainer as ttrainer  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import request_state_bytes as tstate_bytes  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CONV_ATOL = 2 ** -6
SCAN_RTOL = 1e-3
SSM_RTOL_BF16, SSM_RTOL_W8A8 = 2 ** -6, 0.06
STATE_RTOL = 1e-2
LOGIT_ATOL = 0.16
STAT_RTOL, STAT_ATOL = 1e-2, 5e-3
LR = 3e-4
PRECISIONS = {"bf16": (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT, SSM_RTOL_BF16),
              "w8a8": (jp.PrecisionConfig(), tp.PrecisionConfig(), SSM_RTOL_W8A8)}
PATTERNS = ("ssm", "hybrid")


def _cfgs(pattern):
    name = f"tiny_{pattern}_serving_config"
    return getattr(jconfigs, name)(), getattr(tconfigs, name)()


@pytest.fixture(scope="module")
def models():
    """pattern -> (reference cfg, port cfg, reference params, numpy params)."""
    out = {}
    for pattern in PATTERNS:
        jcfg, tcfg = _cfgs(pattern)
        params = jax.jit(init_params, static_argnums=0)(jcfg, jax.random.key(0))
        out[pattern] = (jcfg, tcfg, params, jax.tree.map(np.asarray, params))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float64)


def _bf16(x):
    """(reference array, port tensor) of the same bf16 values."""
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)


def _rel(got, want):
    return float(np.abs(_np(got) - _np(want)).max() / max(np.abs(_np(want)).max(), 1e-30))


def _tokens(b, t, seed):
    return np.stack([jtasks.random_prompt(seed + i, t) for i in range(b)]).astype(np.int32)


# ---------------------------------------------------------------------------
# the SSD pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_lengths", [False, True], ids=["plain", "lengths"])
def test_causal_conv_matches_reference(with_lengths):
    rng = np.random.default_rng(1)
    b, t, c, w = 3, 9, 24, 4
    xj, xt = _bf16(rng.normal(size=(b, t, c)))
    wj, wt = _bf16(rng.normal(size=(w, c)) * 0.5)
    bj, bt = _bf16(rng.normal(size=(c,)) * 0.1)
    tj, tt = _bf16(rng.normal(size=(b, w - 1, c)))
    lengths = np.array([9, 4, 0], np.int32) if with_lengths else None
    jy, jtail = jax.jit(lambda *a: jssm._causal_conv(*a, lengths=lengths))(xj, wj, bj, tj)
    ty, ttail = tssm._causal_conv(xt, wt, bt, tt, lengths=None if lengths is None
                                  else torch.from_numpy(lengths))
    err = np.abs(_np(ty) - _np(jy)).max()
    print(f"\n_causal_conv ({'lengths' if with_lengths else 'plain'}): max|port - ref| "
          f"{err:.2e}")
    assert err <= CONV_ATOL and ty.dtype == torch.bfloat16
    # the tail is a gather of the inputs: bit-equal
    assert np.array_equal(_np(ttail), _np(jtail))


def test_ssd_scan_with_h0_matches_reference():
    rng = np.random.default_rng(2)
    b, t, h, p, n = 2, 128, 4, 16, 8
    xj, xt = _bf16(rng.normal(size=(b, t, h, p)))
    bj, bt = _bf16(rng.normal(size=(b, t, n)))
    cj, ct = _bf16(rng.normal(size=(b, t, n)))
    dt = np.abs(rng.normal(size=(b, t, h))).astype(np.float32) * 0.5
    a = -np.linspace(1, 16, h).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    jy, jh = jax.jit(lambda *args: jssm.ssd_scan(*args[:5], h0=args[5]))(
        xj, dt, a, bj, cj, h0)
    ty, th = tssm.ssd_scan(xt, torch.from_numpy(dt), torch.from_numpy(a), bt, ct,
                           h0=torch.from_numpy(h0))
    ey, eh = _rel(ty, jy), _rel(th, jh)
    print(f"\nssd_scan: y {ey:.2e}, final state {eh:.2e} of their largest entries")
    assert ey <= SCAN_RTOL and eh <= SCAN_RTOL
    assert ty.dtype == th.dtype == torch.float32


@pytest.mark.parametrize("name", list(PRECISIONS))
def test_ssm_forward_and_decode_match_reference(models, name):
    """One SSM layer: `ssm_forward` from a state with ragged `lengths`
    (returning the state), then `ssm_decode` from the reference's state."""
    jcfg, tcfg, params, np_params = models["ssm"]
    jprec, tprec, rtol = PRECISIONS[name]
    jroll, _ = jsync(params, jprec)
    troll, _ = tsync(params_from_numpy(np_params, "cpu"), tprec)
    jp0 = jax.tree.map(lambda a: a[0], jroll["blocks"]["s0"]["ssm"])
    tp0 = _layer(troll["blocks"]["s0"]["ssm"], 0)
    assert isinstance(tp0["w_in"], QuantizedTensor) == (name == "w8a8")
    rng = np.random.default_rng(3)
    b, t = 3, 70                                   # T not a chunk multiple
    xj, xt = _bf16(rng.normal(size=(b, t, jcfg.d_model)))
    st = jssm.init_ssm_state(b, jcfg)
    st = st._replace(h=jnp.asarray(rng.normal(size=st.h.shape) * 0.1, jnp.float32),
                     conv=_bf16(rng.normal(size=st.conv.shape))[0])
    lengths = np.array([70, 33, 1], np.int32)
    fwd = jax.jit(lambda p, x, s, l: jssm.ssm_forward(x, p, jcfg, jprec, state=s,
                                                      return_state=True, lengths=l))
    jout, jst = fwd(jp0, xj, st, jnp.asarray(lengths))
    tst = ssm_state_from_numpy(jax.tree.map(np.asarray, st), "cpu")
    tout, tnew = tssm.ssm_forward(xt, tp0, tcfg, tprec, state=tst, return_state=True,
                                  lengths=torch.from_numpy(lengths))
    valid = np.arange(t)[None, :] < lengths[:, None]
    e_out = np.abs(_np(tout) - _np(jout))[valid].max() / np.abs(_np(jout)[valid]).max()
    e_h, e_conv = _rel(tnew.h, jst.h), _rel(tnew.conv, jst.conv)
    # decode one token from the reference's state
    dj, dt_ = _bf16(rng.normal(size=(b, 1, jcfg.d_model)))
    jdec, jst2 = jax.jit(lambda p, x, s: jssm.ssm_decode(x, p, jcfg, s, jprec))(jp0, dj, jst)
    tdec, tst2 = tssm.ssm_decode(dt_, tp0, tcfg, ssm_state_from_numpy(
        jax.tree.map(np.asarray, jst), "cpu"), tprec)
    e_dec, e_h2 = _rel(tdec, jdec), _rel(tst2.h, jst2.h)
    print(f"\n{name}: ssm_forward {e_out:.4f} (tol {rtol:.4f}), state h {e_h:.2e}, conv "
          f"{e_conv:.2e}; ssm_decode {e_dec:.4f}, h {e_h2:.2e} (of the largest entries)")
    assert e_out <= rtol and e_dec <= rtol
    assert max(e_h, e_conv, e_h2) <= STATE_RTOL
    assert tnew.h.dtype == torch.float32 and tnew.conv.dtype == torch.bfloat16
    assert tst2.conv.dtype == torch.bfloat16


def test_softplus_matches_reference():
    """`jax.nn.softplus` is logaddexp(x, 0) everywhere, past torch's
    softplus threshold of 20 too."""
    x = np.float32([-30.0, -1.0, 0.0, 1e-3, 1.0, 19.0, 20.5, 25.0, 60.0])
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the model: forward_train, chunked = one-shot, decode = teacher forcing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", PATTERNS)
def test_forward_train_matches_reference(models, pattern):
    jcfg, tcfg, params, np_params = models[pattern]
    tokens = _tokens(2, 70, 10)
    lengths = np.array([70, 45], np.int32)
    jl, _ = jax.jit(lambda p, t, l: jforward_train(p, {"tokens": t, "lengths": l}, jcfg))(
        params, tokens, lengths)
    tl, aux = tforward_train(params_from_numpy(np_params, "cpu"),
                             {"tokens": torch.from_numpy(tokens),
                              "lengths": torch.from_numpy(lengths)}, tcfg)
    err = np.abs(_np(tl) - _np(jl)).max()
    print(f"\n{pattern} forward_train: max|port - ref| {err:.4f} (tol {LOGIT_ATOL})")
    assert err <= LOGIT_ATOL and aux == {"moe": {}}


def _ssm_states(cache):
    return {name: sd["ssm"] for name, sd in cache["slots"].items() if "ssm" in sd}


@pytest.mark.parametrize("pattern", PATTERNS)
def test_chunked_prefill_state_and_decode_match_teacher_forcing(models, pattern):
    """Port only: a chunked prefill (C 4, a ragged last chunk) leaves the
    one-shot prefill's SSM state and next-token logits; greedy decode
    steps after it give teacher forcing's logits."""
    _, tcfg, _, np_params = models[pattern]
    tparams = params_from_numpy(np_params, "cpu")
    model = Transformer(tcfg, "cpu")
    prec = tp.BF16_ROLLOUT
    prompt = _tokens(1, 11, 20)
    one = model.init_cache(1, 24, prec, page_size=4)
    l1, one = model.prefill(tparams, {"tokens": torch.from_numpy(prompt),
                                      "lengths": torch.tensor([11])}, one, prec)
    chunked = model.init_cache(1, 24, prec, page_size=4)
    for start in range(0, 11, 4):
        n = min(4, 11 - start)
        chunk = np.zeros((1, 4), np.int32)
        chunk[0, :n] = prompt[0, start:start + n]
        l2, chunked = model.prefill_chunk(tparams, torch.from_numpy(chunk), [start], [n],
                                          chunked, prec)
    e_state = max(max(_rel(a.h, b.h), _rel(a.conv, b.conv))
                  for a, b in zip(_ssm_states(chunked).values(), _ssm_states(one).values()))
    e_chunk = float((l2 - l1).abs().max())
    # greedy decode from the one-shot cache vs teacher forcing over the
    # whole sequence
    seq, logits = list(prompt[0]), [l1[0]]
    tok = l1.argmax(-1)
    for _ in range(5):
        seq.append(int(tok))
        step, one = model.decode_step(tparams, tok, one, prec)
        logits.append(step[0])
        tok = step.argmax(-1)
    tf, _ = tforward_train(tparams, {"tokens": torch.tensor([seq])}, tcfg)
    e_tf = float((torch.stack(logits) - tf[0, 10:]).abs().max())
    print(f"\n{pattern}: chunked vs one-shot state {e_state:.2e}, logits {e_chunk:.4f}; "
          f"decode vs teacher forcing {e_tf:.4f}")
    assert e_state <= STATE_RTOL and e_chunk <= LOGIT_ATOL and e_tf <= LOGIT_ATOL
    if pattern == "ssm":
        assert "block_tables" not in one and all("ssm" in sd for sd in one["slots"].values())


# ---------------------------------------------------------------------------
# generate: greedy, and GRPO groups over the forked state
# ---------------------------------------------------------------------------

def _equal_prefix(tokens, want, gaps):
    """The number of leading tokens equal to the reference's; where they
    part, the step's top-2 gap (port logits) must be under 2 x
    LOGIT_ATOL (a near-tie either side may break)."""
    for i, (a, b) in enumerate(zip(tokens, want)):
        if a != b:
            assert gaps[i] < 2 * LOGIT_ATOL, (i, gaps[i])
            return i
    return len(want)


@pytest.mark.parametrize("group", [1, 2], ids=["greedy", "grpo"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_generate_matches_reference(models, pattern, group):
    """Greedy `generate` (with group 2 the GRPO fork: the prompts prefilled
    once, every SSM state tiled 2-fold) against the reference's: tokens
    equal up to a near-tie, rollout logprobs within LOGIT_ATOL there."""
    jcfg, tcfg, params, np_params = models[pattern]
    prompts = np.zeros((2, 9), np.int32)
    prompts[0] = jtasks.random_prompt(30, 9)
    prompts[1, :6] = jtasks.random_prompt(31, 6)
    lengths = np.array([9, 6], np.int32)
    g = 6
    jt = jrollout.generate(params, jnp.asarray(prompts), jnp.asarray(lengths),
                           jax.random.key(0), jcfg, jp.BF16_ROLLOUT,
                           jrollout.SamplerConfig(max_new_tokens=g, temperature=0.0),
                           page_size=4, num_samples_per_prompt=group,
                           shared_prefix_blocks=1 if group > 1 else None)
    tparams = params_from_numpy(np_params, "cpu")
    tt = tgenerate(tparams, prompts, lengths, None, tcfg, tp.BF16_ROLLOUT,
                   TSampler(max_new_tokens=g, temperature=0.0), page_size=4,
                   num_samples_per_prompt=group,
                   shared_prefix_blocks=1 if group > 1 else None, device="cpu")
    jtok, jlp = np.asarray(jt.response_tokens), np.asarray(jt.rollout_logps)
    assert tt.response_tokens.shape == jtok.shape == (2 * group, g)
    # the port's own logits along the reference's tokens give each step's gap
    packed = np.array(jrollout.packed_sequences(jt))
    logits, _ = tforward_train(tparams, {"tokens": torch.from_numpy(packed)}, tcfg)
    equal = worst = 0
    for row in range(2 * group):
        lo = int(lengths[row // group]) - 1
        top2 = logits[row, lo:lo + g].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).numpy()
        n = _equal_prefix(tt.response_tokens[row].tolist(), jtok[row].tolist(), gaps)
        equal += n
        if n:
            worst = max(worst, float(np.abs(tt.rollout_logps[row, :n].numpy()
                                            - jlp[row, :n]).max()))
    if group > 1:       # greedy samples of one prompt are one sample
        assert torch.equal(tt.response_tokens[0], tt.response_tokens[1])
    print(f"\n{pattern} group {group}: {equal} of {2 * group * g} tokens equal, logp gap "
          f"{worst:.4f}")
    assert equal >= group * g and worst <= LOGIT_ATOL
    assert tt.kv_scales.keys() == jt.kv_scales.keys()


# ---------------------------------------------------------------------------
# the trainer: one update; the launchers
# ---------------------------------------------------------------------------

def test_update_matches_reference(models):
    jcfg, tcfg, params, np_params = models["ssm"]
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
    jtr = jtrainer.RLTrainer(jcfg, jrl, params=params)
    jparams, _, jstats = jtr._update_fn(params, jtr.opt_state,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
    ttr = ttrainer.RLTrainer(tcfg, trl, params=params_from_numpy(np_params, "cpu"),
                             device="cpu")
    tparams, _, tstats = ttr.update_fn(ttr.params, ttr.opt_state,
                                       {k: torch.tensor(v) for k, v in batch.items()})
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=k)
    n_diff = n_all = 0
    for a, b_ in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
        a, b_ = np.asarray(a).astype(np.float32), b_.float().numpy()
        assert a.shape == b_.shape
        d = np.abs(a - b_)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
        assert np.all(d <= ulp + 2 * LR * 1.01), "a param moved apart"
        n_diff += int((d > 0).sum())
        n_all += d.size
    print(f"\nupdate: loss {float(tstats['loss']):.6f} vs {float(jstats['loss']):.6f}; "
          f"params differing {n_diff} of {n_all}")
    assert n_diff <= 1e-2 * n_all


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_launchers_take_the_arch_reduced(arch):
    layers = ["--layers", "8"] if arch.startswith("jamba") else []
    rows = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
                         "--precision", "default", "--prompt-batch", "2",
                         "--n-per-prompt", "2", "--max-new-tokens", "3",
                         "--eval-every", "100", "--calibration", "trainer", *layers])
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"])
    report = tserve.run(["--arch", arch, "--reduced", "--device", "cpu", "--precision",
                         "default", "--requests", "3", "--max-new", "3", "--slots", "2"])
    assert report["completed"] == 3 and not report["stalled"]
    assert report["kernel_config"] == ("off" if arch.startswith("mamba") else "all")
    assert report["state_bytes_per_request"] > 0


def test_launch_serve_shrink_forces_a_swap_without_kv():
    """An attention-free model never grows KV: `--shrink-at` preempts on its
    slot state alone, and the swap-in charges the state's tokens."""
    report = tserve.run(["--arch", "mamba2-780m", "--reduced", "--device", "cpu",
                         "--precision", "default", "--requests", "6", "--max-new", "8",
                         "--slots", "4", "--admission", "ondemand", "--shrink-at", "2"])
    assert report["completed"] == 6 and not report["stalled"]
    assert report["preemptions"] >= 1 and report["swap_ins"] >= 1
    assert report["kv_bytes_per_token"] == 0 and report["wasted_tokens"] > 0


# ---------------------------------------------------------------------------
# configs, specs, the kernel-config rule, the state bytes
# ---------------------------------------------------------------------------

def test_kernel_config_resolves_off_on_attention_free_models(models):
    """A kept divergence: the port's default is "all" ("off" under
    quantize_attention); on an attention-free model it is "off", and an
    explicit kernel request raises, as the reference's engine asserts."""
    for prec in (tp.PrecisionConfig(), tp.BF16_ROLLOUT, tp.FULL_FP8_ROLLOUT):
        assert KernelConfig.resolve(None, prec, attention_free=True) == KernelConfig()
        assert KernelConfig.resolve("off", prec, attention_free=True) == KernelConfig()
        for spec in ("all", "decode", "prefill"):
            with pytest.raises(ValueError):
                KernelConfig.resolve(spec, prec, attention_free=True)
    assert KernelConfig.resolve(None, tp.PrecisionConfig()).name == "all"
    _, tcfg, _, np_params = models["ssm"]
    roll = params_from_numpy(np_params, "cpu")
    assert ServingEngine(roll, tcfg, tp.PrecisionConfig(), device="cpu").kernels.name == "off"
    with pytest.raises(ValueError):
        ServingEngine(roll, tcfg, tp.PrecisionConfig(), kernel_config="all", device="cpu")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_request_state_bytes_match_reference(pattern):
    jcfg, tcfg = _cfgs(pattern)
    for jprec, tprec in ((jp.BF16_ROLLOUT, tp.BF16_ROLLOUT),
                         (jp.PrecisionConfig(), tp.PrecisionConfig())):
        assert tstate_bytes(tcfg, tprec) == jstate_bytes(jcfg, jprec) > 0
    for arch in ("mamba2-780m", "jamba-1.5-large-398b", "qwen3-8b"):
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        assert tstate_bytes(tc, tp.PrecisionConfig()) == jstate_bytes(jc, jp.PrecisionConfig())
    # mamba2-780m: 48 x (1.57 MB h + 20 KB conv)
    assert tstate_bytes(tconfigs.get_config("mamba2-780m"), tp.PrecisionConfig()) == \
        48 * (48 * 64 * 128 * 4 + 3 * (3072 + 256) * 2)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        elif isinstance(v, QuantizedTensor):
            out[pre + k] = (tuple(v.data.shape), "q")
        else:
            out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_meta_specs_and_shapes_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert [s.name for s in tcfg.shapes()] == [s.name for s in jcfg.shapes()]
    assert tconfigs.LONG_500K in tcfg.shapes()
    want = jax.eval_shape(lambda: init_params(jcfg, jax.random.key(0)))
    flat = {"/".join(str(p.key) for p in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = tsteps.param_specs(tcfg)
    assert _flat(got) == flat
    assert all(v.is_meta for v in tree_leaves(got))
    roll = _flat(tsteps.param_specs(tcfg, tp.PrecisionConfig()))
    ssm_slot = "s0" if arch.startswith("mamba") else "s1"
    for name in ("w_in", "w_out"):
        assert roll[f"blocks/{ssm_slot}/ssm/{name}"][1] == "q"
    for name in ("conv_w", "a_log", "dt_bias", "D"):
        assert roll[f"blocks/{ssm_slot}/ssm/{name}"][1] != "q"
    # the LONG_500K cache: dense KV only in the attention layers
    cache = tsteps.cache_specs(tcfg, tconfigs.LONG_500K, tp.PrecisionConfig())
    jcache = jsteps.cache_specs(jcfg, jconfigs.LONG_500K, jp.PrecisionConfig())
    kv = [sd["kv"] for sd in cache["slots"].values() if "kv" in sd]
    ssm_states = [sd["ssm"] for sd in cache["slots"].values() if "ssm" in sd]
    n_attn = sum(jcfg.is_attn_layer(i) for i in range(jcfg.n_layers))
    assert sum(c.k.shape[0] for c in kv) == n_attn == (0 if arch.startswith("mamba") else 9)
    assert all(c.k.shape[2] == 524288 for c in kv)
    assert sum(s.h.shape[0] for s in ssm_states) == jcfg.n_layers - n_attn
    assert all(s.h.dtype == torch.float32 and s.h.is_meta for s in ssm_states)
    for name, sd in jcache["slots"].items():
        got = cache["slots"][name]
        assert set(got) == set(sd), name
        if "ssm" in sd:
            assert tuple(got["ssm"].h.shape) == sd["ssm"].h.shape
            assert tuple(got["ssm"].conv.shape) == sd["ssm"].conv.shape
        else:
            assert tuple(got["kv"].k.shape) == sd["kv"].k.shape
