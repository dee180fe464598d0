"""The port's AdamW (`repro_torch.optim`) and checkpointer vs the JAX reference.

Parameters: `repro.models.init_params` of the reduced qwen3-8b that
`launch.train --reduced` builds (tasks vocab, 2 layers, d_model 128),
bridged with `params_from_numpy`; gradients drawn with numpy from a seed.

* `update` on the same gradients, 3 steps, the clip active and weight
  decay on, f32 and fp8 moments, against the reference's jitted `update`;
  each step starts the port from the reference's params and moments.
  Measured: the global norm differs by 1.7e-6 relative (f32 sums in
  another order), so the clip scale does too; f32 moments differ by at
  most 3.4e-6 of their leaf's largest magnitude (held at 1e-5); at most 2
  of 284160 bf16 params differ, by one ulp (held at 1e-4 of them); fp8
  payloads differ in at most 256 of 568320 m and v bytes, each by one
  E4M3 code, where the f32 moment lies on a rounding tie within that
  1.7e-6 (held at 1e-3 of them), scales within 1e-5.  (Fed its own state
  instead, a tie's one-code difference is carried into later steps.)
* The chunked update (one chunk per leading row, forced small) equals the
  whole-leaf update bit for bit; the chunked global norm is within 1e-6.
* Zero moments built without an f32 copy equal quantized zeros bit for
  bit; `init` and `state_bytes` equal the reference's.
* Checkpoint save -> restore round-trips bf16, fp8 and int leaves bit for
  bit, keeps the newest `keep` steps and refuses a tree that does not fit.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data import tasks  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core.fp8_params import tree_leaves  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

MOMENT_ATOL = 1e-5        # x max|m| of the leaf (3.4e-6 measured)
PARAM_DIFF_FRAC = 1e-4    # params one bf16 ulp apart (2 of 284160 measured)
PAYLOAD_DIFF_FRAC = 1e-3  # m and v bytes at rounding ties (see the docstring)
NORM_RTOL = 1e-5          # global norm and clip scale (1.7e-6 measured)


def _is_qt(x):
    return isinstance(x, ja.QuantizedTensor)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-8b").reduced(vocab_size=tasks.VOCAB_SIZE, n_layers=2,
                                         d_model=128)
    params = init_params(cfg, jax.random.key(0))
    return params, jax.tree.map(np.asarray, params)


def _grads(np_params, rng, scale=0.05):
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(a.dtype),
                        np_params)


def _config(mod, fp8, **kw):
    conf = dict(lr=3e-4, b2=0.98, grad_clip=1.0, fp8_moments=fp8, weight_decay=0.01)
    conf.update(kw)
    return mod.AdamWConfig(**conf)


def _ulp_bf16(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _bridge_state(jstate):
    def conv(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    return ta.AdamWState(step=torch.tensor(int(jstate.step), dtype=torch.int32),
                         m=conv(jstate.m), v=conv(jstate.v))


@pytest.mark.parametrize("fp8", [False, True], ids=["f32_moments", "fp8_moments"])
def test_update_matches_reference(setup, fp8):
    """Three steps; each starts the port from the reference's params and
    moments, so a step's differences are that step's own."""
    params, np_params = setup
    jc, tc = _config(ja, fp8), _config(ta, fp8)
    upd = jax.jit(lambda p, g, s: ja.update(p, g, s, jc))
    jparams, jstate = params, ja.init(params, jc)
    rng = np.random.default_rng(1)
    worst = {"params": 0, "payload": 0, "moment": 0.0}
    for _ in range(3):
        g = _grads(np_params, rng)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        tstate = _bridge_state(jstate)
        jparams, jstate, jstats = upd(jparams, jax.tree.map(jnp.asarray, g), jstate)
        tparams, tstate, tstats = ta.update(tparams, params_from_numpy(g, "cpu"), tstate, tc)
        assert set(tstats) == set(jstats)
        for k in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=NORM_RTOL)
        assert float(tstats["lr"]) == float(jstats["lr"])
        assert int(tstate.step) == int(jstate.step)
        n_diff = n_all = 0
        for a, b in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
            a, b = np.asarray(a).astype(np.float32), b.float().numpy()
            d = np.abs(a - b)
            assert np.all(d <= _ulp_bf16(a)), "a param differs by more than one bf16 ulp"
            n_diff += int((d > 0).sum())
            n_all += d.size
        assert n_diff <= PARAM_DIFF_FRAC * n_all, (n_diff, n_all)
        worst["params"] = max(worst["params"], n_diff)
        n_diff = n_all = 0
        for jm, tm in ((jstate.m, tstate.m), (jstate.v, tstate.v)):
            for a, b in zip(jax.tree.leaves(jm, is_leaf=_is_qt), tree_leaves(tm)):
                if fp8:
                    np.testing.assert_allclose(b.scales.numpy(), np.asarray(a.scales),
                                               rtol=NORM_RTOL)
                    ab = np.asarray(a.data).view(np.uint8).astype(np.int16)
                    bb = b.data.view(torch.uint8).numpy().astype(np.int16)
                    n_diff += int((ab != bb).sum())
                    n_all += ab.size
                    # a tie rounds to a neighbour: one E4M3 code apart
                    assert np.all(np.abs(ab - bb)[ab != bb] == 1)
                else:
                    a = np.asarray(a)
                    err = np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-30)
                    assert err <= MOMENT_ATOL, err
                    worst["moment"] = max(worst["moment"], float(err))
        assert n_diff <= PAYLOAD_DIFF_FRAC * n_all, (n_diff, n_all)
        worst["payload"] = max(worst["payload"], n_diff)
    print(f"\nadamw fp8_moments={fp8}: {worst}")


@pytest.mark.parametrize("fp8", [False, True], ids=["f32_moments", "fp8_moments"])
def test_chunked_update_equals_whole_leaf(setup, fp8, monkeypatch):
    _, np_params = setup
    rng = np.random.default_rng(2)
    g = _grads(np_params, rng)
    tc = _config(ta, fp8, grad_clip=0.0)    # scale 1: no norm in the arithmetic
    runs = []
    for chunk in (1 << 26, 1000):           # whole leaves; chunks of 1-7 rows
        monkeypatch.setattr(ta, "CHUNK_ELEMS", chunk)
        p = params_from_numpy(np_params, "cpu")
        state = ta.init(p, tc)
        for _ in range(2):
            p, state, _ = ta.update(p, params_from_numpy(g, "cpu"), state, tc)
        runs.append((p, state))
    (pa, sa), (pb, sb) = runs
    assert len(ta._chunk_ranges(pa["blocks"]["s0"]["mlp"]["wg"])) == 2
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(tree_leaves({"m": sa.m, "v": sa.v}), tree_leaves({"m": sb.m, "v": sb.v})):
        if fp8:
            assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))
            assert torch.equal(a.scales, b.scales)
        else:
            assert torch.equal(a, b)
    tg = params_from_numpy(g, "cpu")
    whole = ta.global_norm(tg)
    monkeypatch.setattr(ta, "CHUNK_ELEMS", 1000)
    np.testing.assert_allclose(float(ta.global_norm(tg)), float(whole), rtol=1e-6)


def test_init_and_state_bytes_match_reference(setup):
    params, np_params = setup
    tparams = params_from_numpy(np_params, "cpu")
    for fp8 in (False, True):
        jstate = ja.init(params, _config(ja, fp8))
        tstate = ta.init(tparams, _config(ta, fp8))
        assert ta.state_bytes(tstate) == ja.state_bytes(jstate)
        for a, b in zip(jax.tree.leaves(jstate.m, is_leaf=_is_qt), tree_leaves(tstate.m)):
            if fp8:
                np.testing.assert_array_equal(b.data.view(torch.uint8).numpy(),
                                              np.asarray(a.data).view(np.uint8))
                np.testing.assert_array_equal(b.scales.numpy(), np.asarray(a.scales))
                assert b.block == tuple(a.block)
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # a zero moment built in place == the quantizer on f32 zeros, 0-dim too
    for shape in ((2, 128, 300), (19, 128), (5,), ()):
        p = torch.zeros(shape, dtype=torch.bfloat16)
        z, q = ta._zero_moment(p, True), ta._quant_moment(torch.zeros(shape))
        assert torch.equal(z.data.view(torch.uint8), q.data.view(torch.uint8))
        assert torch.equal(z.scales, q.scales) and z.block == q.block


def _tree(seed):
    gen = torch.Generator().manual_seed(seed)
    qt = QuantizedTensor(torch.randn((2, 4, 256), generator=gen).to(torch.float8_e4m3fn),
                         torch.rand((2, 4, 2), generator=gen), (1, 1, 128))
    return {"params": {"w": torch.randn((2, 3, 5), generator=gen).to(torch.bfloat16),
                       "norm": torch.randn((7,), generator=gen)},
            "opt": ta.AdamWState(step=torch.tensor(seed, dtype=torch.int32),
                                 m={"w": qt, "norm": torch.randn((7,), generator=gen)},
                                 v={"w": qt, "norm": torch.zeros(())}),
            "key": torch.Generator().manual_seed(seed).get_state()}


def _assert_tree_bits_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_bits_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            _assert_tree_bits_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    else:
        assert a == b


def test_checkpoint_round_trip_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, _tree(step), extra={"pipeline": {"step": step}, "step_idx": step})
    os.makedirs(tmp_path / "step_9.tmp")            # a crashed write
    ck.save(4, _tree(4), extra={"step_idx": 4})
    assert ck.steps() == [3, 4] and not (tmp_path / "step_9.tmp").exists()
    tree, extra, step = ck.restore(_tree(0))
    assert step == 4 and extra == {"step_idx": 4}
    _assert_tree_bits_equal(tree, _tree(4))
    tree, extra, _ = ck.restore(_tree(0), step=3)
    _assert_tree_bits_equal(tree, _tree(3))
    assert extra["pipeline"] == {"step": 3}
    bad = _tree(0)
    bad["params"]["w"] = torch.zeros((2, 3, 6), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        ck.restore(bad)
