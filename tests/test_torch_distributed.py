"""The port's distributed runtime on spawned gloo ranks, against the
reference's in-process oracles.

One group of 8 CPU ranks (`_torch_dist_worker.RankGroup`: `spawn`
processes that import only torch and `repro_torch`, joined through a
`FileStore`) serves the whole module; this process computes the
reference's results and compares.

  * `compressed_psum` / `compressed_pmean` against the reference's under
    `jax.vmap(axis_name="data")` (one rank per mapped row);
  * `pipeline_apply` (2 replicas x 4 stages) against the sequential stack;
  * the sharded `make_train_step` on a (2, 4) data x model mesh: the
    reduced llama3.2-3b of the reference's distributed test against the
    reference's jitted single-device loss, with the reference's shard
    shapes; the reduced granite-moe-3b-a800m against the port's
    one-process step; the `repeat` attention impl against the naive one;
  * fp8 AdamW moments of sharded params against one process (bit-equal);
  * the sharded W8A8 prefill and serve steps against one process, and
    the same check failing with a fault planted in the sharded linear.

The reference's own sharded step cannot be the oracle: on JAX 0.9 its
sharded embedding gather raises `ShardingTypeError`
(`test_distributed.py::test_sharded_matches_single_device`).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist_worker import RankGroup

WORLD = 8
SHAPES = [(4, 333), (2, 256)]
SERVE_CASES = [("dense", "default"), ("dense", "fp8"), ("ssm", "default")]
SERVE_STEPS = 3
# the sharded steps' logits against one process's (max|logit| 1.1-1.3
# dense, 3.3 SSM): measured gaps 0.0508 dense default, 0.0508 dense
# FULL_FP8 (one bf16 rounding of the row-parallel partials, then kernel
# 1's fp8 rounding of the next layer's inputs flipping an element), 0.0
# SSM (its linears all gathered); the planted faults of SERVE_FAULTS gap
# 0.30-1.20 (no row-parallel sum 0.86-1.20, scale blocks one off
# 0.30-0.38)
SERVE_ATOL = 0.1
DECISIVE_GAP = 2 * SERVE_ATOL       # argmax cannot flip above it
SERVE_FAULTS = ["no_reduce", "scale_offset"]
DTYPES = ["float32", "bfloat16"]


def _compress_inputs(shape, dtype):
    """Each rank's contribution x[rank], rounded to `dtype`, as f32."""
    xs = np.random.default_rng(0).standard_normal((WORLD, *shape)).astype(np.float32)
    return np.asarray(jnp.asarray(xs, getattr(jnp, dtype)).astype(jnp.float32))


def _pipeline_inputs():
    s, m, mb, d = 4, 8, 2, 16
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((s, d, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((s, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, mb, d)).astype(np.float32)
    return w, b, x


def _nested_inputs():
    rng = np.random.default_rng(4)
    return {"x": rng.standard_normal((8, 4, 16)).astype(np.float32),
            "w": rng.standard_normal((16, 8)).astype(np.float32)}


def _moe_tokens():
    return np.random.default_rng(3).integers(0, 256, (8, 16)).astype(np.int64)


def _ref_cfg():
    from repro.configs import get_config
    return get_config("llama3.2-3b").reduced(
        d_model=64, d_ff=128, vocab_size=256, n_layers=2, n_heads=4,
        n_kv_heads=2, d_head=16)


@functools.lru_cache(maxsize=1)
def _ref_dense():
    """f32 params of the reference test's config (numpy; the shapes of the
    reference's param tree, drawn from a seed: norm scales 1, the
    embedding x 0.02, the rest x fan_in^-0.5) and its (8, 16) tokens."""
    from repro.launch.steps import param_specs

    rng = np.random.default_rng(2)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return np.ones(leaf.shape, np.float32)
        scale = 0.02 if "emb" in name else leaf.shape[-2] ** -0.5
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, param_specs(_ref_cfg()))
    return params, rng.integers(0, 256, (8, 16)).astype(np.int64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The group, with every test's job registered (each is sent to the
    ranks when a test first collects it)."""
    group = RankGroup(WORLD, str(tmp_path_factory.mktemp("gloo") / "store"))
    for dtype in DTYPES:
        for shape in SHAPES:
            group.submit(f"compress-{dtype}-{shape}", "compress",
                         xs=_compress_inputs(shape, dtype), dtype=dtype)
    w, b, x = _pipeline_inputs()
    group.submit("pipeline", "pipeline", w=w, b=b, x=x)
    params, tokens = _ref_dense()
    group.submit("dense_step", "dense_step", params_np=params, tokens=tokens)
    group.submit("moe_step", "moe_step", tokens=_moe_tokens())
    group.submit("repeat_step", "repeat_step", params_np=params, tokens=tokens)
    group.submit("fp8_moments", "fp8_moments", steps=2)
    for arch, precision in SERVE_CASES:
        group.submit(f"serve-{arch}-{precision}", "sharded_serve", arch=arch,
                     precision=precision, steps=SERVE_STEPS, decisive_gap=DECISIVE_GAP)
    for fault in SERVE_FAULTS:
        group.submit(f"serve-fault-{fault}", "sharded_serve", arch="dense",
                     precision="default", steps=SERVE_STEPS, decisive_gap=DECISIVE_GAP,
                     fault=fault)
    group.submit("nested_rows", "nested_rows", **_nested_inputs())
    yield group
    group.close()


def _ulp_close(got, want, dtype):
    """Within one ulp of `dtype` (f32 or bf16) at the result's largest
    magnitude: the port sums the ranks' terms in rank order, XLA in its
    own order, and an element that cancels to near zero keeps the
    rounding of its largest terms."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.float32(np.abs(want).max()))
    if dtype == "bfloat16":
        ulp *= 1 << 16          # bf16 keeps 8 of f32's 24 significand bits
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_compressed_psum_matches_reference(ranks, shape, dtype):
    from repro.distributed.compression import comm_bytes as ref_comm_bytes
    from repro.distributed.compression import compressed_pmean as ref_pmean
    from repro.distributed.compression import compressed_psum as ref_psum

    from repro_torch.distributed.compression import comm_bytes

    xs_in = _compress_inputs(shape, dtype)
    xj = jnp.asarray(xs_in, getattr(jnp, dtype))
    want_sum = np.asarray(jax.jit(jax.vmap(lambda a: ref_psum(a, "data"),
                                           axis_name="data"))(xj)[0], np.float32)
    want_mean = np.asarray(jax.jit(jax.vmap(lambda a: ref_pmean(a, "data"),
                                            axis_name="data"))(xj)[0], np.float32)
    got = ranks.collect(f"compress-{dtype}-{shape}")
    for r in got:       # every rank computes the same sum
        np.testing.assert_array_equal(r["psum"], got[0]["psum"])
        np.testing.assert_array_equal(r["pmean"], got[0]["pmean"])
    _ulp_close(got[0]["psum"], want_sum, dtype)
    _ulp_close(got[0]["pmean"], want_mean, dtype)
    exact = xs_in.sum(0)
    rel = np.abs(got[0]["psum"] - exact).mean() / (np.abs(exact).mean() + 1e-9)
    assert rel < 0.03, rel
    n = int(np.prod(shape))
    for compressed in (True, False):
        assert comm_bytes(n, WORLD, compressed) == ref_comm_bytes(n, WORLD, compressed)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def test_pipeline_matches_sequential(ranks):
    from repro.distributed import bubble_fraction as ref_bubble

    w, b, x = _pipeline_inputs()
    ref = jnp.asarray(x)
    for i in range(w.shape[0]):
        ref = jnp.tanh(ref @ w[i] + b[i])
    got = ranks.collect("pipeline")
    for r in got:       # both replicas, every stage
        np.testing.assert_allclose(r["out"], np.asarray(ref), rtol=2e-5, atol=2e-5)
        assert r["bubble"] == ref_bubble(4, 8)
        # each rank holds only its own stage's slice (`shard_stages`)
        assert r["local_shapes"] == {"w": (1,) + w.shape[1:], "b": (1,) + b.shape[1:]}
    assert abs(got[0]["bubble"] - 3 / 11) < 1e-9


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def _ref_loss(params, tokens):
    """The reference's jitted single-device loss."""
    from repro.models import forward_train

    cfg = _ref_cfg()

    def loss_fn(p, t):
        logits, _ = forward_train(p, {"tokens": t}, cfg)
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(lp, t[:, 1:, None], -1))

    return float(jax.jit(loss_fn)(params, jnp.asarray(tokens, jnp.int32)))


def test_sharded_train_step_matches_reference(ranks):
    from jax.sharding import AbstractMesh

    from repro.distributed.sharding import ShardingRules as RefRules
    from repro.distributed.sharding import _path_str

    params, tokens = _ref_dense()
    ref_loss = _ref_loss(params, tokens)
    got = ranks.collect("dense_step")
    losses = [r["losses"][0] for r in got]
    assert all(v == losses[0] for v in losses), losses
    assert abs(losses[0] - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss)), (losses[0], ref_loss)
    # each rank holds the reference's shard of every leaf
    rules = RefRules(AbstractMesh((2, 4), ("data", "model")), zero3=True)
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(rules.params(params)):
        leaf = params
        for k in _path_str(path).split("/"):
            leaf = leaf[k]
        want[_path_str(path)] = tuple(sh.shard_shape(leaf.shape))
    assert got[0]["local_shapes"] == want
    # ZeRO-3 gathers the params; the gradients are reduced
    comms = set(got[0]["comms"])
    assert "all_gather_into_tensor" in comms, comms
    assert comms & {"all_reduce", "reduce_scatter_tensor"}, comms


def test_sharded_moe_step_matches_one_process(ranks):
    got = ranks.collect("moe_step")
    sharded, plain = got[0]["sharded"], got[0]["plain"]
    for r in got[1:]:
        assert r["losses"] == sharded["losses"]
    # the second loss is after one update of every param
    np.testing.assert_allclose(sharded["losses"], plain["losses"], rtol=1e-5)
    comms = set(sharded["comms"])
    assert "all_gather_into_tensor" in comms and comms & {"all_reduce", "reduce_scatter_tensor"}


def test_sharded_step_repeat_impl_matches_naive(ranks):
    """The sharded loss with K/V repeated to the flat heads (the layout a
    model axis can shard when KVH < tp) equals the naive sharded step's."""
    naive = ranks.collect("dense_step")[0]["losses"][0]
    for r in ranks.collect("repeat_step"):
        np.testing.assert_allclose(r["loss"], naive, rtol=1e-6)


# ---------------------------------------------------------------------------
# fp8 moments of sharded params, sharded W8A8 prefill and serve steps
# ---------------------------------------------------------------------------

def test_sharded_fp8_moments_match_one_process(ranks):
    """Two sharded AdamW updates with fp8 moments leave every moment's
    payload and scales bit-equal to the one-process update's, and the
    params equal, also where a shard boundary splits a 128-block (wq's
    last axis, 192 over the 4-way model axis)."""
    for r in ranks.collect("fp8_moments"):
        assert r["bad"] == [], r["bad"]
        assert r["param_diff"] == 0.0
        assert "m/blocks/s0/attn/wq" in r["straddle"]
        assert "m/blocks/s0/mlp/wg" not in r["straddle"]


def _serve_agrees(r) -> bool:
    """A rank's sharded steps agree with one process's: every logit within
    SERVE_ATOL and the argmax equal on each step's decisive rows."""
    return max(r["gaps"]) <= SERVE_ATOL and all(r["agree"])


@pytest.mark.parametrize("arch, precision", SERVE_CASES)
def test_sharded_serve_steps_match_one_process(ranks, arch, precision):
    """The sharded W8A8 prefill and serve steps against one process:
    logits within SERVE_ATOL (row-parallel sums of bf16 partials), the
    argmax equal on the rows whose top-2 gap exceeds DECISIVE_GAP (3 and
    4 of the 16 rows dense, 6 SSM), and each rank launching kernels 1 and
    3 as one process does (an attention layer 4 and 7, with kernel 6 once
    a decode step under `PrecisionConfig()` and never under FULL_FP8's
    QDQ branch; an SSM layer, run on each rank's batch rows, 2 and 2)."""
    layers = 2
    q, g = (4, 7) if arch == "dense" else (2, 2)
    for r in ranks.collect(f"serve-{arch}-{precision}"):
        assert _serve_agrees(r), r
        assert sum(r["decisive"]) > 0, r["decisive"]
        for i, calls in enumerate(r["calls"]):
            assert calls["quant_act"]["calls"] == q * layers
            assert calls["fp8_gemm"]["calls"] == g * layers
            want = layers if arch == "dense" and precision == "default" and i else 0
            assert calls.get("decode", {"calls": 0})["calls"] == want


@pytest.mark.parametrize("fault", SERVE_FAULTS)
def test_sharded_serve_check_catches_planted_faults(ranks, fault):
    """The check above fails on the dense steps with a fault planted in
    the sharded W8A8 linear: the row-parallel sum over the TP group
    dropped, or each weight's scale blocks taken one block off.  The
    logit gap alone exceeds SERVE_ATOL."""
    for r in ranks.collect(f"serve-fault-{fault}"):
        assert max(r["gaps"]) > SERVE_ATOL, r["gaps"]
        assert not _serve_agrees(r)


def test_nested_batch_rows_flatten_rank_by_rank(ranks):
    """Rows that two mesh dims shard (the multi-pod batch) are flattened
    for a 2-D GEMM and unflattened again rank by rank (DTensor cannot
    unflatten them itself): the products and x's gradient equal the
    plain ones, with w replicated and with w column-sharded."""
    x, w = _nested_inputs()["x"], _nested_inputs()["w"]
    y = x @ w
    for r in ranks.collect("nested_rows"):
        for name in ("replicated", "column"):
            np.testing.assert_allclose(r[name]["y"], y, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r[name]["grad"], 2 * y @ w.T, rtol=1e-5, atol=1e-5)
