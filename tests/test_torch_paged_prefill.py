"""Kernel 5 (`fp8_paged_prefill_attention`) and chunked prefill of the port
vs the JAX reference.

* The plain version vs the Pallas kernel (interpret mode) and vs
  `ref.fp8_paged_prefill_attention_ref` on identical fp8/bf16 pools, with
  ragged chunks (start = lengths - {1, C, 3}, context % BS in {0, 1,
  BS-1}, rows past `lengths` included).  Both dequantize like `_deq`, so
  the plain version differs from Pallas only by the softmax order (flash
  vs full): atol/rtol 1e-2 on bf16 outputs; the ref skips `_deq`'s bf16
  rounding: 2e-2, the reference's own band.
* The stale-table proof: entries at or past each slot's live blocks point
  at a row filled with 448 (the e4m3 max); the output stays bit-equal.
* Rows at or past `lengths` are exact zeros.
* `attention_prefill_chunk` (one layer) and `Transformer.prefill_chunk`
  (the model, last-position and all-position logits) vs the reference's
  `prefill_chunk`, over three consecutive chunks of a ragged batch, with
  the kernel path and the gather path.  Tolerances are the model tests'
  (test_torch_model.py): attention outputs within 2 bf16 ulps of their
  scale (`_deq` vs `dequantize_per_tensor` and sum order), logits within
  0.08 with bf16 linears and 0.4 under W8A8; argmax equal wherever the
  reference's top-2 gap exceeds twice the tolerance.  Run with `-s` to
  print the measured gaps.
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
from repro.kernels import fp8_kv_attention as jattn  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn_mod  # noqa: E402
from repro.models import init_cache, init_params, prefill_chunk  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.kernels import fp8_kv_attention as tattn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models import attention as tattn_mod  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

NBLK = 16
POISON = NBLK - 1          # pool row only stale table entries point at
C = 5


def _t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _prefill_case(seed, b, kvh, g, d, bs, w, rem, fp8=True):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((NBLK, bs, kvh, d)).astype(np.float32)
    v = rng.standard_normal((NBLK, bs, kvh, d)).astype(np.float32)
    if fp8:
        ks, vs = np.float32(np.abs(k).max() / 448), np.float32(np.abs(v).max() / 448)
        kq = jnp.clip(jnp.asarray(k) / ks, -448, 448).astype(jnp.float8_e4m3fn)
        vq = jnp.clip(jnp.asarray(v) / vs, -448, 448).astype(jnp.float8_e4m3fn)
    else:
        ks = vs = np.float32(1.0)
        kq, vq = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((b, C, kvh, g, d)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    tbl = rng.integers(0, POISON, (b, w)).astype(np.int32)
    # context % BS == rem; ragged chunks: one valid row, a full chunk, and
    # three valid rows (the other two past `lengths`)
    lengths = np.clip(np.array([1, 3, 5])[:b] * bs + rem, 1, w * bs).astype(np.int32)
    start = np.maximum(lengths - np.array([1, C, 3])[:b], 0).astype(np.int32)
    jin = (q, kq, vq, jnp.float32(ks), jnp.float32(vs), jnp.asarray(tbl),
           jnp.asarray(start), jnp.asarray(lengths))
    tin = (_t(q), _t(kq), _t(vq), torch.tensor(ks), torch.tensor(vs),
           torch.from_numpy(tbl), torch.from_numpy(start), torch.from_numpy(lengths))
    return jin, tin


# every BS, D and G value of the sweep, each paired with both of the others
GEOMS = [(3, 2, g, d, bs, 6) for bs, d, g in
         ((4, 16, 2), (4, 32, 4), (8, 16, 4), (8, 32, 2), (8, 32, 3))]


@pytest.mark.parametrize("fp8", [True, False], ids=["fp8", "bf16"])
@pytest.mark.parametrize("rem_of_bs", ["0", "1", "bs-1"])
@pytest.mark.parametrize("b,kvh,g,d,bs,w", GEOMS)
def test_paged_prefill_plain_version_matches_pallas_and_ref(b, kvh, g, d, bs, w,
                                                            rem_of_bs, fp8):
    rem = {"0": 0, "1": 1, "bs-1": bs - 1}[rem_of_bs]
    jin, tin = _prefill_case(bs * 100 + d + g + rem, b, kvh, g, d, bs, w, rem, fp8)
    out_t = _f32(tattn.fp8_paged_prefill_attention_ref(*tin))
    out_k = _f32(jattn.fp8_paged_prefill_attention(*jin, interpret=True))
    out_r = _f32(jref.fp8_paged_prefill_attention_ref(*jin))
    np.testing.assert_allclose(out_t, out_k, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out_t, out_r, rtol=2e-2, atol=2e-2)
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(_f32(tops.fp8_paged_prefill_attention(*tin)), out_t)


@pytest.mark.parametrize("rem_of_bs", ["0", "1", "bs-1"])
@pytest.mark.parametrize("bs", [4, 8])
def test_paged_prefill_never_reads_stale_table_entries(bs, rem_of_bs):
    """Entries at or past ceil(min(start + C, len) / BS) point at a row
    filled with 448 (the e4m3 max): one read would move the output, so
    bit-equal outputs prove the plain version, like the kernel, never
    dereferences them."""
    rem = {"0": 0, "1": 1, "bs-1": bs - 1}[rem_of_bs]
    _, tin = _prefill_case(bs + rem, 3, 2, 4, 32, bs, 6, rem)
    q, kq, vq, ks, vs, tbl, start, lengths = tin
    ctx = torch.minimum(start + C, lengths)
    live = tattn.live_block_counts(ctx, bs, tbl.shape[1])
    stale = tbl.clone()
    for i in range(tbl.shape[0]):
        stale[i, live[i]:] = POISON
    kp, vp = kq.clone(), vq.clone()
    kp[POISON] = torch.full(kq[POISON].shape, 448.0).to(kq.dtype)
    vp[POISON] = torch.full(vq[POISON].shape, 448.0).to(vq.dtype)
    clean = tattn.fp8_paged_prefill_attention_ref(q, kq, vq, ks, vs, stale, start, lengths)
    poisoned = tattn.fp8_paged_prefill_attention_ref(q, kp, vp, ks, vs, stale, start, lengths)
    assert torch.equal(poisoned.view(torch.int16), clean.view(torch.int16))


def test_paged_prefill_rows_past_lengths_are_exact_zeros():
    """Row c of slot i is dead when start + c >= lengths: exact zeros in
    the plain version and in the Pallas kernel (a slot of length 0 is
    all dead)."""
    jin, tin = _prefill_case(3, 3, 2, 4, 16, 4, 6, 1)
    lengths = np.array([0, 9, 14], np.int32)
    start = np.array([0, 7, 12], np.int32)
    jin = jin[:6] + (jnp.asarray(start), jnp.asarray(lengths))
    tin = tin[:6] + (torch.from_numpy(start), torch.from_numpy(lengths))
    out_t = _f32(tattn.fp8_paged_prefill_attention_ref(*tin))
    out_k = _f32(jattn.fp8_paged_prefill_attention(*jin, interpret=True))
    dead = (start[:, None] + np.arange(C)[None, :]) >= lengths[:, None]
    assert dead.sum() == C + 3 + 3
    assert (out_t[dead] == 0).all() and (out_k[dead] == 0).all()
    assert (np.abs(out_t[~dead]).max(axis=(-3, -2, -1)) > 0).all()
    np.testing.assert_allclose(out_t, out_k, rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# the model: one attention layer and the whole chunk trace
# ---------------------------------------------------------------------------

ATOL_BF16, ATOL_W8A8 = 0.08, 0.4
PRECISIONS = {
    "bf16": (jp.BF16_ROLLOUT, tp.BF16_ROLLOUT, ATOL_BF16),
    "fp8_kv": (jp.FP8_KV_ONLY_ROLLOUT, tp.FP8_KV_ONLY_ROLLOUT, ATOL_BF16),
    "default": (jp.PrecisionConfig(), tp.PrecisionConfig(), ATOL_W8A8),
}
# a ragged batch of prompts streamed in chunks of 4: (tokens, chunk lengths)
PROMPT_LENS = np.array([11, 6, 9])
CHUNK = 4


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.tiny_serving_config()
    params = init_params(cfg, jax.random.key(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _prompts():
    rng = np.random.default_rng(3)
    toks = rng.integers(4, 19, (3, 12)).astype(np.int32)
    toks[:, 0] = 1
    for i, n in enumerate(PROMPT_LENS):
        toks[i, n:] = 0
    return toks


def _chunks():
    """(start, chunk tokens (B, C), valid rows per slot) of each chunk."""
    toks = _prompts()
    for start in range(0, int(PROMPT_LENS.max()), CHUNK):
        n = np.clip(PROMPT_LENS - start, 0, CHUNK).astype(np.int32)
        yield np.full(3, start, np.int32), toks[:, start:start + CHUNK], n


def _after_first(jprec, tprec, first):
    """The engine's rule: only the first chunk calibrates the KV scales."""
    if first or not jprec.kv_quantized:
        return jprec, tprec
    return (jprec.replace(calculate_kv_scales=False),
            tprec.replace(calculate_kv_scales=False))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "gather"])
@pytest.mark.parametrize("name", ["bf16", "fp8_kv"])
def test_attention_prefill_chunk_matches_reference(setup, name, use_kernel):
    cfg, params, np_params = setup
    jprec, tprec, _ = PRECISIONS[name]
    layer = jax.tree.map(lambda a: a[0], params["blocks"]["s0"]["attn"])
    tlayer = params_from_numpy(jax.tree.map(np.asarray, layer), "cpu")
    bs, n_blocks = 4, 12
    jcache = jattn_mod.init_paged_kv_cache(n_blocks, bs, cfg.n_kv_heads, cfg.d_head, jprec)
    tcache = tattn_mod.init_paged_kv_cache(n_blocks, bs, cfg.n_kv_heads, cfg.d_head,
                                           tprec, repeats=1, device="cpu").layer(0)
    tables = np.arange(12, dtype=np.int32).reshape(3, 4)
    rng = np.random.default_rng(7)
    gap = 0.0
    for i, (start, _, n) in enumerate(_chunks()):
        jpr, tpr = _after_first(jprec, tprec, i == 0)
        x = rng.standard_normal((3, CHUNK, cfg.d_model)).astype(np.float32)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        lengths = start + n
        hj, jcache = jattn_mod.attention_prefill_chunk(
            xj, layer, cfg, jcache, jpr, start=jnp.asarray(start),
            lengths=jnp.asarray(lengths), block_tables=jnp.asarray(tables),
            use_kernel=use_kernel)
        live = tattn_mod._live_blocks(np.minimum(start + CHUNK, lengths), 4, bs)
        ht = tattn_mod.attention_prefill_chunk(
            _t(xj), tlayer, tconfigs.tiny_serving_config(), tcache, tpr,
            start=torch.from_numpy(start), lengths=torch.from_numpy(lengths),
            block_tables=torch.from_numpy(tables), live_blocks=live,
            use_kernel=use_kernel)
        hj, ht = _f32(hj), _f32(ht)
        valid = np.arange(CHUNK)[None, :] < n[:, None]      # rows read later
        ulp = 2.0 ** (np.floor(np.log2(np.abs(hj[valid]).max())) - 7)
        np.testing.assert_allclose(ht[valid], hj[valid], rtol=0, atol=2 * ulp)
        gap = max(gap, float(np.abs(ht[valid] - hj[valid]).max() / ulp))
        np.testing.assert_allclose(_f32(tcache.k_scale), _f32(jcache.k_scale), rtol=2 ** -7)
    print(f"attention_prefill_chunk {name} {'kernel' if use_kernel else 'gather'}: "
          f"max gap {gap:.2f} bf16 ulps")


def _check_logits(j, t, atol, where):
    j = np.asarray(j, np.float32).reshape(-1, j.shape[-1])
    t = t.numpy().reshape(-1, t.shape[-1])
    assert t.shape == j.shape and np.isfinite(t).all(), where
    np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=where)
    for row_j, row_t in zip(j, t):
        top2 = np.sort(row_j)[::-1][:2]
        if top2[0] - top2[1] > 2 * atol:
            assert row_t.argmax() == row_j.argmax(), where
    return float(np.abs(t - j).max())


@pytest.mark.parametrize("all_logits", [False, True], ids=["last", "all"])
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "gather"])
@pytest.mark.parametrize("name", ["bf16", "default"])
def test_prefill_chunk_logits_match_reference(setup, name, use_kernel, all_logits):
    cfg, params, np_params = setup
    jprec, tprec, atol = PRECISIONS[name]
    jroll, _ = jsync(params, jprec)
    troll, _ = tsync(params_from_numpy(np_params, "cpu"), tprec)
    model = Transformer(tconfigs.tiny_serving_config(), "cpu")
    jcache = init_cache(cfg, 3, 16, jprec, page_size=4)
    tcache = model.init_cache(3, 16, tprec, page_size=4)
    gap = 0.0
    for i, (start, toks, n) in enumerate(_chunks()):
        jpr, tpr = _after_first(jprec, tprec, i == 0)
        jl, jcache = prefill_chunk(jroll, jnp.asarray(toks), jnp.asarray(start),
                                   jnp.asarray(n), jcache, cfg, jpr,
                                   use_kernel=use_kernel, want_all_logits=all_logits)
        tl, tcache = model.prefill_chunk(troll, torch.from_numpy(toks), start, n,
                                         tcache, tpr, use_kernel=use_kernel,
                                         want_all_logits=all_logits)
        if all_logits:    # rows past a slot's valid tokens are never read
            keep = np.arange(CHUNK)[None, :] < n[:, None]
            jl, tl = np.asarray(jl)[keep], tl[torch.from_numpy(keep)]
        else:
            keep = n > 0
            jl, tl = np.asarray(jl)[keep], tl[torch.from_numpy(keep)]
        gap = max(gap, _check_logits(jl, tl, atol, f"chunk {i}"))
        np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                      np.asarray(jcache["lengths"]))
    print(f"prefill_chunk {name} {'kernel' if use_kernel else 'gather'} "
          f"{'all' if all_logits else 'last'}: max |logit gap| {gap:.4f} (tol {atol})")
