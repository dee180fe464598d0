"""Kernel 6 (`fp8_decode_attention`, contiguous cache) of the port vs the
JAX reference.

* The port's `ops.fp8_decode_attention` on CPU tensors (the plain version
  in the reference's S tiles, padded as the reference pads) vs the
  reference's `ops.fp8_decode_attention`, which runs the Pallas kernel in
  interpret mode: both dequantize in f32 with no bf16 rounding and walk
  the same tiles, so they differ by sum order only: atol/rtol 1e-2 on
  bf16 outputs.  Vs the jnp oracle `ref.fp8_decode_attention_ref` (a
  full -inf softmax): 2e-2, the reference's own band
  (tests/test_kernels.py).  G in {1, 2, 4, 8}, D in {32, 64, 128}, S a
  tile multiple (256, 1024: one and two 512-tiles) and not (200: the
  wrapper pads to 256), an E4M3 cache and a bf16 cache with scale 1,
  lengths 1, S and one between.
* Port only: a row of length 0 gives exact zeros (the reference's oracle
  gives NaN there); 448 and NaN poison past each row's length leave the
  output bit-equal; the wrapper picks the reference wrapper's tile.
Run with `-s` to print the measured gaps.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

from unittest import mock  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import fp8_kv_attention as tattn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

B, KVH = 3, 2


def _t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _decode_case(seed, g, d, s, fp8=True, lengths=None):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, s, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, s, KVH, d)).astype(np.float32)
    if fp8:
        ks, vs = np.float32(np.abs(k).max() / 448), np.float32(np.abs(v).max() / 448)
        kq = jnp.clip(jnp.asarray(k) / ks, -448, 448).astype(jnp.float8_e4m3fn)
        vq = jnp.clip(jnp.asarray(v) / vs, -448, 448).astype(jnp.float8_e4m3fn)
    else:
        ks = vs = np.float32(1.0)
        kq, vq = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((B, KVH, g, d)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    if lengths is None:
        lengths = np.array([1, s, int(rng.integers(2, s))], np.int32)
    lengths = np.asarray(lengths, np.int32)
    jin = (q, kq, vq, jnp.float32(ks), jnp.float32(vs), jnp.asarray(lengths))
    tin = (_t(q), _t(kq), _t(vq), torch.tensor(ks), torch.tensor(vs),
           torch.from_numpy(lengths))
    return jin, tin


# every G and D value, each paired with more than one of the other
GD = [(1, 32), (2, 64), (4, 128), (8, 32), (8, 128), (4, 64)]


@pytest.mark.parametrize("fp8", [True, False], ids=["e4m3", "bf16"])
@pytest.mark.parametrize("s", [256, 1024, 200])
@pytest.mark.parametrize("g,d", GD)
def test_decode_plain_version_matches_pallas_and_ref(g, d, s, fp8):
    jin, tin = _decode_case(g * 1000 + d + s, g, d, s, fp8)
    out_t = _f32(tops.fp8_decode_attention(*tin))
    out_k = _f32(jops.fp8_decode_attention(*jin))       # Pallas, interpret mode
    out_r = _f32(jref.fp8_decode_attention_ref(*jin))
    np.testing.assert_allclose(out_t, out_k, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out_t, out_r, rtol=2e-2, atol=2e-2)
    print(f"decode G={g} D={d} S={s} {'e4m3' if fp8 else 'bf16'}: "
          f"max |port - pallas| {np.abs(out_t - out_k).max():.2e}, "
          f"|port - ref| {np.abs(out_t - out_r).max():.2e}")


@pytest.mark.parametrize("s", [200, 1024])
def test_decode_row_of_length_zero_is_exact_zeros(s):
    """An idle row (length 0) attends to nothing: exact zeros, where the
    reference's -inf oracle gives NaN; the other rows are untouched."""
    jin, tin = _decode_case(s, 4, 32, s, lengths=[0, s, 17])
    out = tops.fp8_decode_attention(*tin)
    assert bool((out[0] == 0).all())
    assert bool(torch.isnan(torch.from_numpy(_f32(jref.fp8_decode_attention_ref(*jin))[0])).all())
    np.testing.assert_allclose(_f32(out[1:]), _f32(jops.fp8_decode_attention(*jin))[1:],
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("poison", [448.0, float("nan")], ids=["448", "nan"])
@pytest.mark.parametrize("fp8", [True, False], ids=["e4m3", "bf16"])
def test_decode_never_reads_past_lengths(fp8, poison):
    """Every K/V position at or past a row's length is overwritten with
    `poison`: one read would move the output (NaN would spread), so
    bit-equal outputs prove those positions never reach it."""
    s = 300
    lengths = np.array([1, 129, 257], np.int32)
    _, tin = _decode_case(7, 4, 64, s, fp8, lengths=lengths)
    q, kq, vq, ks, vs, ln = tin
    dead = torch.arange(s)[None, :] >= ln[:, None].long()
    kp, vp = kq.clone(), vq.clone()
    fill = torch.full(kq[dead].shape, poison).to(kq.dtype)
    kp[dead], vp[dead] = fill, fill
    clean = tops.fp8_decode_attention(q, kq, vq, ks, vs, ln)
    poisoned = tops.fp8_decode_attention(q, kp, vp, ks, vs, ln)
    assert torch.equal(poisoned.view(torch.int16), clean.view(torch.int16))
    plain = tattn.fp8_decode_attention_ref(q, kp, vp, ks, vs, ln)      # one tile
    assert torch.equal(plain.isnan(), torch.zeros_like(plain, dtype=torch.bool))


@pytest.mark.parametrize("s", [1, 13, 100, 128, 200, 256, 300, 512, 640, 1024, 1057, 4096])
def test_decode_wrapper_picks_the_reference_tile(s):
    """The port's wrapper hands its plain version the tile and the padded
    S that the reference's wrapper hands its Pallas kernel."""
    seen = {}

    def spy_j(q, k, v, ks, vs, lengths, *, bs, interpret):
        seen["ref"] = (bs, k.shape[1])
        return jnp.zeros(q.shape, q.dtype)

    def spy_t(q, k, v, ks, vs, lengths, *, bs):
        seen["port"] = (bs, k.shape[1])
        return torch.zeros_like(q)

    jin, tin = _decode_case(s, 1, 32, s, lengths=[1, s, s])
    with mock.patch.object(jops._attn, "fp8_decode_attention", spy_j):
        jops.fp8_decode_attention(*jin)
    with mock.patch.object(tops._attn, "fp8_decode_attention_ref", spy_t):
        tops.fp8_decode_attention(*tin)
    # the Pallas call clamps its tile to S (`bs = min(bs, s_len)`), the
    # port's wrapper does that itself
    assert seen["port"] == (min(seen["ref"][0], seen["ref"][1]), seen["ref"][1])


def test_decode_splits_come_from_the_shape():
    """Kernel 6's split count and span depend on S and the SM count only;
    the spans cover S, none is empty, and a span exceeds SPLIT_KEYS only
    when there is one split per SM."""
    for s in (1, 13, 1057, 16385, 32768, 524288, 524289):
        for sms in (1, 8, 132):
            n, span = tattn.decode_splits(s, sms)
            assert 1 <= n <= sms and (n - 1) * span < s <= n * span
            assert span <= tattn.SPLIT_KEYS or n == sms
    assert tattn.decode_splits(524288, 132) == (132, 3972)
    assert tattn.decode_splits(32768, 132) == (32, 1024)
    assert tattn.decode_splits(1057, 132) == (2, 529)


def test_decode_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only: a CPU tensor passed to it
    directly raises instead of running anything."""
    _, tin = _decode_case(1, 4, 32, 64, lengths=[1, 64, 5])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.fp8_decode_attention(*tin)
