"""Port kernels' plain versions vs the JAX oracles and Pallas kernels.

* fp8_gemm (kernel 3): `repro_torch.kernels.fp8_gemm.fp8_gemm_ref` and the
  `ops.fp8_matmul` wrapper vs `repro.kernels.ref.fp8_gemm_ref` and the
  Pallas `fp8_gemm` (interpret mode), on identical fp8 inputs.  Both sum
  exact fp8 products in f32 per 128-wide slab, only in another order, so
  they agree to within one bf16 rounding of the output: rtol 2**-7.
* paged decode (kernel 4): the plain version vs the Pallas kernel
  (interpret) — both dequantize like `_deq`, so they differ only by
  flash-vs-full softmax order (atol/rtol 1e-2 on bf16 outputs) — and vs
  `ref.fp8_paged_decode_attention_ref`, which skips the bf16 rounding of
  the dequantized K/V (the reference's own 2e-2 band).  Geometries: BS 4
  and 8, D 16 and 32, G 2-4, context % BS in {0, 1, BS-1}, fp8 and bf16.
* The stale-table proofs: entries at or past a slot's live blocks may
  point anywhere; filling those rows with NaN changes no output bit.
* The CUDA launch functions refuse CPU tensors (only `ops` routes CPU
  tensors, explicitly, to the plain versions).  The card's own tests
  (each kernel against its plain version at these small geometries, and a
  wrapper without its library raising) are in `test_torch_cuda.py`,
  which imports no JAX so that it runs on the card's machine.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import fp8_gemm as jgemm  # noqa: E402
from repro.kernels import fp8_kv_attention as jattn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import fp8_gemm as tgemm  # noqa: E402
from repro_torch.kernels import fp8_kv_attention as tattn  # noqa: E402
from repro_torch.kernels import fp8_quant as tfq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

BF16_ULP = 2.0 ** -7   # relative spacing of bf16 near 1


def _t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# fp8_gemm
# ---------------------------------------------------------------------------

def _quantized_operands(seed, m, k, n, mag=1.0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray((rng.standard_normal((m, k)) * mag).astype(np.float32))
    w = jnp.asarray((rng.standard_normal((k, n)) * mag).astype(np.float32))
    xq, xs = jax.jit(jref.quantize_activation_ref)(x)
    wq, ws = jax.jit(jref.quantize_weight_ref)(w)
    return (xq, wq, xs, ws), tuple(_t(a) for a in (xq, wq, xs, ws))


@pytest.mark.parametrize("m,k,n,mag", [(256, 256, 256, 1.0), (128, 384, 256, 5.0),
                                       (256, 128, 512, 0.05)])
def test_gemm_plain_version_matches_ref_and_pallas(m, k, n, mag):
    jin, tin = _quantized_operands(m + k + n, m, k, n, mag)
    y_t = _f32(tgemm.fp8_gemm_ref(*tin))
    y_r = _f32(jref.fp8_gemm_ref(*jin))
    y_k = _f32(jgemm.fp8_gemm(*jin, bm=128, bn=128, interpret=True))
    scale = np.abs(y_r).max()
    for y in (y_r, y_k):
        np.testing.assert_allclose(y_t, y, rtol=BF16_ULP, atol=1e-6 * scale)


@pytest.mark.parametrize("xshape,n", [((9, 200), 130), ((2, 3, 128), 256), ((1, 64), 64)])
def test_ops_fp8_matmul_pads_like_reference(xshape, n):
    """The wrapper pads K and N to 128 and slices back, as
    `repro.kernels.ops.fp8_matmul` does (Pallas interpret)."""
    rng = np.random.default_rng(sum(xshape) + n)
    x = jnp.asarray(rng.standard_normal(xshape).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((xshape[-1], n)).astype(np.float32)
                    * xshape[-1] ** -0.5).astype(jnp.bfloat16)
    y_j = _f32(jops.fp8_matmul(jops.quantize_activation(x), jops.quantize_weight(w)))
    y_t = tops.fp8_matmul(tops.quantize_activation(_t(x)), tops.quantize_weight(_t(w)))
    assert tuple(y_t.shape) == xshape[:-1] + (n,) and y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(y_t), y_j, rtol=BF16_ULP,
                               atol=1e-6 * np.abs(y_j).max())


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

NBLK = 16
POISON = NBLK - 1          # pool row only stale table entries point at


def _decode_case(seed, b, kvh, g, d, bs, w, rem, fp8=True):
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
    q = jnp.asarray(rng.standard_normal((b, kvh, g, d)).astype(np.float32)).astype(jnp.bfloat16)
    tbl = rng.integers(0, POISON, (b, w)).astype(np.int32)
    lengths = np.clip(np.arange(1, b + 1) * 2 * bs + rem, 1, w * bs).astype(np.int32)
    jin = (q, kq, vq, jnp.float32(ks), jnp.float32(vs), jnp.asarray(tbl),
           jnp.asarray(lengths))
    tin = (_t(q), _t(kq), _t(vq), torch.tensor(ks), torch.tensor(vs),
           torch.from_numpy(tbl), torch.from_numpy(lengths))
    return jin, tin


# every BS, D and G value of the sweep, each paired with both of the others
GEOMS = [(3, 2, g, d, bs, 6) for bs, d, g in
         ((4, 16, 2), (4, 32, 4), (8, 16, 4), (8, 32, 2), (8, 32, 3))]


@pytest.mark.parametrize("fp8", [True, False], ids=["fp8", "bf16"])
@pytest.mark.parametrize("rem_of_bs", ["0", "1", "bs-1"])
@pytest.mark.parametrize("b,kvh,g,d,bs,w", GEOMS)
def test_paged_decode_plain_version_matches_pallas_and_ref(b, kvh, g, d, bs, w,
                                                           rem_of_bs, fp8):
    rem = {"0": 0, "1": 1, "bs-1": bs - 1}[rem_of_bs]
    jin, tin = _decode_case(bs * 100 + d + g, b, kvh, g, d, bs, w, rem, fp8)
    out_t = _f32(tattn.fp8_paged_decode_attention_ref(*tin))
    out_k = _f32(jattn.fp8_paged_decode_attention(*jin, interpret=True))
    out_r = _f32(jref.fp8_paged_decode_attention_ref(*jin))
    np.testing.assert_allclose(out_t, out_k, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out_t, out_r, rtol=2e-2, atol=2e-2)
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(_f32(tops.fp8_paged_decode_attention(*tin)), out_t)


def test_paged_decode_idle_slot_is_exact_zero():
    """len 0: the kernel (and its plain version) give exact zeros, as the
    Pallas kernel does (the jnp oracle would give NaN)."""
    jin, tin = _decode_case(5, 3, 2, 4, 32, 8, 6, 0)
    lengths = np.array([0, 9, 0], np.int32)
    jin = jin[:6] + (jnp.asarray(lengths),)
    tin = tin[:6] + (torch.from_numpy(lengths),)
    out_t = _f32(tattn.fp8_paged_decode_attention_ref(*tin))
    out_k = _f32(jattn.fp8_paged_decode_attention(*jin, interpret=True))
    assert (out_t[0] == 0).all() and (out_t[2] == 0).all()
    np.testing.assert_array_equal(out_k[0], out_t[0])
    np.testing.assert_allclose(out_t, out_k, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("rem_of_bs", ["0", "1", "bs-1"])
@pytest.mark.parametrize("bs", [4, 8])
def test_paged_decode_never_reads_stale_table_entries(bs, rem_of_bs):
    """Entries at or past ceil(len / BS) point at a NaN-filled row: one read
    would turn the output NaN (0 * NaN), so bit-equal outputs prove that
    the plain version, like the kernel, never dereferences them."""
    rem = {"0": 0, "1": 1, "bs-1": bs - 1}[rem_of_bs]
    _, tin = _decode_case(bs + rem, 3, 2, 4, 32, bs, 6, rem)
    q, kq, vq, ks, vs, tbl, lengths = tin
    stale = tbl.clone()
    live = tattn.live_block_counts(lengths, bs, tbl.shape[1])
    for i in range(tbl.shape[0]):
        stale[i, live[i]:] = POISON
    nan = torch.full(kq[POISON].shape, float("nan")).to(kq.dtype)
    kp, vp = kq.clone(), vq.clone()
    kp[POISON], vp[POISON] = nan, nan
    clean = tattn.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, stale, lengths)
    poisoned = tattn.fp8_paged_decode_attention_ref(q, kp, vp, ks, vs, stale, lengths)
    assert not torch.isnan(poisoned.float()).any()
    assert torch.equal(poisoned.view(torch.int16), clean.view(torch.int16))


# ---------------------------------------------------------------------------
# dispatch: no silent fallback
# ---------------------------------------------------------------------------

def test_kernel_launchers_reject_cpu_tensors():
    """The CUDA launch functions never run on the CPU: only `ops` routes CPU
    tensors, explicitly, to the plain versions.  A meta tensor (the dry
    run's) takes the meta route: empty outputs of the kernel's shapes, no
    launch and no plain version; any other device raises."""
    from repro_torch.kernels import build
    _, tin = _quantized_operands(1, 128, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tgemm.fp8_gemm(*tin)
    before = dict(build.LAUNCHES)
    qt = tops.quantize_activation(torch.zeros((4, 200), device="meta"))
    assert qt.data.is_meta and qt.data.shape == (4, 200) and qt.data.dtype == torch.float8_e4m3fn
    assert qt.scales.shape == (4, 2) and dict(build.LAUNCHES) == before

    class _Elsewhere:
        is_cuda, is_meta = False, False
        device = torch.device("xla")
    with pytest.raises(ValueError, match="device"):
        tops._route(_Elsewhere(), tfq.quantize_activation_kernel,
                    tfq.quantize_activation_ref)
