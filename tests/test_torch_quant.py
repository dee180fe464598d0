"""Port quantizers vs the JAX reference: payload bits and scales equal.

The reference runs compiled (jit, scan bodies, Pallas), where XLA folds
`amax / fp8_max` into `amax * f32(1/fp8_max)`; its functions are compared
here in that compiled form, which is the one the model path runs.

The port's plain quantizers (`repro_torch.core.quant`, the plain versions
of kernels 1 and 2 in `repro_torch.kernels.fp8_quant`, and the
`repro_torch.kernels.ops` wrappers on CPU tensors) are held bit for bit
against `repro.core.quant`, `repro.kernels.ref` and the Pallas kernels
(interpret mode on the CPU, as `repro.kernels.ops` selects) over the
E4M3/E5M2 x FP32/UE8M0 sweep, shapes that are not multiples of 128, and
an overflow case.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.core.precision import E4M3 as J_E4M3, E5M2 as J_E5M2  # noqa: E402
from repro.core.precision import ScaleFormat as JFmt  # noqa: E402
from repro.kernels import fp8_quant as jquant_kernels  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core.precision import E4M3, E5M2, ScaleFormat  # noqa: E402
from repro_torch.kernels import fp8_quant as tquant  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

FP8 = {"e4m3": (J_E4M3, E4M3), "e5m2": (J_E5M2, E5M2)}
FMT = {"fp32": (JFmt.FP32, ScaleFormat.FP32), "ue8m0": (JFmt.UE8M0, ScaleFormat.UE8M0)}


def _jit(fn, *args, **static):
    """Run a reference function compiled, with `static` bound."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _bits(x):
    """fp8 payload (JAX array or torch tensor) -> uint8 numpy."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _inputs(seed, shape, mag, dtype="f32"):
    x = (np.random.default_rng(seed).standard_normal(shape) * mag).astype(np.float32)
    jx = jnp.asarray(x)
    if dtype == "bf16":
        jx = jx.astype(jnp.bfloat16)
    return jx, tensor_from_numpy(np.asarray(jx), "cpu")


def _assert_same(jqt, tqt):
    np.testing.assert_array_equal(_bits(tqt[0]), _bits(jqt[0]))
    np.testing.assert_array_equal(tqt[1].numpy(), np.asarray(jqt[1]))


SWEEP = [(fp8, fmt, mag) for fp8 in FP8 for fmt in FMT for mag in (0.01, 3.0, 100.0)]


@pytest.mark.parametrize("fp8,fmt,mag", SWEEP)
def test_core_quantize_activation_bit_equal(fp8, fmt, mag):
    jx, tx = _inputs(1, (6, 5, 200), mag)          # K=200: padded last tile
    j = _jit(jq.quantize_activation, jx, fp8_dtype=FP8[fp8][0],
             scale_format=FMT[fmt][0])
    t = tq.quantize_activation(tx, FP8[fp8][1], FMT[fmt][1])
    _assert_same((j.data, j.scales), (t.data, t.scales))
    assert t.block == tuple(j.block)


@pytest.mark.parametrize("fp8,fmt,mag", SWEEP)
def test_core_quantize_weight_bit_equal(fp8, fmt, mag):
    jx, tx = _inputs(2, (3, 200, 136), mag, "bf16")   # stacked, ragged blocks
    j = _jit(jq.quantize_weight, jx, fp8_dtype=FP8[fp8][0],
             scale_format=FMT[fmt][0])
    t = tq.quantize_weight(tx, FP8[fp8][1], FMT[fmt][1])
    _assert_same((j.data, j.scales), (t.data, t.scales))
    np.testing.assert_array_equal(
        tq.dequantize(t, torch.float32).numpy(),
        np.asarray(jq.dequantize(j, jnp.float32)))


@pytest.mark.parametrize("fp8,fmt,mag", SWEEP)
def test_act_kernel_plain_version_matches_pallas_and_ref(fp8, fmt, mag):
    jx, tx = _inputs(3, (24, 256), mag, "bf16")
    jk = jquant_kernels.quantize_activation_kernel(
        jx, fp8_dtype=FP8[fp8][0], scale_format=FMT[fmt][0], bm=8,
        interpret=True)
    jr = _jit(jref.quantize_activation_ref, jx, fp8_dtype=FP8[fp8][0],
              scale_format=FMT[fmt][0])
    t = tquant.quantize_activation_ref(tx, FP8[fp8][1], FMT[fmt][1])
    _assert_same(jk, t)
    _assert_same(jr, t)


@pytest.mark.parametrize("fp8,fmt,mag", SWEEP)
def test_weight_kernel_plain_version_matches_pallas_and_ref(fp8, fmt, mag):
    jx, tx = _inputs(4, (256, 384), mag, "bf16")
    jk = jquant_kernels.quantize_weight_kernel(
        jx, fp8_dtype=FP8[fp8][0], scale_format=FMT[fmt][0], interpret=True)
    jr = _jit(jref.quantize_weight_ref, jx, fp8_dtype=FP8[fp8][0],
              scale_format=FMT[fmt][0])
    t = tquant.quantize_weight_ref(tx, FP8[fp8][1], FMT[fmt][1])
    _assert_same(jk, t)
    _assert_same(jr, t)


@pytest.mark.parametrize("shape", [(3, 5, 200), (9, 64), (1, 384)])
def test_ops_quantize_activation_matches_reference_ops(shape):
    """The wrapper pads K to 128 and flattens leading dims like
    `repro.kernels.ops.quantize_activation` (Pallas interpret)."""
    jx, tx = _inputs(5, shape, 2.0, "bf16")
    j = jops.quantize_activation(jx)
    t = tops.quantize_activation(tx)
    assert t.data.shape == tuple(shape) and t.scales.shape == j.scales.shape
    _assert_same((j.data, j.scales), (t.data, t.scales))


@pytest.mark.parametrize("shape", [(200, 130), (64, 128), (256, 256)])
def test_ops_quantize_weight_matches_reference_ops(shape):
    jx, tx = _inputs(6, shape, 0.1, "bf16")
    j = jops.quantize_weight(jx)
    t = tops.quantize_weight(tx)
    _assert_same((j.data, j.scales), (t.data, t.scales))


def test_ops_quantize_weight_stacked_equals_per_slice():
    """One stacked (L, K, N) call equals L two-dimensional calls."""
    _, tx = _inputs(7, (3, 200, 136), 0.5, "bf16")
    st = tops.quantize_weight(tx)
    for r in range(3):
        one = tops.quantize_weight(tx[r])
        np.testing.assert_array_equal(_bits(st.data[r]), _bits(one.data))
        np.testing.assert_array_equal(st.scales[r].numpy(), one.scales.numpy())


@pytest.mark.parametrize("fp8", list(FP8))
def test_per_tensor_overflow_saturates_like_clipped_reference(fp8):
    """Values past the fp8 max saturate (clip-then-cast) in both; without
    the clip JAX would give NaN and torch would saturate."""
    jx, tx = _inputs(8, (64, 32), 50.0)
    scale = np.float32(0.01)             # forces |x / scale| far past the max
    j = jq.quantize_per_tensor(jx, jnp.float32(scale), FP8[fp8][0])
    t = tq.quantize_per_tensor(tx, torch.tensor(scale), FP8[fp8][1])
    np.testing.assert_array_equal(_bits(t), _bits(j))
    assert not np.isnan(t.float().numpy()).any()
    np.testing.assert_array_equal(
        tq.dequantize_per_tensor(t, torch.tensor(scale)).float().numpy(),
        np.asarray(jq.dequantize_per_tensor(j, jnp.float32(scale)), np.float32))


@pytest.mark.parametrize("margin", [1.0, 1.05])
@pytest.mark.parametrize("fmt", list(FMT))
def test_calibrate_scale_bit_equal(margin, fmt):
    amax = np.random.default_rng(9).uniform(1e-6, 1e3, 64).astype(np.float32)
    j = jax.jit(jax.vmap(
        lambda a: jq.calibrate_scale(a, J_E4M3, FMT[fmt][0], margin)))(
        jnp.asarray(amax))
    t = tq.calibrate_scale(torch.from_numpy(amax), E4M3, FMT[fmt][1], margin)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
