"""Kernel 3's weight layout: K-major storage made once, at weight sync.

`ops.quantize_weight` runs kernel 2 (its plain version here) and then
copies the payload once into (..., N_pad, K_pad) contiguous storage;
`QuantizedTensor.data` is that storage's (..., K, N) transposed view, so
the values, the scales and every comparison with the reference are
unchanged.  `ops.fp8_matmul` hands kernel 3 the padded (K_pad, N_pad)
view of that storage with no copy.  Here, on the CPU:

* the storage is K-major and zero-padded, and `layer(r)` keeps it;
* payload and scales are bit-equal to the reference's jitted
  `quantize_weight` at stacked and padded shapes;
* `fp8_matmul` on the K-major weight is bit-equal to the same call on a
  row-major copy, and within one bf16 rounding (rtol 2**-7, the kernel
  tests' `BF16_ULP`) of the Pallas `fp8_gemm` in interpret mode;
* the GEMM receives the sync's storage itself (pointer, shape, strides);
* `sync_policy_weights` on `tiny_serving_config()` makes K-major leaves
  whose bits equal the reference's.
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
from repro.core import quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.transformer import init_params  # noqa: E402
from repro.rl import sync_policy_weights as jsync  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.rl import sync_policy_weights as tsync  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

BF16_ULP = 2.0 ** -7   # relative spacing of bf16 near 1
SCALE_FORMATS = {"fp32": (jp.ScaleFormat.FP32, tp.ScaleFormat.FP32),
                 "ue8m0": (jp.ScaleFormat.UE8M0, tp.ScaleFormat.UE8M0)}


def _pad(d):
    return -(-d // 128) * 128


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).contiguous().numpy()
    return np.asarray(x).view(np.uint8)


def _bf16(rng, shape, mag):
    x = (rng.standard_normal(shape) * mag).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16)


def _assert_k_major(data, k, n):
    """`data` is the (K, N) view of zero-padded (N_pad, K_pad) storage."""
    kp, np_ = _pad(k), _pad(n)
    assert tuple(data.shape[-2:]) == (k, n)
    assert data.stride()[-2:] == (1, kp)
    full = data.as_strided((np_, kp), (kp, 1))       # the storage, row by row
    raw = full.view(torch.uint8)
    assert not raw[n:].any() and not raw[:, k:].any(), "padding must be zeros"


@pytest.mark.parametrize("shape", [(3, 200, 136), (200, 130), (256, 384), (2, 128, 128)])
def test_quantize_weight_stores_k_major_and_layer_keeps_it(shape):
    w = tensor_from_numpy(np.asarray(_bf16(np.random.default_rng(1), shape, 0.3)), "cpu")
    qt = tops.quantize_weight(w)
    *lead, k, n = shape
    kp, np_ = _pad(k), _pad(n)
    assert qt.data.shape == shape and qt.data.dtype == torch.float8_e4m3fn
    assert qt.data.untyped_storage().nbytes() == int(np.prod(lead, dtype=int)) * kp * np_
    if not lead:
        _assert_k_major(qt.data, k, n)
        return
    for r in range(lead[0]):
        lr = qt.layer(r)
        assert isinstance(lr, QuantizedTensor) and lr.block == (128, 128)
        assert lr.data.storage_offset() == r * kp * np_
        _assert_k_major(lr.data, k, n)
        assert torch.equal(lr.scales, qt.scales[r])


@pytest.mark.parametrize("fmt", list(SCALE_FORMATS))
@pytest.mark.parametrize("shape", [(3, 200, 136), (200, 130), (2, 256, 384)])
def test_k_major_payload_bit_equal_to_reference(shape, fmt):
    """Payload and scales equal the jitted reference's `quantize_weight`."""
    jfmt, tfmt = SCALE_FORMATS[fmt]
    jw = _bf16(np.random.default_rng(2), shape, 0.5)
    j = jax.jit(lambda x: jq.quantize_weight(x, scale_format=jfmt))(jw)
    t = tops.quantize_weight(tensor_from_numpy(np.asarray(jw), "cpu"), scale_format=tfmt)
    np.testing.assert_array_equal(_bits(t.data), _bits(j.data))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))


@pytest.mark.parametrize("xshape,n", [((9, 200), 130), ((2, 3, 128), 256), ((1, 64), 64),
                                      ((40, 384), 256)])
def test_fp8_matmul_k_major_equals_row_major_and_pallas(xshape, n):
    rng = np.random.default_rng(sum(xshape) + n)
    x = _bf16(rng, xshape, 1.0)
    w = _bf16(rng, (xshape[-1], n), xshape[-1] ** -0.5)
    x_q = tops.quantize_activation(tensor_from_numpy(np.asarray(x), "cpu"))
    w_q = tops.quantize_weight(tensor_from_numpy(np.asarray(w), "cpu"))
    row_major = QuantizedTensor(w_q.data.contiguous(), w_q.scales, w_q.block)
    assert row_major.data.stride() == (n, 1)
    y = tops.fp8_matmul(x_q, w_q)
    y_rm = tops.fp8_matmul(x_q, row_major)
    assert torch.equal(y.view(torch.int16), y_rm.view(torch.int16))
    y_j = np.asarray(jops.fp8_matmul(jops.quantize_activation(x), jops.quantize_weight(w)),
                     np.float32)
    np.testing.assert_allclose(y.float().numpy(), y_j, rtol=BF16_ULP,
                               atol=1e-6 * np.abs(y_j).max())


@pytest.mark.parametrize("layers", [0, 2])
def test_fp8_matmul_hands_the_gemm_the_sync_storage(monkeypatch, layers):
    """At a padded shape, (9, 200) x (200, 130), and for a layer of a
    stack, the GEMM gets the padded K-major view of the sync's storage:
    its pointer, (K_pad, N_pad), strides (1, K_pad); no copy."""
    rng = np.random.default_rng(5)
    shape = (layers, 200, 130) if layers else (200, 130)
    w_q = tops.quantize_weight(tensor_from_numpy(np.asarray(_bf16(rng, shape, 0.1)), "cpu"))
    w_q = w_q.layer(layers - 1) if layers else w_q
    x_q = tops.quantize_activation(tensor_from_numpy(np.asarray(_bf16(rng, (9, 200), 1.0)),
                                                     "cpu"))
    seen = []
    plain = tops._gemm.fp8_gemm_ref

    def spy(a, w, a_s, w_s, out_dtype):
        seen.append(w)
        return plain(a, w, a_s, w_s, out_dtype)
    monkeypatch.setattr(tops._gemm, "fp8_gemm_ref", spy)
    y = tops.fp8_matmul(x_q, w_q)
    (w,) = seen
    assert tuple(y.shape) == (9, 130)
    assert w.data_ptr() == w_q.data.data_ptr()
    assert tuple(w.shape) == (256, 256) and w.stride() == (1, 256)


def test_sync_policy_weights_k_major_and_bit_equal():
    cfg = jconfigs.tiny_serving_config()
    params = init_params(cfg, jax.random.key(0))
    jroll, _ = jsync(params, jp.PrecisionConfig())
    troll, _ = tsync(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                     tp.PrecisionConfig())

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for key, v in tree.items():
                yield from leaves(v, f"{path}/{key}")
        else:
            yield path, tree
    tleaves = dict(leaves(troll))
    n_quant = 0
    for path, jleaf in leaves(jroll):
        tleaf = tleaves[path]
        if not isinstance(tleaf, QuantizedTensor):
            continue
        n_quant += 1
        *_, k, n = tleaf.data.shape
        for r in range(tleaf.data.shape[0]):
            _assert_k_major(tleaf.layer(r).data, k, n)
        np.testing.assert_array_equal(_bits(tleaf.data), _bits(jleaf.data), err_msg=path)
        np.testing.assert_array_equal(tleaf.scales.numpy(), np.asarray(jleaf.scales),
                                      err_msg=path)
    assert n_quant == 7
