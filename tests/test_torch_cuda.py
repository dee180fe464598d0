"""The port's CUDA kernels on the card, at the CPU tests' small geometries.

This file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips (the `cuda` fixture decides).
`chip_smoke.py` holds the kernels to their plain versions at the main
paths' full-width shapes; these tests cover what it does not: padding in
the `ops` wrappers (K and N not multiples of 128, ragged leading dims),
E5M2 and UE8M0 quantizers, paged decode and chunked prefill at block
sizes 4/8/16/40 (key tiles of 64 positions gathered across pool blocks),
head widths 16-256 and group sizes 2-4 with ragged tails, chunks of 5 and
40 rows (several row blocks, the causal early exit), NaN-poisoned stale
table entries and dead chunk rows, a chunk row equal bit for bit to a
decode step at the same context (up to the engine's geometry, and G 3
and 16, and at the fleet's block size 4), head widths not a multiple of
16 and misaligned q refused with a ValueError, kernels 4 and 5 at the
fleet engines' geometry (E4M3 and bf16 pools, table rows in random and in
pool order), the serving engine's speculative and preempted greedy runs
equal to plain ones on the card, a two-replica fleet whose greedy
completions after a crash (permanent or transient) and under the step
tracer equal the fault-free fleet's, the GRPO fork on the card, and a
wrapper without its library.  Kernel 6 (contiguous
decode): G 1-16, D 16-256 (80 included), S 13/200/1057/1300 with ragged
tails, lengths on and next to the key-tile and split boundaries of a
cache whose S is a multiple of neither, fp8 and bf16 caches at q and
q x 4 (within 1e-2 and 1e-2 x max|plain|), NaN poison past each length,
idle rows, a layer view of a stacked cache, split counts > 1 against one
split and bit-equal repeats, the inputs it refuses, and a serve step
past the cache that raises on the host.  `_dot` on the card: one bf16
GEMM with f32 sums, no widened operand.  Tolerances are those of the CPU
tests: quantizers bit-equal, GEMM within one bf16 rounding (rtol 2**-7),
attention within 1e-2.  Kernel 3: every qwen3-8b (K, N) at M 1-1024
against its plain version, rows bit-equal across M and batches, a
row-major weight refused, and the sync's K-major storage handed to the
launch without a copy at a padded shape.  Kernel 1: bit-equal at the
paths' rows (M 1-16384) and odd tile counts, with f32 input, E5M2 and
UE8M0; kernel 1 then kernel 3 on one rewritten buffer 200 times, bit-equal
to the synchronized pair; a CUDA graph of kernel 1 and three kernel 3
calls replays bit-equal to eager.  The trainer: `_dot`'s backward within
one bf16 rounding of the f32 products, one reduced-size update on the
card against the same update on the CPU, and the optimizer's temporaries
held to one chunk of a stacked leaf.  Full FP8 and the dense registry:
`fp8_dot` forward and backward on the card against the CPU (its
quantized operands bit-equal), kernels 4, 5 and 6 at the (KVH, G, D) of
stablelm-3b (G 1, D 80), llama3.2-3b (G 3) and starcoder2-15b (G 12), a
FULL_FP8_ROLLOUT decode step that launches no kernel 4 (and, asked for
the kernel, equals the `PrecisionConfig()` step), and a dropped engine
that returns its device memory with the collector off.  MoE: the
expert-batched kernel 3 bit-equal per expert to the 2-D kernel and within
one bf16 rounding of its plain version (E 4-8, odd M, a layer view of the
sync's storage, no copy), `_dot`'s batched GEMM and its backward, the
stable top-k on planted ties, a reduced granite-moe decode step and chunk
on the card against the CPU (with the launches per MoE layer), and the
FP8 router's sync at N 40.  SSM and hybrid: kernel 3 at mamba2's w_in
width (N 6448, stored at 6528) through `ops.fp8_matmul` within one bf16
rounding of plain, a reduced mamba2 and a reduced jamba period's prefill,
decode steps and chunk on the card against the CPU (logits within 0.5,
SSM states within 1e-2), and the engine's SSM write-back around a
piggybacked decode and its swap-in under a budget cut, both bit-equal.
Enc-dec and VLM: kernels 4-6 at seamless's (G 1, D 64), a reduced
seamless decode step (cross attention over the cross caches) and a
reduced pixtral prefill over its patch prefix on the card against the
CPU (with the launches of each), and the enc-dec engine's preempted run
(cross KV swapped out and back) equal to its roomy run bit for bit.
The distributed runtime: kernel 1 on one long (1, n) f32 row (the
compressed gradient sum's) and an odd n padded to 128, bit-equal to
plain; `constrain` returns a plain CUDA tensor itself; `_dot` of DTensors
on a 1-rank cuda mesh through the registered `mm.dtype` strategy, equal
to the plain tensors' with its gradients.
"""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use
torch.set_num_threads(1)

from repro_torch.configs import ShapeConfig, tiny_serving_config  # noqa: E402
from repro_torch.core import fp8_linear  # noqa: E402
from repro_torch.core.precision import (  # noqa: E402
    E4M3,
    E5M2,
    PrecisionConfig,
    ScaleFormat,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fp8_kv_attention as fa  # noqa: E402
from repro_torch.kernels import fp8_quant as fq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.rl import SamplerConfig, generate, sync_policy_weights  # noqa: E402
from repro_torch.serving import ServingEngine, SpecConfig, kv_bytes_per_token  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.uint8)


@pytest.mark.parametrize("fmt", [ScaleFormat.FP32, ScaleFormat.UE8M0])
@pytest.mark.parametrize("fp8", [E4M3, E5M2])
def test_quantizers_bit_equal_on_card(cuda, fp8, fmt):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn((3, 5, 200), generator=gen, device=cuda) * 7).to(torch.bfloat16)
    w = (torch.randn((2, 200, 136), generator=gen, device=cuda) * 0.1).to(torch.bfloat16)
    xk = ops.quantize_activation(x, fp8, fmt)
    wk = ops.quantize_weight(w, fp8, fmt)
    xp = fq.quantize_activation_ref(ops._pad_to(x.reshape(-1, 200), (1, 128)), fp8, fmt)
    wp = fq.quantize_weight_ref(ops._pad_to(w, (128, 128)), fp8, fmt)
    torch.cuda.synchronize()
    assert torch.equal(_bits(xk.data), _bits(xp[0][:, :200].reshape(3, 5, 200)))
    assert torch.equal(xk.scales, xp[1].reshape(3, 5, 2))
    assert torch.equal(_bits(wk.data), _bits(wp[0][..., :200, :136]))
    assert torch.equal(wk.scales, wp[1])


@pytest.mark.parametrize("xshape,n", [((9, 200), 130), ((2, 3, 128), 256), ((1, 64), 64)])
def test_fp8_matmul_wrapper_on_card(cuda, xshape, n):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(xshape, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((xshape[-1], n), generator=gen, device=cuda)
         * xshape[-1] ** -0.5).to(torch.bfloat16)
    x_q, w_q = ops.quantize_activation(x), ops.quantize_weight(w)
    y = ops.fp8_matmul(x_q, w_q)
    # the plain version on the same CUDA tensors
    a = ops._pad_to(x_q.data.reshape(-1, xshape[-1]), (1, 128)).contiguous()
    yp = ops._gemm.fp8_gemm_ref(a, ops._pad_to(w_q.data, (128, 128)),
                                x_q.scales.reshape(a.shape[0], -1), w_q.scales)
    yp = yp[:, :n].reshape(xshape[:-1] + (n,))
    torch.cuda.synchronize()
    assert y.shape == yp.shape and y.dtype == torch.bfloat16
    assert torch.allclose(y.float(), yp.float(), rtol=2 ** -7,
                          atol=1e-5 * yp.float().abs().max().item())


# kernel 1 at the paths' rows (decode 1-8, spec verify 40, chunk 129,
# prefill 1024 and 16384) at K 4096, wd's input at K 12288, and odd tile
# counts (a bf16 warp holds two 1x128 tiles; the last may be alone)
@pytest.mark.parametrize("m,k", [(1, 4096), (3, 4096), (8, 4096), (40, 4096), (129, 4096),
                                 (1024, 4096), (16384, 4096), (8, 12288), (1, 128),
                                 (3, 384)])
def test_quant_act_kernel_bit_equal_on_card(cuda, m, k):
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + k)
    x = (torch.randn((m, k), generator=gen, device=cuda) * 3).to(torch.bfloat16)
    x[0, :128] = 0                        # an all-zero tile: the 1e-12 floor
    qk, sk = fq.quantize_activation_kernel(x)
    qp, sp = fq.quantize_activation_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(_bits(qk), _bits(qp))
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))


@pytest.mark.parametrize("dtype,fp8,fmt", [(torch.float32, E4M3, ScaleFormat.FP32),
                                           (torch.bfloat16, E5M2, ScaleFormat.FP32),
                                           (torch.bfloat16, E4M3, ScaleFormat.UE8M0)])
def test_quant_act_kernel_formats_on_card(cuda, dtype, fp8, fmt):
    """f32 input (4 values a lane, one tile a warp), E5M2, UE8M0 scales."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn((129, 4096), generator=gen, device=cuda) * 50).to(dtype)
    qk, sk = fq.quantize_activation_kernel(x, fp8, fmt)
    qp, sp = fq.quantize_activation_ref(x, fp8, fmt)
    torch.cuda.synchronize()
    assert torch.equal(_bits(qk), _bits(qp))
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))


def test_quant_act_misaligned_input_on_card(cuda):
    """Kernel 1 loads 16-byte vectors: the kernel wrapper refuses an x
    that is not 16-byte aligned, and `ops.quantize_activation` copies one
    first (the same bits as the plain version)."""
    base = torch.randn((8 * 256 + 1,), device=cuda).to(torch.bfloat16)
    x = base[1:].view(8, 256)
    assert x.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fq.quantize_activation_kernel(x)
    xq = ops.quantize_activation(x)
    qp, sp = fq.quantize_activation_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(_bits(xq.data), _bits(qp)) and torch.equal(xq.scales, sp)


def test_quant_then_gemm_race_on_card(cuda):
    """Kernel 1 rewrites one activation buffer from new data each
    iteration and kernel 3 consumes it at once (its programmatic
    dependent: the GEMM's prologue streams W before it waits for kernel
    1): 200 iterations, each output bit-equal to the same pair with a
    synchronize between the two.  The caching allocator hands kernel 1 the
    buffers just freed, so every iteration writes the same ones."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    m, k, n = 8, 4096, 1024
    xs = torch.randn((200, m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w_q = ops.quantize_weight((torch.randn((k, n), generator=gen, device=cuda)
                               * k ** -0.5).to(torch.bfloat16))
    torch.cuda.synchronize()
    outs, buffers = [], set()
    for x in xs:
        q, s = fq.quantize_activation_kernel(x)
        buffers.add((q.data_ptr(), s.data_ptr()))
        outs.append(ops._gemm.fp8_gemm(q, w_q.data, s, w_q.scales))
        del q, s
    torch.cuda.synchronize()
    assert len(buffers) == 1, f"kernel 1 wrote {len(buffers)} different buffers"
    for i, x in enumerate(xs):
        q, s = fq.quantize_activation_kernel(x)
        torch.cuda.synchronize()
        ref = ops._gemm.fp8_gemm(q, w_q.data, s, w_q.scales)
        torch.cuda.synchronize()
        assert torch.equal(outs[i].view(torch.int16), ref.view(torch.int16)), i


def test_graph_replay_of_quant_and_gemms_on_card(cuda):
    """A `torch.cuda.CUDAGraph` of kernel 1 and three kernel 3 calls on its
    output (q, k, v at qwen3-8b's widths) replays bit-equal to eager, on
    the captured input and on new data copied into it."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((8, 4096), generator=gen, device=cuda).to(torch.bfloat16)
    ws = [ops.quantize_weight((torch.randn((4096, n), generator=gen, device=cuda)
                               * 4096 ** -0.5).to(torch.bfloat16)) for n in (4096, 1024, 1024)]

    def step():
        a, a_s = fq.quantize_activation_kernel(x)
        return [ops._gemm.fp8_gemm(a, w.data, a_s, w.scales) for w in ws]
    eager = [y.clone() for y in step()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    graph.replay()
    torch.cuda.synchronize()
    for y, e in zip(outs, eager):
        assert torch.equal(y.view(torch.int16), e.view(torch.int16))
    x.copy_(torch.randn((8, 4096), generator=gen, device=cuda).to(torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    for y, e in zip(outs, step()):
        assert torch.equal(y.view(torch.int16), e.view(torch.int16))


# kernel 3 at the four (K, N) of qwen3-8b's linears and the M the paths
# run (LONG_500K 1, decode 8, GRPO decode 32, spec verify up to 40, the
# engine's chunk 128, prefill 1024; 9 is one past a decode)
QWEN3_GEMMS = [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)]


def _gemm_operands(dev, k, n, m, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    a, a_s = fq.quantize_activation_kernel(x)
    return a, a_s, ops.quantize_weight(w)


@pytest.mark.parametrize("m", [1, 8, 9, 32, 40, 128, 1024])
@pytest.mark.parametrize("k,n", QWEN3_GEMMS)
def test_gemm_kernel_at_qwen3_shapes_on_card(cuda, k, n, m):
    a, a_s, w_q = _gemm_operands(cuda, k, n, m, k + n + m)
    y = ops._gemm.fp8_gemm(a, w_q.data, a_s, w_q.scales)
    yp = ops._gemm.fp8_gemm_ref(a, w_q.data, a_s, w_q.scales).float()
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    assert torch.allclose(y.float(), yp, rtol=2 ** -7, atol=1e-5 * yp.abs().max().item())


@pytest.mark.parametrize("k,n", QWEN3_GEMMS)
def test_gemm_rows_independent_of_m_on_card(cuda, k, n):
    """A row's bits never depend on M or on which rows share the call: the
    rows of an M-1024 call equal the same rows computed at M 1, 8, 40 and
    128, and inside a permuted batch."""
    a, a_s, w_q = _gemm_operands(cuda, k, n, 1024, k * n)
    gemm = ops._gemm.fp8_gemm
    full = gemm(a, w_q.data, a_s, w_q.scales).view(torch.int16)
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    for rows in ([0], [1023], list(range(8)), list(range(500, 540)),
                 list(range(896, 1024)), torch.randperm(1024, generator=gen, device=cuda)):
        rows = torch.as_tensor(rows, device=cuda)
        part = gemm(a[rows].contiguous(), w_q.data, a_s[rows].contiguous(), w_q.scales)
        assert torch.equal(part.view(torch.int16), full[rows]), len(rows)


def test_gemm_refuses_a_row_major_weight(cuda):
    a, a_s, w_q = _gemm_operands(cuda, 256, 128, 8, 3)
    with pytest.raises(ValueError, match="K-major"):
        ops._gemm.fp8_gemm(a, w_q.data.contiguous(), a_s, w_q.scales)


def test_fp8_matmul_hands_the_kernel_the_sync_storage(cuda, monkeypatch):
    """At a padded shape, (9, 200) x (200, 130), the launch gets the
    weight's own storage pointer: no per-call copy."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((9, 200), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((200, 130), generator=gen, device=cuda) * 0.07).to(torch.bfloat16)
    x_q, w_q = ops.quantize_activation(x), ops.quantize_weight(w)
    seen = []
    launch = build.launch

    def spy(kernel, entry, device, *args):
        if kernel == "fp8_gemm":
            seen.append(args[1])
        return launch(kernel, entry, device, *args)
    monkeypatch.setattr(build, "launch", spy)
    y = ops.fp8_matmul(x_q, w_q)
    torch.cuda.synchronize()
    assert seen == [w_q.data.data_ptr()] and y.shape == (9, 130)


@pytest.mark.parametrize("kv", ["fp8", "bf16"])
@pytest.mark.parametrize("rem_of_bs", ["0", "1", "bs-1"])
@pytest.mark.parametrize("bs,d,g", [(4, 16, 2), (4, 32, 4), (8, 16, 4), (8, 32, 3)])
def test_paged_decode_on_card(cuda, bs, d, g, rem_of_bs, kv):
    gen = torch.Generator(device=cuda).manual_seed(bs * 100 + d + g)
    rem = {"0": 0, "1": 1, "bs-1": bs - 1}[rem_of_bs]
    b, kvh, w = 3, 2, 6
    lengths = torch.tensor([2 * bs + rem, 4 * bs + rem, 0], dtype=torch.int32,
                           device=cuda).clamp(max=w * bs)
    q, kq, vq, ks, vs, tables, lengths, poison = _decode_case(
        cuda, gen, b, kvh, g, d, bs, w, lengths)
    if kv == "bf16":
        kq, vq = kq.float().to(torch.bfloat16), vq.float().to(torch.bfloat16)
        ks, vs = torch.ones_like(ks), torch.ones_like(vs)
    out = fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths)
    plain = fa.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lengths)
    kn, vn = kq.clone(), vq.clone()
    kn[poison] = float("nan")
    vn[poison] = float("nan")
    poisoned = fa.fp8_paged_decode_attention(q, kn, vn, ks, vs, tables, lengths)
    torch.cuda.synchronize()
    assert torch.allclose(out.float(), plain.float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(poisoned.view(torch.int16), out.view(torch.int16))
    assert bool((out[2] == 0).all())          # the idle slot


def _decode_case(dev, gen, b, kvh, g, d, bs, w, lengths):
    nrows = b * w + 1
    k = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    v = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    ks, vs = k.abs().amax() / 448, v.abs().amax() / 448
    kq, vq = (k / ks).clamp(-448, 448).to(E4M3), (v / vs).clamp(-448, 448).to(E4M3)
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    tables = torch.randperm(nrows - 1, generator=gen, device=dev)[: b * w].reshape(b, w)
    live = ((lengths.long() + bs - 1) // bs).clamp(1, w)
    dead = torch.arange(w, device=dev)[None, :] >= live[:, None]
    tables = torch.where(dead, nrows - 1, tables).to(torch.int32)
    return q, kq, vq, ks.float(), vs.float(), tables, lengths, nrows - 1


def _prefill_case(dev, gen, kvh, g, d, bs, w, start, lengths, c):
    b = len(start)
    nrows = b * w + 1
    k = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    v = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    ks, vs = k.abs().amax() / 448, v.abs().amax() / 448
    kq, vq = (k / ks).clamp(-448, 448).to(E4M3), (v / vs).clamp(-448, 448).to(E4M3)
    q = torch.randn((b, c, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    start = torch.tensor(start, dtype=torch.int32, device=dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev).clamp(max=w * bs)
    tables = torch.randperm(nrows - 1, generator=gen, device=dev)[: b * w].reshape(b, w)
    ctx = torch.minimum(start + c, lengths).long()
    live = ((ctx + bs - 1) // bs).clamp(1, w)
    dead = torch.arange(w, device=dev)[None, :] >= live[:, None]
    tables = torch.where(dead, nrows - 1, tables).to(torch.int32)
    return q, kq, vq, ks.float(), vs.float(), tables, start, lengths, nrows - 1


@pytest.mark.parametrize("kv", ["fp8", "bf16"])
@pytest.mark.parametrize("rem_of_bs", ["0", "1", "bs-1"])
@pytest.mark.parametrize("bs,d,g,c", [(4, 16, 2, 5), (8, 32, 4, 5), (16, 32, 3, 5), (40, 16, 4, 5),
                                      (16, 64, 4, 40), (16, 128, 3, 40), (8, 256, 4, 40)])
def test_paged_prefill_on_card(cuda, bs, d, g, c, rem_of_bs, kv):
    """C 40 spans several 32-row blocks; slot 1's early row blocks stop
    at fewer key tiles than its last (the causal early exit)."""
    gen = torch.Generator(device=cuda).manual_seed(bs * 100 + d + g)
    rem = {"0": 0, "1": 1, "bs-1": bs - 1}[rem_of_bs]
    kvh, w = 2, 6
    lengths = [2 * bs + rem, 4 * bs + rem, 0]
    start = [max(lengths[0] - 1, 0), max(lengths[1] - c, 0), 0]
    q, kq, vq, ks, vs, tables, st, ln, poison = _prefill_case(
        cuda, gen, kvh, g, d, bs, w, start, lengths, c)
    if kv == "bf16":
        kq, vq = kq.float().to(torch.bfloat16), vq.float().to(torch.bfloat16)
        ks, vs = torch.ones_like(ks), torch.ones_like(vs)
    out = fa.fp8_paged_prefill_attention(q, kq, vq, ks, vs, tables, st, ln)
    plain = fa.fp8_paged_prefill_attention_ref(q, kq, vq, ks, vs, tables, st, ln)
    kn, vn = kq.clone(), vq.clone()
    kn[poison] = float("nan")
    vn[poison] = float("nan")
    poisoned = fa.fp8_paged_prefill_attention(q, kn, vn, ks, vs, tables, st, ln)
    torch.cuda.synchronize()
    assert torch.allclose(out.float(), plain.float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(poisoned.view(torch.int16), out.view(torch.int16))
    dead = (st[:, None] + torch.arange(c, device=cuda)[None, :]) >= ln[:, None]
    assert bool((out[dead] == 0).all()) and bool(dead[2].all())


@pytest.mark.parametrize("bs,c,kvh,g,d,start,w", [
    pytest.param(4, 7, 2, 4, 32, 10, 6, id="4"),
    pytest.param(16, 7, 2, 4, 32, 46, 6, id="16"),
    pytest.param(40, 7, 2, 4, 32, 118, 6, id="40"),
    # the engine's geometry; start is not a multiple of the 64-key tile
    pytest.param(16, 128, 8, 4, 128, 100, 16, id="production"),
    # G 3 and G 16: a 16-row mma tile straddles positions, a position
    # straddles warps (G 3) or a tile holds one position (G 16)
    pytest.param(8, 40, 2, 3, 64, 37, 12, id="g3"),
    pytest.param(16, 24, 2, 16, 128, 70, 7, id="g16"),
    # the fleet's engines (block size 4): 8-token pages of an E4M3 pool,
    # 4-token pages of a bf16 one, at qwen3-8b's heads
    pytest.param(8, 40, 8, 4, 128, 21, 8, id="fleet-e4m3"),
    pytest.param(4, 40, 8, 4, 128, 21, 16, id="fleet-bf16"),
])
def test_chunk_row_equals_decode_step_on_card(cuda, bs, c, kvh, g, d, start, w):
    """Kernel 5's row at position T over keys [0, T] is bit-equal to
    kernel 4 at length T + 1: the two share their block body."""
    gen = torch.Generator(device=cuda).manual_seed(bs if c == 7 else bs * 1000 + c + g)
    q, kq, vq, ks, vs, tables, st, ln, _ = _prefill_case(
        cuda, gen, kvh, g, d, bs, w, [start], [start + c], c)
    out = fa.fp8_paged_prefill_attention(q, kq, vq, ks, vs, tables, st, ln)
    for ci in range(c):
        dec = fa.fp8_paged_decode_attention(
            q[:, ci].contiguous(), kq, vq, ks, vs, tables,
            torch.tensor([start + ci + 1], dtype=torch.int32, device=cuda))
        assert torch.equal(dec.view(torch.int16), out[:, ci].view(torch.int16)), ci


@pytest.mark.parametrize("order", ["perm", "seq"])
@pytest.mark.parametrize("kv", ["fp8", "bf16"])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_paged_kernels_at_fleet_block_size_on_card(cuda, kernel, kv, order):
    """Kernels 4 and 5 at the fleet engines' geometry (block size 4: pages
    of 8 tokens in an E4M3 pool, 4 in a bf16 one; 64 positions a slot;
    qwen3-8b's 8 KV heads of 128, G 4), table rows in random and in pool
    order: within 1e-2 of the plain versions, stale entries never read."""
    bs = 8 if kv == "fp8" else 4
    w = 64 // bs
    gen = torch.Generator(device=cuda).manual_seed(bs * 10 + (order == "seq"))
    kvh, g, d = 8, 4, 128
    if kernel == "decode":
        lengths = torch.tensor([5, 8, 9, 31, 44, 64, 1, 0], dtype=torch.int32, device=cuda)
        q, kq, vq, ks, vs, tables, ln, poison = _decode_case(
            cuda, gen, len(lengths), kvh, g, d, bs, w, lengths)
        st = None
    else:
        q, kq, vq, ks, vs, tables, st, ln, poison = _prefill_case(
            cuda, gen, kvh, g, d, bs, w, [0, 0, 8, 13], [5, 40, 21, 44], 32)
    if order == "seq":
        nrows = kq.shape[0]
        tables = torch.where(tables == poison, tables, torch.arange(
            tables.numel(), device=cuda).reshape(tables.shape).to(torch.int32))
        assert int(tables.max()) < nrows
    if kv == "bf16":
        kq, vq = kq.float().to(torch.bfloat16), vq.float().to(torch.bfloat16)
        ks, vs = torch.ones_like(ks), torch.ones_like(vs)
    args = (ln,) if st is None else (st, ln)
    run = fa.fp8_paged_decode_attention if st is None else fa.fp8_paged_prefill_attention
    plain = (fa.fp8_paged_decode_attention_ref if st is None
             else fa.fp8_paged_prefill_attention_ref)
    out = run(q, kq, vq, ks, vs, tables, *args)
    want = plain(q, kq, vq, ks, vs, tables, *args)
    kn, vn = kq.clone(), vq.clone()
    kn[poison] = float("nan")
    vn[poison] = float("nan")
    poisoned = run(q, kn, vn, ks, vs, tables, *args)
    torch.cuda.synchronize()
    assert torch.allclose(out.float(), want.float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(poisoned.view(torch.int16), out.view(torch.int16))


def test_paged_wrappers_reject_unsupported_inputs_on_card(cuda):
    """On a CUDA call kernels 4 and 5 raise ValueError for a head width
    that is not a multiple of 16, and for q not 16-byte aligned."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    lengths = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    q, kq, vq, ks, vs, tables, lengths, _ = _decode_case(cuda, gen, 2, 2, 4, 24, 4, 3, lengths)
    with pytest.raises(ValueError, match="D % 16"):
        fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths)
    with pytest.raises(ValueError, match="D % 16"):
        fa.fp8_paged_prefill_attention(q[:, None].contiguous(), kq, vq, ks, vs, tables,
                                       lengths - 1, lengths)
    q, kq, vq, ks, vs, tables, lengths, _ = _decode_case(cuda, gen, 2, 2, 4, 32, 4, 3, lengths)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fp8_paged_decode_attention(shifted, kq, vq, ks, vs, tables, lengths)


def _contiguous_case(dev, gen, b, kvh, g, d, s, lengths, fp8=True):
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev)
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev)
    if fp8:
        ks, vs = k.abs().amax() / 448, v.abs().amax() / 448
        kq, vq = (k / ks).clamp(-448, 448).to(E4M3), (v / vs).clamp(-448, 448).to(E4M3)
    else:
        ks = vs = torch.ones((), device=dev)
        kq, vq = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kq, vq, ks.float(), vs.float(), lengths


def _poison_past(kq, vq, lengths):
    """Copies with NaN bit patterns at every position at or past a row's
    length (e4m3fn NaN 0x7f, bf16 NaN 0x7fc0)."""
    dead = torch.arange(kq.shape[1], device=kq.device)[None, :] >= lengths[:, None].long()
    bits, nan = (torch.uint8, 0x7F) if kq.element_size() == 1 else (torch.int16, 0x7FC0)
    kn, vn = kq.clone(), vq.clone()
    kn.view(bits)[dead] = nan
    vn.view(bits)[dead] = nan
    assert bool(kn.float()[dead].isnan().all())
    return kn, vn


@pytest.mark.parametrize("kv", ["fp8", "bf16"])
@pytest.mark.parametrize("s", [13, 200, 1057])
@pytest.mark.parametrize("g,d", [(1, 32), (2, 16), (4, 64), (4, 128), (8, 128), (8, 32)])
def test_contiguous_decode_on_card(cuda, g, d, s, kv):
    gen = torch.Generator(device=cuda).manual_seed(g * 1000 + d + s)
    lengths = [1, s, 0, max(s // 2 - 1, 1)]
    q, kq, vq, ks, vs, ln = _contiguous_case(cuda, gen, 4, 2, g, d, s, lengths, kv == "fp8")
    out = fa.fp8_decode_attention(q, kq, vq, ks, vs, ln)
    plain = fa.fp8_decode_attention_ref(q, kq, vq, ks, vs, ln)
    kn, vn = _poison_past(kq, vq, ln)
    poisoned = fa.fp8_decode_attention(q, kn, vn, ks, vs, ln)
    torch.cuda.synchronize()
    assert torch.allclose(out.float(), plain.float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(poisoned.view(torch.int16), out.view(torch.int16))
    assert bool((out[2] == 0).all())          # the idle row


def _forced_splits(n):
    """`decode_splits` forced to `n` splits (the fewest equal spans that
    cover S), whatever the SM count."""
    def splits(s_max, sm_count):
        span = -(-s_max // n)
        return -(-s_max // span), span
    return splits


@pytest.mark.parametrize("n_split", [2, 3, 7, 64])
def test_contiguous_decode_split_counts_on_card(cuda, n_split, monkeypatch):
    """More splits change only the sum order: within 1e-2 of one split."""
    gen = torch.Generator(device=cuda).manual_seed(n_split)
    q, kq, vq, ks, vs, ln = _contiguous_case(cuda, gen, 3, 2, 4, 128, 1057,
                                             [1057, 300, 5])
    monkeypatch.setattr(fa, "decode_splits", _forced_splits(1))
    one = fa.fp8_decode_attention(q, kq, vq, ks, vs, ln)
    monkeypatch.setattr(fa, "decode_splits", _forced_splits(n_split))
    many = fa.fp8_decode_attention(q, kq, vq, ks, vs, ln)
    again = fa.fp8_decode_attention(q, kq, vq, ks, vs, ln)
    torch.cuda.synchronize()
    assert torch.allclose(many.float(), one.float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(many.view(torch.int16), again.view(torch.int16))


def test_contiguous_decode_layer_view_on_card(cuda):
    """A layer of the stacked (R, B, S, KVH, D) cache is a view at an
    offset; the kernel reads it in place, as a copy of it would read."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, kq, vq, ks, vs, ln = _contiguous_case(cuda, gen, 2, 2, 4, 64, 200, [200, 77])
    kst = torch.stack([torch.zeros_like(kq), kq, torch.zeros_like(kq)])
    vst = torch.stack([torch.zeros_like(vq), vq, torch.zeros_like(vq)])
    view = fa.fp8_decode_attention(q, kst[1], vst[1], ks, vs, ln)
    copy = fa.fp8_decode_attention(q, kq.clone(), vq.clone(), ks, vs, ln)
    torch.cuda.synchronize()
    assert torch.equal(view.view(torch.int16), copy.view(torch.int16))


def _hold_decode(q, kq, vq, ks, vs, ln):
    """Kernel 6 vs its plain version at q and q x 4, as `chip_smoke.py`
    holds it: within 1e-2 elementwise and within 1e-2 x max|plain|."""
    for q_scale in (1.0, 4.0):
        qs = (q.float() * q_scale).to(q.dtype)
        out = fa.fp8_decode_attention(qs, kq, vq, ks, vs, ln).float()
        plain = fa.fp8_decode_attention_ref(qs, kq, vq, ks, vs, ln).float()
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        assert torch.allclose(out, plain, rtol=1e-2, atol=1e-2), (q_scale, err)
        assert err <= 1e-2 * plain.abs().max().item(), (q_scale, err)


@pytest.mark.parametrize("kv", ["fp8", "bf16"])
@pytest.mark.parametrize("g,d", [(12, 128), (16, 128), (16, 64), (4, 80), (12, 80),
                                 (4, 256), (16, 256)])
def test_contiguous_decode_wide_groups_and_heads_on_card(cuda, g, d, kv):
    """G 12 and 16 (both halves of the 16 mma rows), D 80 (zero-padded
    to a 128 body) and 256, ragged lengths over several splits."""
    gen = torch.Generator(device=cuda).manual_seed(g * 1000 + d)
    s = 1300
    q, kq, vq, ks, vs, ln = _contiguous_case(cuda, gen, 3, 2, g, d, s, [s, 0, 517],
                                             kv == "fp8")
    _hold_decode(q, kq, vq, ks, vs, ln)
    kn, vn = _poison_past(kq, vq, ln)
    out = fa.fp8_decode_attention(q, kq, vq, ks, vs, ln)
    poisoned = fa.fp8_decode_attention(q, kn, vn, ks, vs, ln)
    torch.cuda.synchronize()
    assert torch.equal(poisoned.view(torch.int16), out.view(torch.int16))
    assert bool((out[1] == 0).all())          # the idle row


@pytest.mark.parametrize("kv", ["fp8", "bf16"])
def test_contiguous_decode_tile_and_split_boundaries_on_card(cuda, kv):
    """Lengths on and next to the key-tile and split boundaries, in a cache
    whose S is a multiple of neither: every last tile and last split is
    ragged or exactly full."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g, d = 4, 128
    tile = fa.decode_geometry(d, g, E4M3 if kv == "fp8" else torch.bfloat16)["tile_keys"]
    s = 4099
    n_split, span = fa.decode_splits(s, sms)
    assert n_split > 1 and s % tile and s % span
    lengths = sorted({n for base in (tile, 2 * tile, span, 2 * span, s)
                      for n in (base - 1, base, base + 1) if 1 <= n <= s})
    gen = torch.Generator(device=cuda).manual_seed(len(lengths))
    q, kq, vq, ks, vs, ln = _contiguous_case(cuda, gen, len(lengths), 2, g, d, s, lengths,
                                             kv == "fp8")
    _hold_decode(q, kq, vq, ks, vs, ln)
    kn, vn = _poison_past(kq, vq, ln)
    out = fa.fp8_decode_attention(q, kq, vq, ks, vs, ln)
    poisoned = fa.fp8_decode_attention(q, kn, vn, ks, vs, ln)
    torch.cuda.synchronize()
    assert torch.equal(poisoned.view(torch.int16), out.view(torch.int16))


def test_contiguous_decode_refuses_unsupported_inputs_on_card(cuda):
    """Kernel 6 raises ValueError for G > 16, D > 256, D % 16 != 0 and q
    not 16-byte aligned, and takes everything else."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    for g, d in ((17, 64), (4, 272), (4, 24)):
        q, kq, vq, ks, vs, ln = _contiguous_case(cuda, gen, 2, 2, g, d, 40, [40, 7])
        with pytest.raises(ValueError, match="kernel 6 takes"):
            fa.fp8_decode_attention(q, kq, vq, ks, vs, ln)
    q, kq, vq, ks, vs, ln = _contiguous_case(cuda, gen, 2, 2, 4, 32, 40, [40, 7])
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fp8_decode_attention(shifted, kq, vq, ks, vs, ln)


def test_dot_on_card_is_one_bf16_gemm(cuda):
    """`_dot` on CUDA: one GEMM of the bf16 operands with f32 sums, within
    one bf16 rounding of the f32 product, in x.dtype, and with no widened
    copy of an operand (a f32 w alone would take 4 bytes an element)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((16, 4096), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((4096, 8192), generator=gen, device=cuda).to(torch.bfloat16)
    ref = x.float() @ w.float()
    fp8_linear._dot(x, w)                     # warm: the GEMM library's workspace
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fp8_linear._dot(x, w)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert out.dtype == x.dtype and out.shape == ref.shape
    assert extra < w.numel() * 2, extra
    assert torch.allclose(out.float(), ref, rtol=2 ** -7, atol=1e-2)
    x3 = x.reshape(2, 8, 4096)
    assert torch.equal(fp8_linear._dot(x3, w).reshape(16, 8192), out)


def test_dot_backward_on_card(cuda):
    """`_dot`'s backward on the card: dx = g @ w^T and dw = x^T @ g, each
    within one bf16 rounding of the f32 products; the forward stays the
    one bf16 GEMM with f32 sums, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((24, 4096), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((4096, 2048), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((2, 12, 2048), generator=gen, device=cuda).to(torch.bfloat16)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = fp8_linear._dot(xr.reshape(2, 12, 4096), wr)
    assert torch.equal(out.reshape(24, 2048),
                       torch.mm(x, w, out_dtype=torch.float32).to(torch.bfloat16))
    out.backward(g)
    g2 = g.reshape(24, 2048).float()
    assert xr.grad.dtype == wr.grad.dtype == torch.bfloat16
    assert torch.allclose(xr.grad.float(), g2 @ w.float().t(), rtol=2 ** -7, atol=1e-2)
    assert torch.allclose(wr.grad.float(), x.float().t() @ g2, rtol=2 ** -7, atol=1e-2)


def _train_setup():
    from repro_torch.configs import get_config
    from repro_torch.data import tasks
    from repro_torch.models import token_logprobs
    from repro_torch.rl import rollout as ro
    cfg = get_config("qwen3-8b").reduced(vocab_size=tasks.VOCAB_SIZE, n_layers=2,
                                         d_model=128)
    params = Transformer(cfg, "cpu").init_params(0)
    gen = torch.Generator().manual_seed(8)
    b, p, g = 8, 8, 6
    lens = torch.randint(3, p + 1, (b,), generator=gen, dtype=torch.int32)
    rlen = torch.randint(1, g + 1, (b,), generator=gen, dtype=torch.int32)
    mask = (torch.arange(g)[None] < rlen[:, None]).float()
    traj = ro.Trajectory(torch.randint(4, 19, (b, p), generator=gen, dtype=torch.int32), lens,
                         torch.randint(2, 19, (b, g), generator=gen, dtype=torch.int32),
                         mask, torch.zeros((b, g)), rlen, None, None)
    packed = ro.packed_sequences(traj)
    lp = ro.gather_response_logps(token_logprobs(params, {"tokens": packed}, cfg)[0], traj)
    batch = {"packed_tokens": packed, "prompt_lengths": lens, "response_mask": mask,
             "mask": mask, "rollout_logps": (lp + 0.3 * torch.randn(lp.shape, generator=gen))
             * mask, "advantages": torch.randn((b // 4,), generator=gen).repeat_interleave(4)}
    return cfg, params, batch


def test_update_on_card_matches_cpu(cuda):
    """One reduced-size update (scoring, DAPO loss with TIS, backward, AdamW
    with fp8 moments) on the card against the same update on the CPU, at
    the CPU parity tests' tolerances (tests/test_torch_train.py)."""
    from repro_torch.core.fp8_params import tree_leaves
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.rl import trainer as tr
    cfg, params, batch = _train_setup()
    rl = tr.RLConfig(precision=PrecisionConfig(),
                     optimizer=AdamWConfig(lr=3e-4, b2=0.98, fp8_moments=True))
    runs = []
    for dev in ("cpu", cuda):
        t = tr.RLTrainer(cfg, rl, device=dev,
                         params=tr._fill(params, (p.to(dev, copy=True)
                                                  for p in tree_leaves(params))))
        b = {k: v.to(dev) for k, v in batch.items()}
        _, _, grads = t.loss_and_grads(t.params, b)
        new, _, stats = t.update_fn(t.params, t.opt_state, b)
        runs.append((grads, new, tr.stats_to_host(stats)))
    (g_cpu, p_cpu, s_cpu), (g_gpu, p_gpu, s_gpu) = runs
    for k in s_cpu:
        assert abs(s_gpu[k] - s_cpu[k]) <= 5e-3 + 1e-2 * abs(s_cpu[k]), (k, s_gpu[k], s_cpu[k])
    for a, b in zip(tree_leaves(g_cpu), tree_leaves(g_gpu)):
        assert b.dtype == torch.bfloat16
        err = (b.cpu().float() - a.float()).norm() / a.float().norm().clamp_min(1e-30)
        assert err <= 3e-2, err
    n_diff = n_all = 0
    for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_gpu)):
        a, b = a.float(), b.cpu().float()
        ulp = torch.exp2(torch.floor(torch.log2(a.abs().clamp_min(1e-30))) - 7)
        assert bool(((a - b).abs() <= ulp + 2 * 3e-4 * 1.01).all())
        n_diff += int((a != b).sum())
        n_all += a.numel()
    assert n_diff <= 1e-2 * n_all, (n_diff, n_all)


def test_optimizer_peak_memory_is_one_chunk_on_card(cuda, monkeypatch):
    """A stacked leaf of 4 chunks: the update's f32 temporaries stay at a
    chunk's size (CHUNK_ELEMS elements, one layer of a full-width MLP leaf),
    not the leaf's.  The whole-leaf update (CHUNK_ELEMS = the leaf) is the
    yardstick."""
    from repro_torch.optim import adamw
    gen = torch.Generator(device=cuda).manual_seed(9)
    shape = (32, 2048, 4096)                    # 2**28 elements, 8 layers a chunk
    p = (torch.randn(shape, generator=gen, device=cuda) * 0.02).to(torch.bfloat16)
    g = (torch.randn(shape, generator=gen, device=cuda) * 1e-3).to(torch.bfloat16)
    conf = adamw.AdamWConfig(lr=3e-4, fp8_moments=True)
    chunk = adamw.CHUNK_ELEMS
    extra = {}
    for name, elems in (("chunked", chunk), ("whole", p.numel())):
        monkeypatch.setattr(adamw, "CHUNK_ELEMS", elems)
        state = adamw.init({"w": p}, conf)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        adamw.update({"w": p}, {"w": g}, state, conf)
        torch.cuda.synchronize()
        extra[name] = torch.cuda.max_memory_allocated() - base
        del state
    print(f"\noptimizer temporaries over a (32, 2048, 4096) leaf: {extra} bytes; "
          f"one chunk of f32 is {4 * chunk}")
    assert extra["chunked"] <= 16 * 4 * chunk
    assert extra["whole"] >= 3 * extra["chunked"]


def test_serve_step_past_the_cache_raises_on_card(cuda):
    """The steps keep the lengths' maximum on the host: a serve step whose
    write would land past S_max raises a ValueError before any launch,
    and the card stays usable (no device-side assert)."""
    cfg = tiny_serving_config().reduced(d_model=128, d_ff=256, n_heads=4, n_kv_heads=2,
                                        d_head=32)
    prec = PrecisionConfig()
    roll, _ = sync_policy_weights(Transformer(cfg, cuda).init_params(2), prec)
    prefill = steps.make_prefill_step(cfg, ShapeConfig("t", 8, 2, "prefill"), prec)
    serve = steps.make_serve_step(cfg, prec)
    tokens = torch.randint(4, 19, (2, 8), dtype=torch.int32, device=cuda)
    logits, cache = prefill(roll, {"tokens": tokens,
                                   "lengths": torch.tensor([6, 8], dtype=torch.int32)})
    build.reset_launch_counts()
    logits, cache = serve(roll, logits.argmax(-1), cache)       # writes position 8
    assert build.LAUNCHES["decode"] == cfg.n_layers
    with pytest.raises(ValueError, match="past the cache"):
        serve(roll, logits.argmax(-1), cache)
    torch.cuda.synchronize()
    assert cache["lengths"].tolist() == [7, 9] and bool(torch.isfinite(logits).all())


def _engine_run(cfg, roll, prec, dev, trace, **kw):
    eng = ServingEngine(roll, cfg, prec, max_slots=4, max_seq_len=64, prefill_chunk=8,
                        eos_id=None, admission="ondemand", kernel_config="all",
                        device=dev, **kw)
    for i, p in enumerate(trace):
        eng.submit(p, max_new=10, rid=i)
    rep = eng.run(max_steps=500)
    assert len(rep.completed) == len(trace) and not rep.stalled
    assert eng.block_mgr.blocks_in_use == 0
    return rep, {r.rid: r.generated for r in rep.completed}


def test_engine_greedy_contracts_on_card(cuda):
    """On the card (kernels 1, 3, 4, 5): speculative greedy equals plain
    greedy, and a budget that preempts gives the uncontended tokens."""
    cfg = tiny_serving_config().reduced(d_model=128, d_ff=256, n_heads=4, n_kv_heads=2,
                                        d_head=32)
    prec = PrecisionConfig()
    roll, _ = sync_policy_weights(Transformer(cfg, cuda).init_params(5), prec)
    gen = torch.Generator().manual_seed(0)
    trace = [torch.cat([torch.tensor([1]), torch.randint(4, 19, (3,), generator=gen).repeat(5)])
             .to(torch.int32).numpy() for _ in range(5)]
    plain, toks = _engine_run(cfg, roll, prec, cuda, trace)
    spec, spec_toks = _engine_run(cfg, roll, prec, cuda, trace,
                                  spec=SpecConfig(num_draft_tokens=4))
    tight, tight_toks = _engine_run(cfg, roll, prec, cuda, trace,
                                    kv_budget_bytes=48 * kv_bytes_per_token(cfg, prec))
    assert plain.preemptions == 0 and tight.preemptions >= 1 and spec.spec_steps > 0
    assert spec_toks == toks and tight_toks == toks


def test_fleet_failover_and_tracer_on_card(cuda):
    """Two replicas behind the front-end on the card (block size 4, 8-token
    chunks, W8A8 linears over a bf16 cache, EOS on): greedy completions
    after a permanent crash of replica 0 and after a transient crash of
    replica 1 equal the fault-free fleet's bit for bit, every stream is
    delivered exactly once, and a `StepTracer` on every replica changes no
    token."""
    from repro_torch.core.precision import FP8_LINEAR_ROLLOUT
    from repro_torch.obs import StepTracer
    from repro_torch.serving import CrashFault, FaultInjector, FaultPlan, ServingFrontend
    cfg = tiny_serving_config().reduced(d_model=128, d_ff=256, n_heads=4, n_kv_heads=2,
                                        d_head=32)
    prec = FP8_LINEAR_ROLLOUT
    roll, _ = sync_policy_weights(Transformer(cfg, cuda).init_params(5), prec)
    gen = torch.Generator().manual_seed(1)
    trace = [torch.cat([torch.tensor([1]), torch.randint(4, 19, (int(n),), generator=gen)])
             .to(torch.int32).numpy() for n in torch.randint(3, 9, (8,), generator=gen)]

    def serve(crash=None, trace_on=False):
        faults = FaultInjector(FaultPlan(crashes=(CrashFault(**crash),))) if crash else None
        engines = [ServingEngine(roll, cfg, prec, max_slots=3, max_seq_len=48,
                                 prefill_chunk=8, block_size=4, seed=i, faults=faults,
                                 tracer=StepTracer(replica=i) if trace_on else None,
                                 device=cuda) for i in range(2)]
        fe = ServingFrontend(engines)
        for i, p in enumerate(trace):
            fe.submit(p, max_new=12, rid=i)
        streams = {}
        while fe.has_work():
            for o in fe.step():
                streams.setdefault(o.rid, []).extend(o.new_token_ids)
        rep = fe.run()
        finals = {o.rid: o.output.token_ids for o in rep.outputs}
        assert streams == finals and len(finals) == len(trace)
        return finals, rep

    base, _ = serve()
    for crash in (dict(replica=0, step=2, transient=False),
                  dict(replica=1, step=3, transient=True, down_steps=2)):
        got, rep = serve(crash)
        assert rep.redispatches >= 1 and got == base, crash
    traced, rep = serve(trace_on=True)
    assert traced == base and rep.latency["requests"] == len(trace)


def test_group_fork_on_card_equals_tiled_path(cuda):
    """The GRPO fork (pool-row copies on the card) equals the tiled
    group-1 run with the same CUDA generator seed: tokens and masks
    exactly; logps to 1e-4, because the fork prefills 2 rows where the
    tiled run prefills 6, and cuBLAS may pick another kernel (another sum
    order) for the plain f32 lm_head at the other batch size."""
    cfg = tiny_serving_config().reduced(d_model=128, d_ff=256, n_heads=4, n_kv_heads=2,
                                        d_head=32)
    prec = PrecisionConfig()
    model = Transformer(cfg, cuda)
    roll, _ = sync_policy_weights(model.init_params(3), prec)
    prompts = torch.tensor([[1, 5, 6, 7, 8, 9, 10], [1, 9, 10, 11, 12, 4, 5]],
                           dtype=torch.int32)
    lens = torch.tensor([7, 7], dtype=torch.int32)
    samp = SamplerConfig(max_new_tokens=6, temperature=1.0)
    runs = []
    for group_kw, p, ln in ((dict(num_samples_per_prompt=3, shared_prefix_blocks=1),
                             prompts, lens),
                            ({}, prompts.repeat_interleave(3, 0), lens.repeat_interleave(3, 0))):
        gen = torch.Generator(device=cuda).manual_seed(7)
        runs.append(generate(roll, p, ln, gen, cfg, prec, samp, page_size=4,
                             device=cuda, **group_kw))
    for field in ("response_tokens", "response_mask"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field)), field
    assert torch.allclose(runs[0].rollout_logps, runs[1].rollout_logps, atol=1e-4)


def test_wrapper_without_library_raises(cuda, monkeypatch):
    """Given a CUDA tensor and no kernel library, a wrapper raises instead
    of falling back to the plain version."""
    def no_build():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", no_build)
    x = torch.randn((8, 256), device=cuda).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="cannot be built"):
        ops.quantize_activation(x)


# ---------------------------------------------------------------------------
# full FP8, the dense registry's head geometries, the engine's memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", ["HYBRID", "E4M3"])
def test_fp8_dot_on_card_matches_cpu(cuda, recipe):
    """`fp8_dot` forward and backward on the card against the CPU: the
    quantized operands (kernels 1 and 2 against their plain versions)
    bit-equal, y, dx and dw within one bf16 rounding of the largest
    magnitude (the GEMMs' f32 sum order)."""
    from repro_torch.core.precision import Fp8Recipe
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((3, 40, 512), generator=gen).to(torch.bfloat16)
    w = (torch.randn((512, 384), generator=gen) * 0.05).to(torch.bfloat16)
    g = (torch.randn((3, 40, 384), generator=gen)
         * torch.exp(torch.rand((3, 40, 384), generator=gen) * 8 - 6)).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", cuda):
        xr = x.to(dev, copy=True).requires_grad_(True)
        wr = w.to(dev, copy=True).requires_grad_(True)
        y = fp8_linear.fp8_dot(xr, wr, Fp8Recipe[recipe])
        y.backward(g.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (y, xr.grad, wr.grad)]
        out[str(dev) + "q"] = [fp8_linear._qdq_tiles(t.to(dev), fmt, ScaleFormat.FP32).cpu()
                               for t, fmt in ((x.reshape(-1, 512), E4M3),
                                              (g.reshape(-1, 384), E5M2),
                                              (g.reshape(-1, 384).t().contiguous(), E5M2))]
    torch.cuda.synchronize()
    for a, b in zip(out["cpuq"], out[str(cuda) + "q"]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert b.dtype == torch.bfloat16
        tol = 2 ** -7 * a.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol


# (KVH, G, D) of stablelm-3b (G 1, D 80: the 128-lane body with 48 padded
# lanes), llama3.2-3b (G 3), starcoder2-15b (G 12: kernel 6's two halves)
# and seamless-m4t-medium's decoder (G 1, D 64)
REGISTRY_HEADS = [pytest.param(32, 1, 80, id="stablelm-3b"),
                  pytest.param(8, 3, 128, id="llama3.2-3b"),
                  pytest.param(4, 12, 128, id="starcoder2-15b"),
                  pytest.param(16, 1, 64, id="seamless-m4t-medium")]


@pytest.mark.parametrize("kvh,g,d", REGISTRY_HEADS)
def test_attention_kernels_at_registry_heads_on_card(cuda, kvh, g, d):
    """Kernels 4, 5 and 6 at each dense model's (KVH, G, D): within 1e-2
    of the plain versions, stale entries and positions never read."""
    gen = torch.Generator(device=cuda).manual_seed(kvh * 100 + g)
    bs, w = 16, 6
    lengths = torch.tensor([2 * bs + 3, w * bs, 0], dtype=torch.int32, device=cuda)
    q, kq, vq, ks, vs, tables, ln, poison = _decode_case(cuda, gen, 3, kvh, g, d, bs, w,
                                                         lengths)
    out = fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, ln)
    plain = fa.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, ln)
    torch.cuda.synchronize()
    assert torch.allclose(out.float(), plain.float(), rtol=1e-2, atol=1e-2)
    assert bool((out[2] == 0).all())
    c = 40
    q, kq, vq, ks, vs, tables, st, ln, poison = _prefill_case(
        cuda, gen, kvh, g, d, bs, w, [0, 37], [c, 37 + c], c)
    out = fa.fp8_paged_prefill_attention(q, kq, vq, ks, vs, tables, st, ln)
    plain = fa.fp8_paged_prefill_attention_ref(q, kq, vq, ks, vs, tables, st, ln)
    kn, vn = kq.clone(), vq.clone()
    kn.view(torch.uint8)[poison] = 0x7F
    vn.view(torch.uint8)[poison] = 0x7F
    poisoned = fa.fp8_paged_prefill_attention(q, kn, vn, ks, vs, tables, st, ln)
    torch.cuda.synchronize()
    assert torch.allclose(out.float(), plain.float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(poisoned.view(torch.int16), out.view(torch.int16))
    q, kq, vq, ks, vs, ln = _contiguous_case(cuda, gen, 3, kvh, g, d, 1057, [1057, 0, 300])
    _hold_decode(q, kq, vq, ks, vs, ln)


def test_full_fp8_decode_step_launches_no_kernel_4_on_card(cuda):
    """Under FULL_FP8_ROLLOUT a default decode step takes the plain
    attention with the QDQ (no kernel 4; kernels 1 and 3 still run the
    linears); asked for the kernel it launches it, and then equals the
    `PrecisionConfig()` step bit for bit."""
    from repro_torch.core.precision import FULL_FP8_ROLLOUT
    cfg = tiny_serving_config().reduced(d_model=128, d_ff=256, n_heads=4, n_kv_heads=2,
                                        d_head=32)
    model = Transformer(cfg, cuda)
    roll, _ = sync_policy_weights(model.init_params(3), PrecisionConfig())
    tokens = torch.randint(4, 19, (2, 8), dtype=torch.int32, device=cuda)
    inputs = {"tokens": tokens, "lengths": torch.tensor([6, 8], dtype=torch.int32)}
    logits = {}
    for prec, use_kernel in ((PrecisionConfig(), None), (FULL_FP8_ROLLOUT, None),
                             (FULL_FP8_ROLLOUT, True)):
        cache = model.init_cache(2, 16, prec, page_size=4)
        _, cache = model.prefill(roll, inputs, cache, PrecisionConfig())
        build.reset_launch_counts()
        logits[(prec.quantize_attention, use_kernel)], _ = model.decode_step(
            roll, torch.tensor([5, 6], device=cuda), cache, prec, use_kernel=use_kernel)
        torch.cuda.synchronize()
        kernel4 = build.LAUNCHES["paged_decode"]
        assert kernel4 == (0 if (prec.quantize_attention and use_kernel is None)
                           else cfg.n_layers)
        assert build.LAUNCHES["fp8_gemm"] == 7 * cfg.n_layers
    assert torch.equal(logits[(True, True)], logits[(False, None)])
    assert bool(torch.isfinite(logits[(True, None)]).all())
    assert not torch.equal(logits[(True, None)], logits[(False, None)])


def test_dropped_engine_frees_device_memory_on_card(cuda):
    """A dropped engine returns its device memory (pool, tables, host-tier
    staging) with the collector off: `memory_allocated` is back at its
    level before the engine."""
    import gc
    cfg = tiny_serving_config().reduced(d_model=128, d_ff=256, n_heads=4, n_kv_heads=2,
                                        d_head=32)
    prec = PrecisionConfig()
    roll, _ = sync_policy_weights(Transformer(cfg, cuda).init_params(5), prec)
    trace = [torch.randint(4, 19, (12,), dtype=torch.int32).numpy() for _ in range(6)]

    def serve():
        eng = ServingEngine(roll, cfg, prec, max_slots=4, max_seq_len=64, prefill_chunk=8,
                            eos_id=None, admission="ondemand", host_kv_blocks=8,
                            kv_budget_bytes=kv_bytes_per_token(cfg, prec) * 48,
                            kernel_config="all", device=cuda)
        for i, p in enumerate(trace):
            eng.submit(p, max_new=10, rid=i)
        rep = eng.run(max_steps=500)
        assert len(rep.completed) == len(trace) and rep.swap_outs >= 1
        return eng

    serve()            # first use: cuBLAS's workspace and the like stay allocated
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    gc.disable()
    try:
        eng = serve()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda) > before
        del eng
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda) == before
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# MoE: the expert-batched kernel 3, the stable top-k, an MoE model on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,m,k,n", [(4, 9, 256, 384), (8, 1, 128, 256), (5, 33, 512, 128),
                                     (6, 130, 256, 256), (4, 8, 768, 2048)])
def test_batched_gemm_bit_equal_per_expert_on_card(cuda, e, m, k, n, monkeypatch):
    """The expert-batched kernel 3 on a layer of a stacked (L, E, K, N)
    weight: expert e's rows bit-equal to the 2-D kernel on expert e alone,
    within one bf16 rounding of the plain version, and `ops.fp8_matmul`
    hands the launch the sync's storage (no copy)."""
    gen = torch.Generator(device=cuda).manual_seed(e * m + k + n)
    w = (torch.randn((2, e, k, n), generator=gen, device=cuda) * k ** -0.5).to(torch.bfloat16)
    w_q = ops.quantize_weight(w).layer(1)
    x = torch.randn((e, m, k), generator=gen, device=cuda).to(torch.bfloat16)
    x_q = ops.quantize_activation(x)
    seen = []
    launch = build.launch

    def spy(kernel, entry, device, *args):
        if kernel == "fp8_gemm_batched":
            seen.append(args[1])
        return launch(kernel, entry, device, *args)
    monkeypatch.setattr(build, "launch", spy)
    y = ops.fp8_matmul(x_q, w_q)
    torch.cuda.synchronize()
    assert seen == [w_q.data.data_ptr()] and y.shape == (e, m, n)
    for i in range(e):
        one = ops._gemm.fp8_gemm(x_q.data[i].contiguous(), w_q.data[i],
                                 x_q.scales[i].contiguous(), w_q.scales[i])
        assert torch.equal(y[i].view(torch.int16), one.view(torch.int16)), i
    yp = ops._gemm.fp8_gemm_batched_ref(x_q.data, w_q.data, x_q.scales, w_q.scales).float()
    assert torch.allclose(y.float(), yp, rtol=2 ** -7, atol=1e-5 * yp.abs().max().item())


def test_batched_dot_on_card(cuda):
    """`_dot` on stacked experts: one batched bf16 GEMM with f32 sums
    (`aten::bmm.dtype`), within one bf16 rounding of the f32 products, and
    its backward likewise."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((4, 24, 256), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((4, 256, 512), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((4, 24, 512), generator=gen, device=cuda).to(torch.bfloat16)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = fp8_linear._dot(xr, wr)
    ref = torch.bmm(x.float(), w.float())
    assert out.dtype == torch.bfloat16
    assert torch.allclose(out.float(), ref, rtol=2 ** -7, atol=1e-2)
    out.backward(g)
    gf = g.float()
    assert torch.allclose(xr.grad.float(), torch.bmm(gf, w.float().transpose(1, 2)),
                          rtol=2 ** -7, atol=1e-2)
    assert torch.allclose(wr.grad.float(), torch.bmm(x.float().transpose(1, 2), gf),
                          rtol=2 ** -7, atol=1e-2)


def test_stable_top_k_on_card(cuda):
    """Planted ties rank the lower expert first on the card as on the CPU
    (`jax.lax.top_k`'s order; `torch.topk` promises none)."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(2)
    levels = torch.tensor([0.5, 0.25, 0.125, 0.0625])
    probs = levels[torch.randint(0, 4, (512, 128), generator=gen)]
    probs[:, ::7] = 0.5
    v_cpu, i_cpu = moe.top_k(probs, 8)
    v_gpu, i_gpu = moe.top_k(probs.to(cuda), 8)
    assert torch.equal(i_gpu.cpu(), i_cpu) and torch.equal(v_gpu.cpu(), v_cpu)
    assert bool((i_cpu[:, :1] == 0).all())          # column 0 holds a 0.5


def _moe_cfg():
    from repro_torch.configs import get_config
    from repro_torch.data import tasks
    return get_config("granite-moe-3b-a800m").reduced(vocab_size=tasks.VOCAB_SIZE,
                                                      n_layers=2)


def test_moe_decode_step_and_chunk_on_card_match_cpu(cuda):
    """A reduced granite-moe under `PrecisionConfig()`: prefill, one
    decode step and one prefill chunk on the card (kernels 1-5, the
    expert-batched kernel 3) against the same calls on the CPU (plain
    versions): logits within 0.5 (chip_smoke's kernel-vs-plain band),
    routing equal where the CPU's K-th and (K+1)-th probabilities are
    apart; kernel 3 batched twice and kernel 1 twice per MoE layer
    beside the attention's 4 and 2."""
    import numpy as np
    cfg = _moe_cfg()
    prec = PrecisionConfig()
    params = Transformer(cfg, "cpu").init_params(4)
    tokens = torch.randint(4, 19, (3, 12), generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    lengths = torch.tensor([12, 7, 9], dtype=torch.int32)
    chunk = torch.randint(4, 19, (3, 5), generator=torch.Generator().manual_seed(6),
                          dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        model = Transformer(cfg, dev)
        roll, _ = sync_policy_weights(_to(params, dev), prec)
        cache = model.init_cache(3, 24, prec, page_size=4)
        build.reset_launch_counts()
        l0, cache, r0 = model.prefill(roll, {"tokens": tokens.to(dev), "lengths": lengths},
                                      cache, prec, want_routing=True)
        l1, cache, a1 = model.decode_step(roll, l0.argmax(-1), cache, prec, want_routing=True)
        l2, cache, r2 = model.prefill_chunk(roll, chunk, (lengths + 1).numpy(),
                                            np.array([5, 3, 1]), cache,
                                            prec.replace(calculate_kv_scales=False),
                                            use_kernel=True, want_routing=True)
        if dev != "cpu":
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            assert launches["fp8_gemm_batched"] == 2 * cfg.n_layers * 3
            assert launches["fp8_gemm"] == 4 * cfg.n_layers * 3
            assert launches["quant_act"] == 4 * cfg.n_layers * 3
        out[str(dev)] = [t.cpu() for t in (l0, l1, l2)], (r0, a1["routing"], r2)
    (lc, rc), (lg, rg) = out["cpu"], out[str(cuda)]
    for a, b in zip(lc, lg):
        assert bool(torch.isfinite(b).all())
        assert (a - b).abs().max().item() <= 0.5
    assert rc[0]["s0"].shape == rg[0]["s0"].shape == (2, 3, 12, 2)
    assert rg[1]["s0"].shape == (2, 3, 1, 2) and rg[2]["s0"].shape == (2, 3, 5, 2)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
            for k, v in tree.items()}


def test_fp8_router_sync_on_card(cuda):
    """The FP8-router ablation's sync on the card: an (R, D, 40) router
    (granite's 40 experts, N padded to 128 in kernel 2's K-major storage)
    quantizes bit-equal to the CPU's, and its logits on the card equal the
    CPU's within one bf16 rounding."""
    from repro_torch.core.fp8_params import quantize_params
    from repro_torch.core.precision import RouterDtype
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(3)
    router = (torch.randn((2, 256, 40), generator=gen) * 256 ** -0.5).to(torch.bfloat16)
    prec = PrecisionConfig(router_dtype=RouterDtype.FP8)
    q_cpu = quantize_params({"moe": {"router": router}}, prec)["moe"]["router"]
    q_gpu = quantize_params({"moe": {"router": router.to(cuda)}}, prec)["moe"]["router"]
    torch.cuda.synchronize()
    assert tuple(q_gpu.data.shape) == (2, 256, 40)
    assert torch.equal(_bits(q_gpu.data.contiguous()).cpu(), _bits(q_cpu.data.contiguous()))
    assert torch.equal(q_gpu.scales.cpu(), q_cpu.scales)
    x = torch.randn((16, 256), generator=gen).to(torch.bfloat16)
    lc = moe.router_logits(x, q_cpu.layer(1))
    lg = moe.router_logits(x.to(cuda), q_gpu.layer(1)).cpu()
    assert lg.shape == (16, 40)
    assert torch.allclose(lg, lc, rtol=2 ** -7, atol=1e-3)


# ---------------------------------------------------------------------------
# SSM and hybrid
# ---------------------------------------------------------------------------

def _plain_matmul(a, wq, a_s):
    """Kernel 3's plain version on the padded operands `ops.fp8_matmul`
    hands the kernel, cut to the weight's N, in f32."""
    from repro_torch.kernels import fp8_gemm as fg
    n = wq.data.shape[1]
    return fg.fp8_gemm_ref(a, ops._gemm_weight(wq.data), a_s, wq.scales)[:, :n].float()


def test_gemm_at_mamba2_w_in_width_on_card(cuda):
    """Kernel 3 at mamba2's w_in shape (K 1536, N 6448: stored at N 6528)
    through `ops.fp8_matmul` at M 1, 8, 33 and 128: within one bf16
    rounding of the plain version on the same operands, the (M, 6448)
    result a view of the padded output (an SSM's split takes it as is)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    k, n = 1536, 2 * 3072 + 2 * 128 + 48
    w = (torch.randn((2, k, n), generator=gen, device=cuda) * k ** -0.5).to(torch.bfloat16)
    wq = ops.quantize_weight(w).layer(1)
    x = torch.randn((128, k), generator=gen, device=cuda).to(torch.bfloat16)
    for m in (1, 8, 33, 128):
        xq = ops.quantize_activation(x[:m])
        y = ops.fp8_matmul(xq, wq)
        a = xq.data.contiguous()
        yp = _plain_matmul(a, wq, xq.scales)
        torch.cuda.synchronize()
        assert tuple(y.shape) == (m, n) and bool(torch.isfinite(y).all())
        scale = yp.abs().max().item()
        assert torch.allclose(y.float(), yp, rtol=2 ** -7, atol=1e-5 * scale), m


def test_ssd_scan_on_card_matches_cpu(cuda):
    """`ssd_scan` with bf16 chunk inputs and an h0 (B 2, T 128, H 4 of 16,
    N 8, chunk 64): on the card the intra-chunk product is one bf16
    batched GEMM with f32 sums (`_BmmF32`), on the CPU the rounded
    operands widened to f32.  y and the final state within 1e-3 of their
    largest entries, and the gradients of xh and dt within 1e-2 of
    theirs (the backward rounds the product's gradient to bf16 on the
    card, as `_dot`'s does)."""
    from repro_torch.models import ssm as tssm
    gen = torch.Generator().manual_seed(12)
    b, t, h, p, n = 2, 128, 4, 16, 8
    xh = torch.randn((b, t, h, p), generator=gen).to(torch.bfloat16)
    dt = torch.rand((b, t, h), generator=gen) * 0.5
    a = -torch.linspace(1.0, 4.0, h)
    bm = torch.randn((b, t, n), generator=gen).to(torch.bfloat16)
    cm = torch.randn((b, t, n), generator=gen).to(torch.bfloat16)
    h0 = torch.randn((b, h, p, n), generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        x_, dt_ = (v.detach().to(dev).requires_grad_() for v in (xh, dt))
        y, hl = tssm.ssd_scan(x_, dt_, a.to(dev), bm.to(dev), cm.to(dev), chunk=64,
                              h0=h0.to(dev))
        (y.square().mean() + hl.square().mean()).backward()
        out[str(dev)] = [v.detach().float().cpu() for v in (y, hl, x_.grad, dt_.grad)]
    for i, (c, g) in enumerate(zip(out["cpu"], out[str(cuda)])):
        assert bool(torch.isfinite(g).all())
        tol = 1e-3 if i < 2 else 1e-2
        assert (c - g).abs().max().item() <= tol * c.abs().max().item(), i


def _state_cfgs():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import tasks
    ssm = get_config("mamba2-780m").reduced(n_layers=2, vocab_size=tasks.VOCAB_SIZE)
    hybrid = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(
        n_layers=8, vocab_size=tasks.VOCAB_SIZE, n_experts=0, top_k=0, moe_period=1,
        moe_offset=0), n_layers=8)
    return {"ssm": ssm, "hybrid": hybrid}


@pytest.mark.parametrize("pattern", ["ssm", "hybrid"])
def test_ssm_decode_step_and_chunk_on_card_match_cpu(cuda, pattern):
    """A reduced mamba2 (2 layers, d 128, d_inner 256) and a reduced
    jamba period (1 attention, 7 SSM layers) under `PrecisionConfig()`:
    prefill, two decode steps and one prefill chunk on the card (kernels
    1 and 3; kernels 4 and 5 for the hybrid) against the same calls on
    the CPU: logits within 0.5 (chip_smoke's kernel-vs-plain band), every
    SSM state within 1e-2 of its largest entry; kernel 1 : kernel 3 at 1 :
    1 in an SSM layer."""
    import numpy as np
    cfg = _state_cfgs()[pattern]
    prec = PrecisionConfig()
    params = Transformer(cfg, "cpu").init_params(6)
    tokens = torch.randint(4, 19, (3, 12), generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    lengths = torch.tensor([12, 7, 9], dtype=torch.int32)
    chunk = torch.randint(4, 19, (3, 5), generator=torch.Generator().manual_seed(6),
                          dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        model = Transformer(cfg, dev)
        roll, _ = sync_policy_weights(_to(params, dev), prec)
        cache = model.init_cache(3, 24, prec, page_size=4)
        build.reset_launch_counts()
        l0, cache = model.prefill(roll, {"tokens": tokens.to(dev), "lengths": lengths},
                                  cache, prec)
        l1, cache = model.decode_step(roll, l0.argmax(-1), cache, prec)
        l2, cache = model.decode_step(roll, l1.argmax(-1), cache, prec)
        l3, cache = model.prefill_chunk(roll, chunk, (lengths + 2).numpy(),
                                        np.array([5, 3, 1]), cache,
                                        prec.replace(calculate_kv_scales=False),
                                        use_kernel=True)
        if dev != "cpu":
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            if pattern == "ssm":
                assert launches["quant_act"] == launches["fp8_gemm"] == 2 * cfg.n_layers * 4
            else:
                assert launches["paged_decode"] == 2 and launches["paged_prefill"] == 1
        states = {name: (sd["ssm"].h.cpu(), sd["ssm"].conv.float().cpu())
                  for name, sd in cache["slots"].items() if "ssm" in sd}
        out[str(dev)] = [t.cpu() for t in (l0, l1, l2, l3)], states
    (lc, sc), (lg, sg) = out["cpu"], out[str(cuda)]
    for a, b in zip(lc, lg):
        assert bool(torch.isfinite(b).all())
        assert (a - b).abs().max().item() <= 0.5
    assert sc.keys() == sg.keys() and len(sc) == (1 if pattern == "ssm" else 7)
    for name in sc:
        for a, b in zip(sc[name], sg[name]):
            assert (a - b).abs().max().item() <= 1e-2 * a.abs().max().item(), name


@pytest.mark.parametrize("pattern", ["ssm", "hybrid"])
def test_engine_ssm_write_back_and_swap_in_on_card(cuda, pattern):
    """The engine on the card with SSM slot state, W8A8 linears over a
    bf16 KV pool (an FP8 pool's scales come from the first prefill, which
    differs between these runs): a piggybacked decode between a long
    prompt's chunks leaves that slot's state alone (the write-back), and a
    budget cut that swaps requests out and back in serves the roomy run's
    tokens bit for bit (the swap-in)."""
    from repro_torch.core.precision import FP8_LINEAR_ROLLOUT
    from repro_torch.data import tasks
    from repro_torch.serving import StepBudget, request_state_bytes
    cfg = _state_cfgs()[pattern]
    prec = FP8_LINEAR_ROLLOUT
    roll, _ = sync_policy_weights(Transformer(cfg, cuda).init_params(7), prec)
    long_prompt = tasks.random_prompt(3, 20)

    def engine(**kw):
        return ServingEngine(roll, cfg, prec, max_slots=2, max_seq_len=48, prefill_chunk=4,
                             eos_id=None, device=cuda, **kw)
    alone = engine()
    alone.submit(long_prompt, max_new=5, rid=0)
    want = alone.run(max_steps=100).completed[0].generated
    eng = engine(step_budget=StepBudget(prefill_tokens=4))
    eng.submit(tasks.random_prompt(9, 5), max_new=12, rid=1)
    eng.step()
    eng.submit(long_prompt, max_new=5, rid=0)
    rep = eng.run(max_steps=100)
    assert {r.rid: r.generated for r in rep.completed}[0] == want

    per = max(kv_bytes_per_token(cfg, prec), 1)
    state = request_state_bytes(cfg, prec)
    runs = {}
    for name, budget, shrink in (("roomy", per * 4 * 200 + 16 * state, None),
                                 ("tight", per * 4 * 10 + int(2.5 * state), 4)):
        eng = ServingEngine(roll, cfg, prec, max_slots=4, max_seq_len=48,
                            admission="ondemand", eos_id=None, kv_budget_bytes=budget,
                            device=cuda)
        for i in range(5):
            eng.submit(tasks.random_prompt(i, 5 + i % 5), max_new=8, rid=i)
        full = eng.budget_tokens
        while eng.queue or any(r is not None for r in eng.slot_req):
            if shrink is not None and eng.stats["steps"] >= shrink:
                eng.budget_tokens, shrink = int(full * 0.6), None
            assert not eng.step().is_empty
        runs[name] = eng.stats["swap_ins"], {r.rid: r.generated for r in eng.done}
    assert runs["roomy"][0] == 0 and runs["tight"][0] >= 1
    assert runs["tight"][1] == runs["roomy"][1]


def _encdec_vlm_cfgs():
    from repro_torch.configs import get_config, tiny_encdec_serving_config
    return {"encdec": tiny_encdec_serving_config(),
            "vlm": get_config("pixtral-12b").reduced(n_layers=2)}


@pytest.mark.parametrize("pattern", ["encdec", "vlm"])
def test_encdec_decode_and_vlm_prefill_on_card_match_cpu(cuda, pattern):
    """Under `PrecisionConfig()`: a reduced seamless (2 + 2 layers) prefill
    over frames (encoder, cross caches) and two decode steps on a paged
    cache (kernel 4, the cross attention plain), and a reduced pixtral (2
    layers, 8 patches) prefill over its prefix and one serve step on a
    contiguous cache (kernel 6), on the card against the same calls on
    the CPU: logits within 0.5 (chip_smoke's kernel-vs-plain band), cross
    scales within 1e-2; kernel 1 and kernel 3 launched as the path's
    prefill and decode steps count them."""
    cfg = _encdec_vlm_cfgs()[pattern]
    prec = PrecisionConfig()
    params = Transformer(cfg, "cpu").init_params(8)
    g = torch.Generator().manual_seed(9)
    tokens = torch.randint(4, 19, (3, 10), generator=g, dtype=torch.int32)
    lengths = torch.tensor([10, 6, 8], dtype=torch.int32)
    extra = {}
    if pattern == "encdec":
        extra = {"frames": torch.randn((3, 12, cfg.d_model), generator=g).to(torch.bfloat16),
                 "src_lengths": torch.tensor([12, 5, 9], dtype=torch.int32)}
    else:
        extra = {"patches": torch.randn((3, cfg.frontend_len, cfg.d_model),
                                        generator=g).to(torch.bfloat16)}
    out = {}
    for dev in ("cpu", cuda):
        model = Transformer(cfg, dev)
        roll, _ = sync_policy_weights(_to(params, dev), prec)
        inputs = {k: v.to(dev) for k, v in dict(extra, tokens=tokens, lengths=lengths).items()}
        build.reset_launch_counts()
        if pattern == "encdec":
            cache = model.init_cache(3, 16, prec, page_size=4, src_len=12)
            l0, cache = model.prefill(roll, inputs, cache, prec)
            l1, cache = model.decode_step(roll, l0.argmax(-1), cache, prec)
            l2, cache = model.decode_step(roll, l1.argmax(-1), cache, prec)
            logits = [l0, l1, l2]
            scales = torch.stack([sd["cross"].k_scale for sd in cache["slots"].values()])
        else:
            cache = model.init_cache(3, cfg.frontend_len + 12, prec)
            l0, cache = model.prefill(roll, inputs, cache, prec)
            l1, cache = model.decode_step(roll, l0.argmax(-1), cache, prec)
            logits, scales = [l0, l1], torch.zeros(1)
        if dev != "cpu":
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            # per layer: prefill 7 : 10 (seamless, + its encoder 4 : 6) or
            # 4 : 7 (pixtral), w_patch 1 : 1; decode 6 : 8 or 4 : 7
            n = cfg.n_layers
            if pattern == "encdec":
                want = (1 + n * 4 + n * 7 + 2 * n * 6, 1 + n * 6 + n * 10 + 2 * n * 8)
                assert launches["paged_decode"] == 2 * n
            else:
                want = (1 + n * 4 + n * 4, 1 + n * 7 + n * 7)
                assert launches["decode"] == n
            assert (launches["quant_act"], launches["fp8_gemm"]) == want
        out[str(dev)] = [t.cpu() for t in logits], scales.cpu()
    (lc, sc), (lg, sg) = out["cpu"], out[str(cuda)]
    for a, b in zip(lc, lg):
        assert bool(torch.isfinite(b).all())
        assert (a - b).abs().max().item() <= 0.5
    assert torch.allclose(sc, sg, rtol=1e-2)


def test_encdec_engine_preempt_resume_on_card(cuda):
    """The enc-dec engine on the card, W8A8 linears over a bf16 KV pool:
    the reference's pressured trace (5 requests with 6 frames each, 4
    slots, a budget of ~2.5 requests' state + 40 tokens of KV cut to 60%
    at decode step 4) swaps requests out with their cross KV and back in,
    and serves the roomy run's tokens bit for bit."""
    from repro_torch.configs import tiny_encdec_serving_config
    from repro_torch.core.precision import FP8_LINEAR_ROLLOUT
    from repro_torch.data import tasks
    from repro_torch.serving import request_state_bytes
    cfg = tiny_encdec_serving_config()
    prec = FP8_LINEAR_ROLLOUT
    roll, _ = sync_policy_weights(Transformer(cfg, cuda).init_params(7), prec)
    per = max(kv_bytes_per_token(cfg, prec), 1)
    state = request_state_bytes(cfg, prec, src_len=8)
    runs = {}
    for name, budget, shrink in (("roomy", per * 4 * 200 + 16 * state, None),
                                 ("tight", per * 4 * 10 + int(2.5 * state), 4)):
        eng = ServingEngine(roll, cfg, prec, max_slots=4, max_seq_len=48,
                            admission="ondemand", eos_id=None, kv_budget_bytes=budget,
                            device=cuda)
        for i in range(5):
            eng.submit(tasks.random_prompt(i, 5 + i % 5), max_new=8, rid=i,
                       frames=tasks.random_frames(100 + i, 6, cfg.d_model))
        full = eng.budget_tokens
        while eng.queue or any(r is not None for r in eng.slot_req):
            if shrink is not None and eng.stats["steps"] >= shrink:
                eng.budget_tokens, shrink = int(full * 0.6), None
            assert not eng.step().is_empty
        runs[name] = eng.stats["swap_ins"], {r.rid: r.generated for r in eng.done}
    assert runs["roomy"][0] == 0 and runs["tight"][0] >= 1
    assert runs["tight"][1] == runs["roomy"][1]


# ---------------------------------------------------------------------------
# the distributed runtime's pieces on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4096 * 64, 4 * 333])
def test_quant_act_long_f32_row_bit_equal_on_card(cuda, n):
    """Kernel 1 on the one (1, n) f32 row `compressed_psum` quantizes
    (padded to 128), bit-equal to its plain version."""
    import torch.nn.functional as F
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = F.pad(torch.randn((1, n), generator=gen, device=cuda) * 1e-3, (0, (-n) % 128))
    qt = ops.quantize_activation(x)
    qr, sr = fq.quantize_activation_ref(x)
    q, s = qt.data, qt.scales
    assert torch.equal(_bits(q), _bits(qr)) and torch.equal(s, sr)


def test_constrain_is_a_no_op_on_plain_cuda_tensors(cuda):
    from repro_torch.distributed.sharding import MeshShape, ShardingRules
    from repro_torch.models.common import activation_sharding, constrain
    x = torch.ones((2, 16, 64), device=cuda)
    with activation_sharding(ShardingRules(MeshShape(("data", "model"), (2, 4)))):
        assert constrain(x, "act_btd") is x
        assert constrain(x, "logits") is x
    assert constrain(x, "act_btd") is x


@pytest.mark.parametrize("experts", [0, 3], ids=["mm", "bmm"])
def test_dot_on_a_one_rank_mesh_uses_the_mm_dtype_strategy(cuda, tmp_path, experts):
    """`_dot` of DTensors on a 1-rank cuda mesh: `aten::mm.dtype` and, for
    stacked experts, `aten::bmm.dtype` (no DTensor strategies of their
    own) take the registered mm / bmm strategies; the result and both
    gradients equal the plain tensors' bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import host_collectives
    from repro_torch.distributed.sharding import register_dtensor_ops
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        if host_collectives.needs_host(cuda):
            host_collectives.install()
        register_dtensor_ops()
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
        gen = torch.Generator(device=cuda).manual_seed(0)
        lead = (experts,) if experts else ()
        x = torch.randn(lead + (24, 64), generator=gen, device=cuda).to(torch.bfloat16)
        w = torch.randn(lead + (64, 40), generator=gen, device=cuda).to(torch.bfloat16)
        want = fp8_linear._dot(x.requires_grad_(), w.requires_grad_())
        want.float().sum().backward()
        dx = DTensor.from_local(x.detach().clone(), mesh, [Shard(0)]).requires_grad_()
        dw = DTensor.from_local(w.detach().clone(), mesh, [Replicate()]).requires_grad_()
        got = fp8_linear._dot(dx, dw)
        assert isinstance(got, DTensor) and got.placements == (Shard(0),)
        got.float().sum().backward()
        assert torch.equal(got.to_local(), want)
        assert torch.equal(dx.grad.to_local(), x.grad)
        assert torch.equal(dw.grad.full_tensor(), w.grad)
    finally:
        dist.destroy_process_group()
