#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout's `src/`; imports nothing of
JAX or of the JAX package.  Phases, in order (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the four CUDA kernels from `src/repro_torch/csrc` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: the quantizers bit-equal (FP32 scales; UE8M0
   mismatching tiles are counted and printed), fp8_gemm within one bf16
   rounding (rtol 2**-7), paged decode within 1e-2 plus the stale-entry
   (NaN-poison) and idle-slot checks;
4. the main path on full-width, full-depth qwen3-8b with random weights
   from a seed: `sync_policy_weights(PrecisionConfig())`, then `generate`
   with 8 ragged prompts (64-128 tokens), 32 new tokens, page size 16 —
   greedy, then temperature 1 with GRPO groups of 4 over shared prefix
   blocks.  The launch counts are zeroed just before and read just after;
   every kernel must have launched.  Outputs are checked (finite, in
   range), and one decode step's logits through the kernels are held
   against the plain versions on the same CUDA tensors (allclose within
   LOGIT_ATOL plus argmax where the top-2 gap exceeds twice that); one
   decode step is profiled for its device-busy share;
5. each kernel's time at the main path's shapes beside its plain
   version's, one library call's where one computes the same function,
   and the bound (bytes over 3.35 TB/s or operations over the peak rate).

The line before the last is the `kernels` JSON object; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
FP8_TC_FLOPS = 1979e12             # dense fp8 tensor cores
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12                  # f32 outside the tensor cores
# kernel vs plain decode-step logits on full-depth qwen3-8b: measured 0.207
# on the H100 (1-ulp attention differences flip fp8 roundings of later
# activations over 36 layers); held at about 2.4x that
LOGIT_ATOL = 0.5
SEED = 0
KERNEL_SOURCES = {
    "quant_act": ("src/repro_torch/csrc/fp8_quant.cu", "src/repro/kernels/fp8_quant.py:55"),
    "quant_weight": ("src/repro_torch/csrc/fp8_quant.cu", "src/repro/kernels/fp8_quant.py:90"),
    "fp8_gemm": ("src/repro_torch/csrc/fp8_gemm.cu", "src/repro/kernels/fp8_gemm.py:72"),
    "paged_decode": ("src/repro_torch/csrc/fp8_paged_decode.cu",
                     "src/repro/kernels/fp8_kv_attention.py:285"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20, warmup=3):
    """Mean device time of `fn()` over `reps` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, peak_flops):
    """(bound_ms, bound_by): the larger of bytes/HBM rate and flops/peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def compare_quantizers(dev, gen, results):
    import torch
    from repro_torch.core.precision import E4M3, ScaleFormat
    from repro_torch.kernels import fp8_quant as fq

    def mismatches(a, b):
        return int((a.view(torch.uint8) != b.view(torch.uint8)).sum())

    for name, shapes, kernel, plain, std in (
            ("quant_weight", [(4096, 12288), (12288, 4096)], fq.quantize_weight_kernel,
             fq.quantize_weight_ref, 0.02),
            ("quant_act", [(8, 4096), (1024, 4096), (8, 12288)],
             fq.quantize_activation_kernel, fq.quantize_activation_ref, 3.0)):
        for shape in shapes:
            x = (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)
            qk, sk = kernel(x, E4M3, ScaleFormat.FP32)
            qp, sp = plain(x, E4M3, ScaleFormat.FP32)
            torch.cuda.synchronize()
            bad_q, bad_s = mismatches(qk, qp), int((sk != sp).sum())
            log(f"{name} {shape}: payload mismatches {bad_q}, scale mismatches {bad_s}")
            check(bad_q == 0 and bad_s == 0, f"{name} {shape} not bit-equal")
            qk, sk = kernel(x, E4M3, ScaleFormat.UE8M0)
            qp, sp = plain(x, E4M3, ScaleFormat.UE8M0)
            torch.cuda.synchronize()
            log(f"{name} {shape} UE8M0: mismatching scale tiles {int((sk != sp).sum())} "
                f"of {sk.numel()}, payload bytes {mismatches(qk, qp)}")
        results[name]["max_abs_err"] = 0.0


def compare_gemm(dev, gen, results):
    import torch
    from repro_torch.kernels import fp8_gemm as fg
    from repro_torch.kernels import fp8_quant as fq
    worst = 0.0
    for m in (8, 1024):
        for k, n in ((4096, 1024), (4096, 4096), (4096, 12288), (12288, 4096)):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
            a, a_s = fq.quantize_activation_kernel(x)
            wq, w_s = fq.quantize_weight_kernel(w)
            yk = fg.fp8_gemm(a, wq, a_s, w_s).float()
            yp = fg.fp8_gemm_ref(a, wq, a_s, w_s).float()
            torch.cuda.synchronize()
            err = (yk - yp).abs().max().item()
            scale = yp.abs().max().item()
            ok = torch.allclose(yk, yp, rtol=2 ** -7, atol=1e-5 * scale)
            log(f"fp8_gemm M={m} K={k} N={n}: max|kernel-plain| {err:.3e} "
                f"(max|plain| {scale:.3f}) {'ok' if ok else 'FAIL'}")
            check(ok, f"fp8_gemm M={m} K={k} N={n} disagrees with its plain version")
            worst = max(worst, err)
    results["fp8_gemm"]["max_abs_err"] = worst


def decode_case(dev, gen, b=8, kvh=8, g=4, d=128, bs=16, max_len=300, lengths=None):
    """A paged pool with ragged live regions and the rest of every table
    pointing at one poison row (the last)."""
    import torch
    from repro_torch.core.precision import E4M3
    w = -(-max_len // bs)
    nrows = b * w + 1
    poison = nrows - 1
    k = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    v = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    ks, vs = k.abs().amax() / 448, v.abs().amax() / 448
    kq, vq = (k / ks).clamp(-448, 448).to(E4M3), (v / vs).clamp(-448, 448).to(E4M3)
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    if lengths is None:
        lengths = torch.randint(1, max_len + 1, (b,), generator=gen, device=dev)
    lengths = lengths.to(torch.int32)
    tables = torch.randperm(nrows - 1, generator=gen, device=dev)[: b * w].reshape(b, w)
    live = ((lengths.long() + bs - 1) // bs).clamp(1, w)
    dead = torch.arange(w, device=dev)[None, :] >= live[:, None]
    tables = torch.where(dead, poison, tables).to(torch.int32)
    return q, kq, vq, ks.float(), vs.float(), tables, lengths, poison


def compare_decode(dev, gen, results):
    import torch
    from repro_torch.kernels import fp8_kv_attention as fa
    q, kq, vq, ks, vs, tables, lengths, poison = decode_case(dev, gen)
    out_k = fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths)
    out_p = fa.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lengths)
    kn, vn = kq.clone(), vq.clone()
    kn[poison] = float("nan")
    vn[poison] = float("nan")
    out_n = fa.fp8_paged_decode_attention(q, kn, vn, ks, vs, tables, lengths)
    idle = fa.fp8_paged_decode_attention(
        q[:2], kq, vq, ks, vs, tables[:2],
        torch.tensor([0, 17], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    err = (out_k.float() - out_p.float()).abs().max().item()
    ok = torch.allclose(out_k.float(), out_p.float(), rtol=1e-2, atol=1e-2)
    log(f"paged_decode B=8 KVH=8 G=4 D=128 BS=16 lengths {lengths.tolist()}: "
        f"max|kernel-plain| {err:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, "paged decode disagrees with its plain version")
    check(torch.equal(out_n.view(torch.int16), out_k.view(torch.int16)),
          "a NaN-poisoned stale table entry reached the paged-decode output")
    check(bool((idle[0] == 0).all()), "an idle slot (length 0) is not exact zeros")
    log("paged_decode: stale entries never read (NaN poison), idle slot exact zeros")
    results["paged_decode"]["max_abs_err"] = err


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def make_prompts(rng, b=8, lo=64, hi=128):
    import numpy as np
    from repro_torch.data import tasks
    lengths = rng.integers(lo, hi + 1, size=b).astype(np.int32)
    prompts = np.zeros((b, int(lengths.max())), np.int32)
    for i, n in enumerate(lengths):
        prompts[i, :n] = tasks.random_prompt(SEED + i, int(n))
    return prompts, lengths


def check_trajectory(traj, n_rows, max_new, vocab, tag):
    import torch
    tok, logps, mask = traj.response_tokens, traj.rollout_logps, traj.response_mask
    check(tuple(tok.shape) == (n_rows, max_new), f"{tag}: token shape {tuple(tok.shape)}")
    check(bool(((tok >= 0) & (tok < vocab)).all()), f"{tag}: token out of range")
    check(bool(torch.isfinite(logps).all()) and bool((logps <= 0).all()),
          f"{tag}: logps not finite and <= 0")
    check(bool(((mask == 0) | (mask == 1)).all()), f"{tag}: mask not 0/1")
    check(bool((mask[:, 1:] <= mask[:, :-1]).all()), f"{tag}: mask not a prefix")
    check(torch.equal(traj.response_lengths, mask.sum(1).to(torch.int32)),
          f"{tag}: response lengths disagree with the mask")
    for sc in traj.kv_scales.values():
        for s in sc.values():
            check(bool(torch.isfinite(s).all()) and bool((s > 0).all()),
                  f"{tag}: kv scale not finite and positive")


def decode_logits_check(model, roll, prec, prompts, lengths, dev):
    """One decode step through the kernels vs the plain versions called on
    the same CUDA tensors (the same cache, cloned)."""
    import copy

    import torch
    from repro_torch.kernels import ops
    cache = model.init_cache(len(prompts), prompts.shape[1] + 2, prec, page_size=16)
    logits, cache = model.prefill(roll, {"tokens": torch.from_numpy(prompts).to(dev),
                                         "lengths": torch.from_numpy(lengths).to(dev)},
                                  cache, prec)
    tok = logits.argmax(-1)
    twin = copy.deepcopy(cache)
    lk, _ = model.decode_step(roll, tok, cache, prec)
    with mock.patch.object(ops, "_route", lambda t, kernel, plain: plain):
        lp, _ = model.decode_step(roll, tok, twin, prec)
    torch.cuda.synchronize()
    err = (lk - lp).abs().max().item()
    mean_err = (lk - lp).abs().mean().item()
    top2 = lp.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_ATOL
    agree = bool((lk.argmax(-1) == lp.argmax(-1))[decisive].all())
    log(f"decode-step logits kernel vs plain: max abs err {err:.4f}, mean {mean_err:.5f} "
        f"(max|logit| {lp.abs().max().item():.3f}, tol {LOGIT_ATOL}); "
        f"argmax equal on {int(decisive.sum())} decisive rows: {agree}; "
        f"on all rows: {bool((lk.argmax(-1) == lp.argmax(-1)).all())}")
    check(bool(torch.isfinite(lk).all()), "kernel logits not finite")
    check(err <= LOGIT_ATOL and agree, "decode-step logits: kernels disagree with plain")
    return err


def profile_decode_step(model, roll, prec, prompts, lengths, dev):
    """Device-busy share of one decode step: kernel time on the stream
    (torch.profiler) over the step's wall time without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = model.init_cache(len(prompts), prompts.shape[1] + 4, prec, page_size=16)
    logits, cache = model.prefill(roll, {"tokens": torch.from_numpy(prompts).to(dev),
                                         "lengths": torch.from_numpy(lengths).to(dev)},
                                  cache, prec)
    tok = logits.argmax(-1)
    model.decode_step(roll, tok, cache, prec)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.decode_step(roll, tok, cache, prec)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.decode_step(roll, tok, cache, prec)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"decode step: wall {wall_ms:.1f} ms; device time not measured "
            "(the profiler saw no CUDA events)")
        return {"decode_step_wall_ms": wall_ms}
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"decode_step_wall_ms": wall_ms, "decode_step_device_busy_ms": busy_ms,
           "decode_step_device_kernels": len(kernels),
           "decode_step_device_busy_share": busy_ms / wall_ms}
    log("decode step profile: " + json.dumps(out) + "; top kernels (ms): "
        + json.dumps([[name[:60], round(ms, 3)] for name, ms in top]))
    return out


def main_path(dev, results, cfg):
    import numpy as np
    import torch
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.rl import SamplerConfig, generate, sync_policy_weights

    prec = PrecisionConfig()
    model = Transformer(cfg, dev)
    t0 = time.perf_counter()
    params = model.init_params(SEED)
    torch.cuda.synchronize()
    log(f"init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts, lengths = make_prompts(rng)
    min_len = int(lengths.min())
    stats = {}

    build.reset_launch_counts()
    # --- the main path: weight sync + two generate runs -------------------
    roll, sync_stats = sync_policy_weights(params, prec)
    stats["sync_ms"] = sync_stats["sync_ms"]
    counts = [dict(build.LAUNCHES)]
    greedy = SamplerConfig(max_new_tokens=32, temperature=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_greedy = generate(roll, prompts, lengths, None, cfg, prec, greedy,
                        page_size=16, device=dev)
    torch.cuda.synchronize()
    stats["greedy_generate_s"] = time.perf_counter() - t0
    counts.append(dict(build.LAUNCHES))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sampled = SamplerConfig(max_new_tokens=32, temperature=1.0)
    t0 = time.perf_counter()
    t_group = generate(roll, prompts, lengths, gen, cfg, prec, sampled, page_size=16,
                       num_samples_per_prompt=4, shared_prefix_blocks=min_len // 16,
                       device=dev)
    torch.cuda.synchronize()
    stats["group_generate_s"] = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    # ----------------------------------------------------------------------
    counts.append(launches)
    per_run = [{k: b[k] - a[k] for k in b} for a, b in zip(counts, counts[1:])]
    log(f"main-path launches: {launches}; weight sync: {counts[0]}; "
        f"greedy generate: {per_run[0]}; group generate: {per_run[1]}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        results[name]["launches"] = n

    steps = per_run[0]["paged_decode"] // cfg.n_layers
    check_trajectory(t_greedy, 8, 32, cfg.vocab_size, "greedy")
    check_trajectory(t_group, 32, 32, cfg.vocab_size, "group")
    log("trajectories: tokens in range, logps finite and <= 0, masks prefix-shaped, "
        "kv scales finite and positive")
    stats["greedy_decode_steps"] = steps
    stats["greedy_tokens"] = int(t_greedy.response_lengths.sum())
    stats["group_tokens"] = int(t_group.response_lengths.sum())

    # prefill alone, on the same prompts (host clock, synchronized)
    cache = model.init_cache(8, prompts.shape[1] + 33, prec, page_size=16)
    inputs = {"tokens": torch.from_numpy(prompts).to(dev),
              "lengths": torch.from_numpy(lengths).to(dev)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(roll, inputs, cache, prec)
    torch.cuda.synchronize()
    stats["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    stats["decode_ms_per_step"] = ((stats["greedy_generate_s"] * 1e3 - stats["prefill_ms"])
                                   / max(steps, 1))
    stats["greedy_tokens_per_s"] = stats["greedy_tokens"] / stats["greedy_generate_s"]
    stats["group_tokens_per_s"] = stats["group_tokens"] / stats["group_generate_s"]
    stats["prompt_lengths"] = lengths.tolist()
    stats["kv_k_scale_range"] = [
        float(t_greedy.kv_scales["s0"]["k_scale"].min()),
        float(t_greedy.kv_scales["s0"]["k_scale"].max())]
    stats["decode_logit_max_abs_err"] = decode_logits_check(
        model, roll, prec, prompts, lengths, dev)
    stats.update(profile_decode_step(model, roll, prec, prompts, lengths, dev))
    log("main path: " + json.dumps(stats))
    return roll, t_greedy


# ---------------------------------------------------------------------------
# phase 5: times at the main path's shapes
# ---------------------------------------------------------------------------

def library_gemm(a, wq, a_s, w_s, reference):
    """torch's blockwise-scaled fp8 GEMM (1x128 x 128x128 scales) as the
    yardstick, in the first scale layout this build accepts; None where
    it runs none of them or computes another function."""
    import torch
    import torch.nn.functional as F
    b = wq.t().contiguous().t()          # column-major W, as cuBLAS wants it
    for sa, sb in ((a_s.t().contiguous().t(), w_s.t().contiguous().t()),
                   (a_s.t().contiguous().t(), w_s), (a_s, w_s),
                   (a_s, w_s.t().contiguous().t())):
        def call(sa=sa, sb=sb):
            return F.scaled_mm(a, b, sa, F.ScalingType.BlockWise1x128, sb,
                               F.ScalingType.BlockWise128x128,
                               output_dtype=torch.bfloat16)
        try:
            out = call().float()
        except RuntimeError as exc:        # this layout or build unsupported
            log(f"library fp8 GEMM: layout refused ({str(exc)[:160]})")
            continue
        if torch.allclose(out, reference, rtol=2 ** -6, atol=1e-3):
            return call
        log("library fp8 GEMM: computes another function here; not used")
        return None
    return None


def time_kernels(dev, gen, results, cfg, roll, traj, extra):
    import torch
    from repro_torch.kernels import fp8_gemm as fg
    from repro_torch.kernels import fp8_kv_attention as fa
    from repro_torch.kernels import fp8_quant as fq
    d, f = cfg.d_model, cfg.d_ff

    # quant_act at the decode shape (8, d_model) and the prefill shape
    for m in (8, 1024):
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        row = dict(ms=cuda_time_ms(lambda: fq.quantize_activation_kernel(x)),
                   plain_ms=cuda_time_ms(lambda: fq.quantize_activation_ref(x)),
                   library_ms=None)
        row["bound_ms"], row["bound_by"] = bound(m * d * 3 + m * d // 128 * 4,
                                                 6 * m * d, F32_FLOPS)
        extra.append(dict(kernel="quant_act", shape=[m, d], **row))
        if m == 8:
            results["quant_act"].update(row)

    # quant_weight on the largest stacked leaf the sync quantizes
    w = torch.empty((cfg.n_layers, d, f), dtype=torch.bfloat16, device=dev)
    w.normal_(generator=gen)
    row = dict(ms=cuda_time_ms(lambda: fq.quantize_weight_kernel(w), reps=3, warmup=1),
               plain_ms=cuda_time_ms(lambda: fq.quantize_weight_ref(w), reps=3, warmup=1),
               library_ms=None)
    row["bound_ms"], row["bound_by"] = bound(w.numel() * 3 + w.numel() // 16384 * 4,
                                             6 * w.numel(), F32_FLOPS)
    del w
    extra.append(dict(kernel="quant_weight", shape=[cfg.n_layers, d, f], **row))
    results["quant_weight"].update(row)

    # fp8_gemm on the real rollout weights: decode (M=8) and prefill (M=1024)
    mlp = roll["blocks"]["s0"]["mlp"]
    for m, name, wqt in ((8, "wg", mlp["wg"].layer(0)), (8, "wd", mlp["wd"].layer(0)),
                         (1024, "wg", mlp["wg"].layer(0))):
        k, n = wqt.data.shape
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        a, a_s = fq.quantize_activation_kernel(x)
        wq, w_s = wqt.data.contiguous(), wqt.scales.contiguous()
        lib = library_gemm(a, wq, a_s, w_s, fg.fp8_gemm_ref(a, wq, a_s, w_s).float())
        row = dict(ms=cuda_time_ms(lambda: fg.fp8_gemm(a, wq, a_s, w_s)),
                   plain_ms=cuda_time_ms(lambda: fg.fp8_gemm_ref(a, wq, a_s, w_s), reps=5),
                   library_ms=cuda_time_ms(lib) if lib is not None else None)
        nbytes = m * k + k * n + m * (k // 128) * 4 + (k // 128) * (n // 128) * 4 + m * n * 2
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * m * n * k, FP8_TC_FLOPS)
        extra.append(dict(kernel="fp8_gemm", shape=[m, k, n], weight=name, **row))
        if (m, name) == (8, "wg"):
            results["fp8_gemm"].update(row)

    # paged decode at the greedy run's final context lengths
    lengths = (traj.prompt_lengths + traj.response_lengths).to(torch.int32)
    q, kq, vq, ks, vs, tables, lengths, _ = decode_case(
        dev, gen, b=8, kvh=cfg.n_kv_heads, g=cfg.n_heads // cfg.n_kv_heads,
        d=cfg.d_head, bs=16, max_len=int(lengths.max()), lengths=lengths)
    row = dict(
        ms=cuda_time_ms(lambda: fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths)),
        plain_ms=cuda_time_ms(
            lambda: fa.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lengths)),
        library_ms=None)
    ctx = int(lengths.sum())
    kvh, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    nbytes = 2 * ctx * kvh * dh + 2 * 2 * 8 * kvh * g * dh + tables.numel() * 4 + 8 * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * ctx * kvh * g * dh, BF16_TC_FLOPS)
    extra.append(dict(kernel="paged_decode", shape=[8, kvh, g, dh], context=ctx, **row))
    results["paged_decode"].update(row)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")

    results = {name: dict(name=name, route="cuda", source=src, replaces=rep)
               for name, (src, rep) in KERNEL_SOURCES.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    compare_quantizers(dev, gen, results)
    torch.cuda.synchronize()
    compare_gemm(dev, gen, results)
    torch.cuda.synchronize()
    compare_decode(dev, gen, results)
    torch.cuda.synchronize()

    cfg = get_config("qwen3-8b")
    roll, traj = main_path(dev, results, cfg)
    torch.cuda.synchronize()
    extra = []
    time_kernels(dev, gen, results, cfg, roll, traj, extra)
    log("kernel_timings " + json.dumps(extra))
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"wall {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    print(json.dumps({"kernels": [{k: results[n][k] for k in keys} for n in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
