#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout's `src/`; imports nothing of
JAX or of the JAX package.  Phases, in order (any failure exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the five CUDA kernels from `src/repro_torch/csrc` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes: the quantizers bit-equal (FP32 scales; UE8M0
   mismatching tiles are counted and printed), fp8_gemm within one bf16
   rounding (rtol 2**-7), paged decode and chunked prefill within 1e-2
   (the CPU tests' band) plus the stale-entry proofs (NaN / 448 poison)
   and exact zeros for idle slots and dead chunk rows;
4. the rollout path on full-width, full-depth qwen3-8b with random
   weights from a seed: `sync_policy_weights(PrecisionConfig())`, then
   `generate` with 8 ragged prompts (64-128 tokens), 32 new tokens, page
   size 16 — greedy, then temperature 1 with GRPO groups of 4 over shared
   prefix blocks.  Launch counts are zeroed just before and read just
   after; every kernel of the path must have launched.  Outputs are
   checked (finite, in range); one decode step's and one prefill chunk's
   logits through the kernels are held against the plain versions on the
   same CUDA tensors; one decode step is profiled;
5. the serving path on the same synced weights: `ServingEngine` with
   kernel_config "all", chunked prefill (C 128), 8 slots, ondemand
   admission and a host tier, over 16 ragged prompts (96-640 tokens, four
   groups sharing a 256-token prefix), 32 greedy tokens each — once with
   a roomy KV budget and once with one tight enough to swap (counts zeroed
   before and read after the two runs; kernels 1, 3, 4 and 5 must have
   launched); completions must be bit-equal between the two, and between
   plain and speculative (n-gram, k 4) decoding of 8 of them; the forked
   copy-on-write recipe; the launcher `repro_torch.launch.serve.run`;
6. each kernel's time at the main paths' shapes beside its plain
   version's, one library call's where one computes the same function,
   and the bound (bytes over 3.35 TB/s or operations over the peak rate);
   engine tokens/s, ms per prefill chunk and per decode step, and one
   profiled engine decode step.

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
# 16-token chunk logits through the kernels vs the plain versions (W8A8 +
# FP8 KV, full depth): measured 0.308 on the H100 (the GEMM's sum order and
# `_deq` vs the plain path, amplified as at decode); held at 1.6x that
CHUNK_LOGIT_ATOL = 0.5
# the engine: `block_size` counts bf16-KV tokens, so an FP8 block holds 16
ENGINE_BLOCK_SIZE = 8
KV_BLOCK = 2 * ENGINE_BLOCK_SIZE
ENGINE_MAX_NEW = 32
ENGINE_MAX_SEQ = 640 + ENGINE_MAX_NEW
TIGHT_BUDGET_TOKENS = 2000     # 4 swap-outs in this trace's schedule
KERNEL_SOURCES = {
    "quant_act": ("src/repro_torch/csrc/fp8_quant.cu", "src/repro/kernels/fp8_quant.py:55"),
    "quant_weight": ("src/repro_torch/csrc/fp8_quant.cu", "src/repro/kernels/fp8_quant.py:90"),
    "fp8_gemm": ("src/repro_torch/csrc/fp8_gemm.cu", "src/repro/kernels/fp8_gemm.py:72"),
    "paged_decode": ("src/repro_torch/csrc/fp8_paged_decode.cu",
                     "src/repro/kernels/fp8_kv_attention.py:285"),
    "paged_prefill": ("src/repro_torch/csrc/fp8_paged_prefill.cu",
                      "src/repro/kernels/fp8_kv_attention.py:402"),
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


def prefill_case(dev, gen, start, lengths, c, kvh=8, g=4, d=128, bs=KV_BLOCK,
                 w=-(-ENGINE_MAX_SEQ // KV_BLOCK), fp8=True):
    """A chunk of C queries per slot over a paged pool whose table entries
    past each slot's live blocks point at one poison row (the last)."""
    import torch
    from repro_torch.core.precision import E4M3
    b = len(start)
    nrows = b * w + 1
    poison = nrows - 1
    k = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    v = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    if fp8:
        ks, vs = k.abs().amax() / 448, v.abs().amax() / 448
        kq, vq = (k / ks).clamp(-448, 448).to(E4M3), (v / vs).clamp(-448, 448).to(E4M3)
    else:
        ks = vs = torch.ones((), device=dev)
        kq, vq = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = torch.randn((b, c, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    start = torch.tensor(start, dtype=torch.int32, device=dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tables = torch.randperm(nrows - 1, generator=gen, device=dev)[: b * w].reshape(b, w)
    ctx = torch.minimum(start + c, lengths).long()
    live = ((ctx + bs - 1) // bs).clamp(1, w)
    dead = torch.arange(w, device=dev)[None, :] >= live[:, None]
    tables = torch.where(dead, poison, tables).to(torch.int32)
    return q, kq, vq, ks.float(), vs.float(), tables, start, lengths, poison


# (start, lengths) per slot: context % 16 in {0, 1, 15}; ragged chunks with
# one valid row, a full chunk, and 3 valid rows (the rest past `lengths`)
PREFILL_CASES = {
    (1, 128): ([512], [640]),
    (3, 128): ([255, 257, 508], [256, 385, 511]),
    (1, 5): ([284], [289]),
    (3, 5): ([255, 380, 508], [256, 385, 511]),
}


def compare_prefill(dev, gen, results):
    import torch
    from repro_torch.kernels import fp8_kv_attention as fa
    worst = 0.0
    for fp8 in (True, False):
        for (b, c), (start, lengths) in PREFILL_CASES.items():
            q, kq, vq, ks, vs, tables, st, ln, poison = prefill_case(
                dev, gen, start, lengths, c, fp8=fp8)
            out_k = fa.fp8_paged_prefill_attention(q, kq, vq, ks, vs, tables, st, ln)
            out_p = fa.fp8_paged_prefill_attention_ref(q, kq, vq, ks, vs, tables, st, ln)
            kn, vn = kq.clone(), vq.clone()
            kn[poison] = 448.0
            vn[poison] = 448.0
            out_n = fa.fp8_paged_prefill_attention(q, kn, vn, ks, vs, tables, st, ln)
            torch.cuda.synchronize()
            err = (out_k.float() - out_p.float()).abs().max().item()
            ok = torch.allclose(out_k.float(), out_p.float(), rtol=1e-2, atol=1e-2)
            dead = (st[:, None] + torch.arange(c, device=dev)[None, :]) >= ln[:, None]
            log(f"paged_prefill {'e4m3' if fp8 else 'bf16'} B={b} C={c} KVH=8 G=4 D=128 "
                f"BS={KV_BLOCK} start {start} lengths {lengths}: max|kernel-plain| "
                f"{err:.3e}, dead rows {int(dead.sum())} {'ok' if ok else 'FAIL'}")
            check(ok, f"paged prefill B={b} C={c} disagrees with its plain version")
            check(torch.equal(out_n.view(torch.int16), out_k.view(torch.int16)),
                  "a poisoned (448) stale table entry reached the paged-prefill output")
            check(bool((out_k[dead] == 0).all()), "a row past `lengths` is not exact zeros")
            worst = max(worst, err)
    log("paged_prefill: stale entries never read (448 poison), dead rows exact zeros")
    results["paged_prefill"]["max_abs_err"] = worst


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


def chunk_logits_check(model, roll, prec, prompts, lengths, dev):
    """One prefill chunk (16 tokens after each prompt, ragged valid rows)
    through the kernels vs the plain versions on the same CUDA tensors."""
    import copy

    import numpy as np
    import torch
    from repro_torch.data import tasks
    from repro_torch.kernels import ops
    c = 16
    cache = model.init_cache(len(prompts), prompts.shape[1] + c, prec, page_size=16)
    model.prefill(roll, {"tokens": torch.from_numpy(prompts).to(dev),
                         "lengths": torch.from_numpy(lengths).to(dev)}, cache, prec)
    chunk = np.stack([tasks.random_prompt(SEED + 50 + i, c + 1)[1:] for i in range(len(prompts))])
    n = np.array([16, 9, 1, 16, 5, 16, 12, 2])[:len(prompts)]
    locked = prec.replace(calculate_kv_scales=False)
    twin = copy.deepcopy(cache)
    lk, _ = model.prefill_chunk(roll, torch.from_numpy(chunk), lengths, n, cache, locked,
                                use_kernel=True, want_all_logits=True)
    with mock.patch.object(ops, "_route", lambda t, kernel, plain: plain):
        lp, _ = model.prefill_chunk(roll, torch.from_numpy(chunk), lengths, n, twin, locked,
                                    use_kernel=True, want_all_logits=True)
    torch.cuda.synchronize()
    keep = torch.from_numpy(np.arange(c)[None, :] < n[:, None]).to(dev)
    lk, lp = lk[keep], lp[keep]
    err = (lk - lp).abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * CHUNK_LOGIT_ATOL
    agree = bool((lk.argmax(-1) == lp.argmax(-1))[decisive].all())
    log(f"prefill-chunk logits kernel vs plain ({int(keep.sum())} rows): max abs err "
        f"{err:.4f}, mean {(lk - lp).abs().mean().item():.5f} (tol {CHUNK_LOGIT_ATOL}); "
        f"argmax equal on {int(decisive.sum())} decisive rows: {agree}")
    check(bool(torch.isfinite(lk).all()), "chunk logits not finite")
    check(err <= CHUNK_LOGIT_ATOL and agree, "chunk logits: kernels disagree with plain")
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
    for name in ("quant_act", "quant_weight", "fp8_gemm", "paged_decode"):
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
        results[name]["launches"] = launches[name]

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
    stats["chunk_logit_max_abs_err"] = chunk_logits_check(
        model, roll, prec, prompts, lengths, dev)
    stats.update(profile_decode_step(model, roll, prec, prompts, lengths, dev))
    log("main path: " + json.dumps(stats))
    return model, roll, t_greedy


# ---------------------------------------------------------------------------
# phase 5: the serving path
# ---------------------------------------------------------------------------

def engine_trace(seed=SEED, n=16, groups=4, prefix=256, lo=96, hi=640):
    """`n` prompts of seeded lengths in [lo, hi]; request i starts with the
    `prefix`-token head of group i % groups (a prompt shorter than the
    head is a prefix of it)."""
    import numpy as np
    from repro_torch.data import tasks
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    heads = [tasks.random_prompt(seed + 1000 + g, prefix) for g in range(groups)]
    return [np.concatenate([heads[i % groups], tasks.random_prompt(seed + 2000 + i, hi)[1:]])
            [: int(ln)] for i, ln in enumerate(lens)]


def make_engine(roll, cfg, prec, dev, budget_tokens=None, spec=None, slots=8):
    from repro_torch.serving import ServingEngine, kv_bytes_per_token
    per = kv_bytes_per_token(cfg, prec)
    eng = ServingEngine(
        roll, cfg, prec, max_slots=slots, max_seq_len=ENGINE_MAX_SEQ,
        kv_budget_bytes=None if budget_tokens is None else budget_tokens * per,
        block_size=ENGINE_BLOCK_SIZE, admission="ondemand", host_kv_blocks=64,
        prefill_chunk=128, kernel_config="all", eos_id=None, spec=spec, device=dev)
    check(eng.block_mgr.block_size == KV_BLOCK, "engine block size")
    return eng


def check_engine_report(eng, rep, n, tag):
    check(len(rep.completed) == n and not rep.stalled, f"{tag}: not every request completed")
    check(all(len(r.generated) == ENGINE_MAX_NEW for r in rep.completed),
          f"{tag}: a request stopped short")
    check(eng.block_mgr.blocks_in_use == 0, f"{tag}: blocks still in use")
    vocab = eng.cfg.vocab_size
    check(all(0 <= t < vocab for r in rep.completed for t in r.generated),
          f"{tag}: token out of range")
    log(f"engine {tag}: {len(rep.completed)} completed, steps {rep.steps}, prefill chunks "
        f"{rep.prefill_chunks}, prefix-hit blocks {rep.prefix_hit_blocks}, preemptions "
        f"{rep.preemptions} (swap-outs {rep.swap_outs}, wasted {rep.wasted_tokens}), "
        f"cow {rep.cow_copies}, spec steps {rep.spec_steps} (accepted {rep.accepted_tokens}), "
        f"peak blocks {rep.peak_blocks_in_use} of {eng.block_mgr.num_blocks}")


def _timed(fn, log_to):
    """`fn` between two synchronizes; appends (ms, chunk width or None)."""
    import torch

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        width = args[1].shape[1] if fn.__name__ == "prefill_chunk" else None
        log_to.append(((time.perf_counter() - t0) * 1e3, width))
        return out
    return wrapper


def _profile_step(eng):
    """One engine step under torch.profiler: (device busy ms, kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def engine_path(dev, results, cfg, roll):
    """Roomy and tight runs (the serving path whose launches are counted),
    then speculative decoding, the CoW fork and the launcher."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.serving import SpecConfig
    from repro_torch.serving.scheduler import Cow, Grow
    prec = PrecisionConfig()
    trace = engine_trace()
    stats = {"prompt_lengths": [len(p) for p in trace]}

    build.reset_launch_counts()
    # --- the serving path: a roomy run, then a tight one ------------------
    eng = make_engine(roll, cfg, prec, dev)
    for i, p in enumerate(trace):
        eng.submit(p, max_new=ENGINE_MAX_NEW, rid=i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    roomy = eng.run(max_steps=2000)
    torch.cuda.synchronize()
    stats["roomy_wall_s"] = time.perf_counter() - t0
    check_engine_report(eng, roomy, len(trace), "roomy")
    stats["roomy_tokens_per_s"] = roomy.emitted_tokens / stats["roomy_wall_s"]

    tight_eng = make_engine(roll, cfg, prec, dev, budget_tokens=TIGHT_BUDGET_TOKENS)
    calls, decode_walls, profiled = [], [], None
    tight_eng.model.prefill_chunk = _timed(tight_eng.model.prefill_chunk, calls)
    tight_eng.model.decode_step = _timed(tight_eng.model.decode_step, calls)
    for i, p in enumerate(trace):
        tight_eng.submit(p, max_new=ENGINE_MAX_NEW, rid=i)
    t0 = time.perf_counter()
    while tight_eng.queue or any(r is not None for r in tight_eng.slot_req):
        # after a pure decode step with nothing queued, the next step is one
        # fused decode too: profile one such step
        if profiled is None and len(decode_walls) >= 2 and not tight_eng.queue and all(
                r is None or r.prefilled >= len(r.prompt) for r in tight_eng.slot_req):
            profiled = _profile_step(tight_eng)
            continue
        ts = time.perf_counter()
        d = tight_eng.step()
        torch.cuda.synchronize()
        check(not d.is_empty, "tight run stalled")
        if d.decode_slots and all(isinstance(a, (Grow, Cow)) for a in d.actions):
            decode_walls.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    stats["tight_wall_s"] = time.perf_counter() - t0
    tight = tight_eng.run()
    launches = dict(build.LAUNCHES)
    # ----------------------------------------------------------------------
    check_engine_report(tight_eng, tight, len(trace), "tight")
    log(f"serving-path launches (roomy + tight runs): {launches}")
    for name in ("quant_act", "fp8_gemm", "paged_decode", "paged_prefill"):
        check(launches[name] > 0, f"kernel {name} was not launched on the serving path")
    results["paged_prefill"]["launches"] = launches["paged_prefill"]
    stats["serving_path_launches"] = launches
    check(roomy.preemptions == 0 and tight.preemptions >= 1,
          "the tight budget must preempt and the roomy one must not")
    for rep in (roomy, tight):
        check(rep.prefill_chunks > 0 and rep.prefix_hit_blocks > 0,
              "no prefill chunks or no prefix hits")
    done = {r.rid: r.generated for r in roomy.completed}
    check(done == {r.rid: r.generated for r in tight.completed},
          "greedy completions differ between the roomy and the tight run")
    log("engine: roomy and tight runs give bit-equal greedy completions")
    chunk_ms = [ms for ms, w in calls if w == 128]
    decode_ms = [ms for ms, w in calls if w is None]
    stats.update(
        engine_chunk128_ms_mean=statistics.mean(chunk_ms), engine_chunk128_calls=len(chunk_ms),
        engine_calibration_chunk_ms=[round(ms, 2) for ms, w in calls if w not in (None, 128)],
        engine_decode_step_model_ms_mean=statistics.mean(decode_ms),
        engine_decode_calls=len(decode_ms),
        engine_pure_decode_step_wall_ms_median=statistics.median(decode_walls),
        engine_pure_decode_steps=len(decode_walls),
        engine_emitted_tokens=roomy.emitted_tokens, engine_steps=roomy.steps)
    if profiled is not None:
        busy_ms, n_kernels = profiled
        stats.update(engine_decode_step_device_busy_ms=busy_ms,
                     engine_decode_step_kernels=n_kernels,
                     engine_decode_step_busy_share=busy_ms / statistics.median(decode_walls))
    del eng, tight_eng

    # --- speculative decoding of 8 requests: equal to plain greedy -------
    spec_eng = make_engine(roll, cfg, prec, dev, spec=SpecConfig(num_draft_tokens=4))
    for i, p in enumerate(trace[:8]):
        spec_eng.submit(p, max_new=ENGINE_MAX_NEW, rid=i)
    t0 = time.perf_counter()
    spec = spec_eng.run(max_steps=2000)
    torch.cuda.synchronize()
    stats["spec_wall_s"] = time.perf_counter() - t0
    check_engine_report(spec_eng, spec, 8, "spec k=4")
    check(spec.spec_steps > 0, "no speculative verify ran")
    check({r.rid: r.generated for r in spec.completed} == {i: done[i] for i in range(8)},
          "speculative greedy completions differ from plain greedy")
    log("engine: speculative greedy completions equal plain greedy")
    stats.update(spec_steps=spec.spec_steps, spec_accepted=spec.accepted_tokens,
                 spec_drafted=spec.draft_tokens)
    del spec_eng

    # --- copy-on-write: the forked-table recipe ---------------------------
    # no unforked trace makes the scheduler plan a CoW (a decode write lands
    # past the prompt's full blocks, the only shared ones); fork a running
    # request's whole table, partial tail block included, as GRPO does
    from repro_torch.serving.engine import Request
    fork_eng = make_engine(roll, cfg, prec, dev, slots=2)
    prompt = trace[5]                                  # 118 tokens: one chunk
    fork_eng.submit(prompt, max_new=ENGINE_MAX_NEW, rid=0)
    fork_eng._try_admit()
    twin = Request(rid=1, prompt=prompt, max_new=ENGINE_MAX_NEW,
                   prefilled=len(prompt), cached_tokens=len(prompt))
    fork_eng.block_mgr.fork(0, 1)
    slot = fork_eng._free_slot()
    fork_eng._set_table_row(slot, fork_eng.block_mgr.blocks_of(1))
    fork_eng._lengths[slot] = len(prompt)
    fork_eng.pending_tok[slot] = fork_eng.pending_tok[0]
    twin.generated = [int(fork_eng.pending_tok[0])]
    fork_eng.slot_req[slot] = twin
    fork = fork_eng.run(max_steps=200)
    check_engine_report(fork_eng, fork, 2, "fork")
    check(fork.cow_copies >= 1, "the fork made no copy-on-write")
    got = {r.rid: r.generated for r in fork.completed}
    check(got[0] == got[1], "forked request diverged from its donor")
    log(f"engine: forked table copy-on-write ({fork.cow_copies} copies), fork equals donor")
    del fork_eng

    # --- the launcher, as a user runs it -----------------------------------
    from repro_torch.launch import serve
    out = serve.run(["--kernel-config", "all", "--prefill-chunk", "16"])
    log("launch.serve report: " + json.dumps(out))
    check(out["completed"] == 16 and not out["stalled"], "launcher run incomplete")
    stats["launcher"] = {k: out[k] for k in ("completed", "steps", "prefill_chunks",
                                             "emitted_tokens", "serve_wall_s", "sync_ms")}
    log("serving path: " + json.dumps(stats))
    return stats


# ---------------------------------------------------------------------------
# phase 6: times at the main paths' shapes
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

    # chunked prefill at the engine's chunk (C 128, 640 tokens of context)
    # and at the speculative verify chunk (C 5)
    for c, start, length in ((128, 512, 640), (5, 295, 300)):
        q, kq, vq, ks, vs, tables, st, ln, _ = prefill_case(
            dev, gen, [start], [length], c, kvh=kvh, g=g, d=dh)
        args = (q, kq, vq, ks, vs, tables, st, ln)
        lib = sdpa_yardstick(*args)
        row = dict(ms=cuda_time_ms(lambda: fa.fp8_paged_prefill_attention(*args)),
                   plain_ms=cuda_time_ms(lambda: fa.fp8_paged_prefill_attention_ref(*args)),
                   library_ms=cuda_time_ms(lib))
        keys = sum(p + 1 for p in range(start, min(start + c, length)))   # causal
        live = -(-min(start + c, length) // KV_BLOCK) * KV_BLOCK
        nbytes = 2 * live * kvh * dh + 2 * 2 * c * kvh * g * dh + tables.numel() * 4 + 8
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * keys * kvh * g * dh,
                                                 BF16_TC_FLOPS)
        extra.append(dict(kernel="paged_prefill", shape=[1, c, kvh, g, dh], start=start,
                          lengths=length, library="scaled_dot_product_attention on a "
                          "pre-gathered, pre-dequantized bf16 copy (gather excluded)", **row))
        if c == 128:
            results["paged_prefill"].update(row)


def sdpa_yardstick(q, kq, vq, ks, vs, tables, st, ln):
    """`F.scaled_dot_product_attention` over the chunk's live K/V, gathered
    and dequantized beforehand (bf16, K/V repeated over the G heads of a
    group), with the same causal mask: the gather is not timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fp8_kv_attention as fa
    b, c, kvh, g, d = q.shape
    ctx = torch.minimum(st + c, ln)
    kf, vf = fa._live_kv(kq, vq, ks, vs, tables, ctx)
    s_len = -(-int(ctx.max()) // KV_BLOCK) * KV_BLOCK
    kb = kf[:, :s_len].to(torch.bfloat16).permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vb = vf[:, :s_len].to(torch.bfloat16).permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    qb = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, c, d)
    q_pos = st.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    k_pos = torch.arange(s_len, device=q.device)
    mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (q_pos < ln.long()[:, None])[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)


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
    log(f"kernel build ({len(build._sources())} sources in parallel): "
        f"{time.perf_counter() - t0:.1f} s")

    results = {name: dict(name=name, route="cuda", source=src, replaces=rep)
               for name, (src, rep) in KERNEL_SOURCES.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    compare_quantizers(dev, gen, results)
    torch.cuda.synchronize()
    compare_gemm(dev, gen, results)
    torch.cuda.synchronize()
    compare_decode(dev, gen, results)
    torch.cuda.synchronize()
    compare_prefill(dev, gen, results)
    torch.cuda.synchronize()

    cfg = get_config("qwen3-8b")
    model, roll, traj = main_path(dev, results, cfg)
    torch.cuda.synchronize()
    engine_path(dev, results, cfg, roll)
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
