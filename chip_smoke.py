#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout's `src/`; imports nothing of
JAX or of the JAX package.  Phases (any failure exits non-zero), run in
the order 1-5, 7, 6, 8-15:

1. the card's name and power limit (nvidia-smi);
2. build the six CUDA kernels from `src/repro_torch/csrc` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes: the quantizers bit-equal (kernel 1 at M 1-16384
   and K 4096 or 12288, and with f32 input, E5M2 and UE8M0 at one shape
   each; kernel 2 K-major with FP32 scales, its UE8M0 mismatching tiles
   counted and printed), fp8_gemm within one bf16
   rounding (rtol 2**-7) at qwen3-8b's four (K, N) and M 1, 8, 32, 128,
   1024, its rows bit-equal across M and batches, paged decode, chunked
   prefill and contiguous
   decode within 1e-2 (the CPU tests' band) plus the stale-entry proofs
   (NaN / 448 poison in stale table entries and past each length) and
   exact zeros for idle slots and rows and dead chunk rows; paged decode
   and prefill also at the fleet's block size 4 (pages of 8 E4M3 or 4
   bf16 tokens, 64 positions a slot, tables in random and in pool order);
4. the rollout path on full-width, full-depth qwen3-8b with random
   weights from a seed: `sync_policy_weights(PrecisionConfig())`, then
   `generate` with 8 ragged prompts (64-128 tokens), 32 new tokens, page
   size 16 — greedy, then temperature 1 with GRPO groups of 4 over shared
   prefix blocks.  Launch counts are zeroed just before and read just
   after; every kernel of the path must have launched, and on every path
   kernel 1 exactly 4 times for 7 of kernel 3 (one quantization per
   distinct linear input).  Outputs are
   checked (finite, in range); one decode step's and one prefill chunk's
   logits through the kernels are held against the plain versions on the
   same CUDA tensors; one decode step is profiled (kernel 1's share of
   it logged); then one greedy
   `generate` under BF16_ROLLOUT on the same prompts (the paper's
   baseline: tokens/s and decode ms/step beside the FP8 run's);
5. the serving path on the same synced weights: `ServingEngine` with
   kernel_config "all", chunked prefill (C 128), 8 slots, ondemand
   admission and a host tier, over 16 ragged prompts (96-640 tokens, four
   groups sharing a 256-token prefix), 32 greedy tokens each — once with
   a roomy KV budget and once with one tight enough to swap (counts zeroed
   before and read after the two runs; kernels 1, 3, 4 and 5 must have
   launched); completions must be bit-equal between the two, and between
   plain and speculative (n-gram, k 4) decoding of 8 of them; one fused
   decode step and one 128-token chunk of the tight run profiled (device
   busy ms; kernel 5's share of the chunk); the forked copy-on-write
   recipe; the launcher `repro_torch.launch.serve.run`;
6. each kernel's time at the main paths' shapes beside its plain
   version's, one library call's where one computes the same function,
   and the bound (bytes over 3.35 TB/s or operations over the peak rate):
   `ms` from CUDA events around back-to-back wrapper calls (host work
   between launches included) and `device_ms` from CUDA events around
   calls queued behind a spin kernel (the kernels alone, back to back),
   for the kernel and its library call;
   quant_act at (8, 4096), (1024, 4096) and (16384, 4096), with the host
   microseconds of one `ops.quantize_activation` call, and kernel 1 +
   kernel 3 as a linear calls them (M 8, the four (K, N), cold weights);
   fp8_gemm at the four (K, N) and M 1, 8, 32, 128, 1024, each call on
   the next of the 36 layers' weights (cold in L2), beside two other
   functions (`torch._scaled_mm` with per-tensor scales, cuBLAS bf16),
   and what kernel 2's K-major store adds to the sync;
   kernel 6's ring geometry on one line;
   kernel 5 at the engine's chunk (C 128 at 640 tokens; the kernels line
   keeps this row), the verify chunk (C 5), the first chunk (128 tokens)
   and a 4096-token context, with the paged body's rows per block and key
   tile;
   engine tokens/s, ms per prefill chunk and per decode step, and one
   profiled engine decode step.  It runs last, after 7 has freed its
   38.7 GB cache; kernel 6's LONG_500K row is taken in 7c on that cache;
7. the contiguous-cache path (`launch.steps`, kernel 6) on the same synced
   weights, launch counts zeroed before and read after each of:
   a. `make_prefill_step` at (B 8, S 1056) over 8 seeded prompts of
      512-1024 tokens, then 32 greedy `serve_step`s: kernel 6 launched
      36 x 32 times; first decode-step logits within 0.5 of the paged
      path's and greedy tokens equal to paged `generate`'s on decisive
      steps; one serve step through the kernels vs the plain versions;
   b. one 16384-token prompt (half of PREFILL_32K's 32768) prefilled under
      `attention_impl("chunked")`, then 16 serve steps at 16K context;
   c. the LONG_500K decode cell: a B 1, S 524288 cache of E4M3 (38.7 GB)
      built from `cache_specs` and filled from a seeded generator, lengths
      524284, 4 serve steps, the last one profiled (kernel 6, the fp8
      linears and the lm_head GEMM beside its byte bound); kernel 6 vs its
      plain version on one layer; peak memory beside the bf16 cache's
      77.3 GB.

8. the RL trainer (`rl.RLTrainer`) on full-width, full-depth qwen3-8b
   over the main path's bf16 weights (drawn again from seed 0), under
   `PrecisionConfig()` with TIS at C 2, B 8 prompts x 4 samples, 32 new
   tokens, AdamW with fp8 moments: 3 `train_step`s (launch counts zeroed
   before and read after: kernels 1-4, kernel 1 4/7 of kernel 3, kernel 2
   7 per sync; finite metrics), then the same prompts rolled out under
   `PrecisionConfig()` and `BF16_ROLLOUT` and scored by the policy
   (mismatch KL, TIS weight mean and ESS), then one update with
   advantages drawn per GRPO group on the last step's trajectory: finite
   stats, grad_norm > 0, every leaf's moment non-zero, every leaf but the
   norm scales changed (lr 3e-4 is under half a bf16 ulp of 1.0), a
   re-sync's fp8 payloads changed in all 7 quantized leaves, the batch's
   loss before and after; peak memory under 80 GB.  Printed: sync,
   rollout, scoring + backward and optimizer ms, step wall, tokens/s.

9. the serving fleet (`serving.ServingFrontend`) on full qwen3-8b, each
   part after `gc.collect()` with its own peak:
   a. phase 8's trainer with `rollout_backend="fleet"` (2 replicas of 8
      slots, block size 4): 3 train steps (launch counts zeroed before
      and read after: kernel 2 7 a push, kernel 1 4/7 of kernel 3),
      versions 1-3 on the syncer and every replica, finite metrics with
      the per-version rows, what stayed resident under one weight version
      + the KV pools, one nonzero-advantage update on the versioned
      batch, peak under 80 GB; printed beside phase 8 per step;
   b. `launch.serve.run --replicas 2 --update-every 4 --prefill-chunk 128`
      over the launcher's 16 prompts, greedy, its event log written under
      `build/`: kernels 1-5 launched, kernel 2 7 a sync, every token's
      version the one installed on its replica at its step, and a
      request spanning versions;
   c. the same prompts, no pushes, W8A8 linears over a bf16 cache:
      fault-free, replica 0 crashing for good at its step 2, replica 1
      crashing at its step 3 and rejoining at the fleet's version, and a
      `StepTracer` on every replica: greedy completions bit-equal to the
      fault-free fleet's, every token delivered once, failover replaying
      tokens, the traced run's event sums equal to each step's
      accounting; then fault-free and crash once more under
      `PrecisionConfig()` (each replica calibrates its own KV scales),
      logged, not held.

10. full FP8 on full qwen3-8b, each part after `gc.collect()` with its
    own peak:
    a. `launch.train.build_trainer` under `--precision fp8`
       (FULL_FP8_ROLLOUT, the reference's default) with phase 8's B,
       lengths and `--fp8-moments`: 3 train steps (launch counts zeroed
       before and read after: kernel 2 7 a sync, kernel 1 4/7 of kernel
       3, kernel 4 never: `generate` takes the plain QDQ attention); then
       the same prompts rolled out under FULL_FP8_ROLLOUT,
       `PrecisionConfig()` (kernel 4 launched once a layer and decode
       step) and BF16_ROLLOUT and scored by the policy (mismatch KL, TIS
       ESS);
    b. one `--precision e2e-fp8` step from the same seed, equal to a's
       first (the scoring pass takes no precision);
    c. one train step with the fleet backend under FULL_FP8_ROLLOUT: no
       kernel 4 or 5 (the replicas resolve to the QDQ branch);
    d. `fp8_dot` forward and backward at (1408, 4096) @ (4096, 12288)
       under both recipes against the plain CPU computation (quantized
       payloads bit-equal, outputs within one bf16 rounding + 1e-3 x
       max), and its card time beside the bf16 `_dot`'s.

11. breadth: llama3.2-3b, stablelm-3b and starcoder2-15b at full width
    and depth, one after the other after `gc.collect()` (what it frees
    is logged): random weights from a seeded generator, a sync (kernel 2
    once per quantized leaf), a greedy `generate` (8 prompts, 32
    tokens), a `ServingEngine(kernel_config="all", prefill_chunk=128)`
    run of 8 requests, a `launch.steps` prefill at (B 8, S 1056) and 4
    serve steps, each with its launches counted (kernel 1 4/7 of kernel
    3, 4/6 for starcoder2's two-matrix MLP); decode-step logits through
    the kernels within 0.5 of the plain versions; kernels 4, 5 and 6 at
    the model's (KVH, G, D) within 1e-2 of their plain versions; the
    peak under 80 GB.

12. MoE at full width and depth, each part after `gc.collect()`:
    a. qwen3-30b-a3b (48 layers, d 2048, 32/4 heads, 128 experts top-8,
       d_ff 768) under `PrecisionConfig()`: random weights drawn and
       synced leaf by leaf (each bf16 leaf quantized and dropped before
       the next is drawn: the bf16 tree and its fp8 copy do not fit one
       card together; kernel 2 once per quantized leaf, fc1's sync timed),
       a greedy `generate` with the routing recorded and a GRPO one
       (groups of 4), launch counts zeroed before and read after (kernel
       1 4/6 of kernel 3, the expert-batched kernel 3 twice per MoE layer
       and forward), the prefill's capacity drops reported, one decode
       step profiled, then phase 11's paths (decode-step logits through
       the kernels within 0.5 of the plain versions, an engine run of 8
       requests, `launch.steps` at (B 8, S 1056) and 4 serve steps), and
       the expert-batched kernel 3 at E 128 on fc1 and fc2 at M 8 and 128
       an expert: every expert bit-equal to the 2-D kernel, within one
       bf16 rounding of the plain version, timed on cold weights (48
       layers rotated) beside its byte bound; the peak under 80 GB.  Drops
       depend on grouping at capacity factor 1.25, so no engine invariant
       of phase 5 is asserted here;
    b. `RLTrainer` on granite-moe-3b-a800m (32 layers, d 1536, 24/8 heads,
       D 64, 40 experts top-8) at phase 8's geometry under
       `PrecisionConfig(rollout_router_replay=True)` with f32 AdamW
       moments: 3 train steps (routing recorded each step, finite
       `moe_aux_loss`, kernel 2 6 a sync, kernel 1 4/6 of kernel 3), the
       same prompts rolled out under router BF16, FP32 and FP8 and under
       BF16_ROLLOUT and scored side by side (k3, TIS ESS: the paper's
       fig. 6 comparison, reported), kernels 4-6 at (G 3, D 64) within
       1e-2; the peak under 80 GB.

13. SSM and hybrid, each part after `gc.collect()` with its own peak:
    a. mamba2-780m (48 layers, d 1536, d_inner 3072, 48 heads of 64,
       state 128, conv 4, vocab 50280, no attention) at full width and
       depth under `PrecisionConfig()`, whose kernel config resolves to
       "off": random weights from seed 0, a sync (kernel 2 twice: w_in,
       w_out), greedy and GRPO `generate` (8 x 64-128 tokens, 32 new;
       launch counts zeroed before and read after: kernel 1 : kernel 3 =
       1 : 1, twice a layer and forward) and greedy under BF16_ROLLOUT,
       decode-step logits through the kernels within 0.5 of the plain
       versions, one decode step profiled, a chunked prefill (C 128)
       against the one-shot one (the first layer's state within 1e-3,
       next-token logits within 0.5), the
       engine over 16 of phase 5's prompts (C 128, 8 slots) roomy and
       with its budget cut to 60% after 8 decode steps (bit-equal
       completions, at least one swap-in of SSM state), `launch.steps`
       (B 8 x 512-1024 + 4 serve steps, a 16384-token prefill + 4 steps,
       LONG_500K's 4 serve steps on the O(1) state), kernel 3 at w_in
       (K 1536, N 6448, stored at 6528) and w_out (3072 -> 1536) held
       against plain and timed at M 8 and 128 beside the byte bound,
       then 3 `RLTrainer` steps with f32 moments (kernel 2 twice a sync),
       the same prompts rolled out under W8A8 and BF16_ROLLOUT and scored
       by the policy, and one nonzero-advantage update (every leaf's
       moment non-zero);
    b. jamba-1.5-large-398b, one period (8 of 72 layers; d 8192, 64/8
       heads of 128, d_inner 16384, 128 SSM heads of 128, 16 experts
       top-2, d_ff 24576, vocab 65536): synced leaf by leaf (kernel 2 38
       times), a greedy `generate` (kernel 1 : kernel 3 = 32 : 38, kernel
       4 once a decode step), decode-step logits through the kernels
       against plain logged, not held (last-bit differences flip top-2
       routings of the random routers, and the SSM state carries the
       flips; for the same reason no chunked-vs-one-shot check),
       the engine over 4 prompts (2 slots, 32 new) roomy and under the
       cut (bit-equal), a `launch.steps` prefill (B 8, S 1056) and 4 serve
       steps (kernel 6 once a step), the expert-batched kernel 3 at E 16
       (fc1, fc2, M 8) bit-equal per expert to the 2-D kernel and timed,
       kernels 4-6 at (G 8, D 128) within 1e-2; the peak under 80 GB.
14. Enc-dec and VLM at full width and depth, `PrecisionConfig()`:
    a. seamless-m4t-medium (12 + 12 layers, d 1024, 16 heads of 64, a
       two-matrix relu MLP, vocab 256206): the sync (kernel 2 17 times:
       the decoder's, the cross attention's and the encoder's leaves and
       w_patch), greedy and GRPO `generate` over 8 prompts with 256-1024
       frames each (kernel 1 and kernel 3 counted exactly: a prefill 133
       : 193 with the encoder, a decode step 72 : 96), greedy under
       BF16_ROLLOUT, decode-step logits through the kernels against
       plain (within 0.5), the engine (8 slots, `max_src_len` 1024, 16
       requests, two of them one prompt with other frames, which must
       decode otherwise) roomy and under the budget cut (bit-equal, the
       victims' cross KV swapped out and back), `launch.serve.run --arch
       seamless-m4t-medium`, `launch.steps` (a B 8 prefill over S 1056
       with frames of S, 32 serve steps, kernel 6 once a layer and step;
       LONG_500K is not run: the reference sizes the cross cache and the
       encoder's attention at S), kernels 4-6 at (G 1, D 64) within 1e-2
       and kernels 4 and 6 timed there;
    b. pixtral-12b (40 layers, d 5120, 32/8 heads of 128, d_ff 14336,
       vocab 131072, 1024 patches): the sync (8 leaves), greedy `generate`
       over 8 prompts of 64-128 text tokens after 1024 patches at page
       size 16 (the block table counts the prefix: no write falls past
       it), decode-step logits through the kernels against plain (each
       layer's input forced, within 0.5; the free-running gap logged), the
       prefill's last logits against `forward_train`'s (causal
       against prefix-LM over the patches: logged), `launch.steps` (B 8,
       S 2048 with 1024 patches, 16 serve steps), kernel 3 at w_patch (M
       8192) and wg (M 8) held and timed; the peak under 80 GB.
15. The distributed runtime: kernel 1 on one (1, n) f32 row, the row
    `compressed_psum` quantizes, bit-equal to plain at qwen3-8b's wq
    (16.8M) and wg (50.3M) gradient sizes and at an odd n padded to 128,
    and timed beside its byte bound; then DIST_RANKS spawned ranks on
    cuda:0 joined by gloo (one card runs several ranks only over gloo;
    `distributed.host_collectives` copies each collective's operands
    through the host and counts them), each reporting back:
    a. `compressed_psum` of each rank's seeded wq and wg gradients, bf16
       and f32: equal on every rank, bit-equal to one process summing
       the four contributions quantized by the plain version, within 0.03
       of the exact sum, kernel 1 once a call a rank; ms a call and the
       bytes gathered against `comm_bytes` logged;
    b. llama3.2-3b at full width (2 of 28 layers, the only cut), f32
       params and moments, a (2, 2) data x model mesh with ZeRO-3, B 8 x
       256, 3 steps: the first run as `make_train_step` runs it
       (`make_loss_and_grads`, then `adamw.update`) and held against the
       same in one process (loss within 1e-5 relative, each rank's
       gradient shards within 1e-4 of max|g|), an all-gather and a
       reduction among its collectives (`CommDebugMode`), the others
       `make_train_step`'s; each rank's resident param + moment bytes
       under 0.3 of one process's; the losses and walls logged; then one
       update with fp8 moments of the same params sharded and in one
       process: each rank's moment payload and scale bytes equal to the
       one-process moments' same slices, its param shards equal;
    c. `pipeline_apply` over 4 stages, each one full-width qwen3-8b
       decoder layer (bf16, the training layer body), each rank holding
       only its own stage's slice (`shard_stages`), 8 microbatches of
       (1, 128, 4096): bit-equal to the layers in sequence in one
       process, the wall and `bubble_fraction(4, 8)` logged;
    d. llama3.2-3b at full width (2 of 28 layers) under
       `PrecisionConfig()`: the sharded W8A8 `make_prefill_step` (B 8 x
       256) and 4 `make_serve_step` calls on the (2, 2) mesh with ZeRO-3,
       kernels 1 and 3 on each rank's shards and kernel 6 over its local
       KV heads: logits within LOGIT_ATOL of one process's, the decisive
       argmax equal, kernel 1, 3 and 6 launches counted exactly on each
       rank.
    Phase 15 must end within DIST_PHASE_S (150 s).
16. The roofline (`roofline.analysis.count_step`, the H100's peaks): a
    7a serve step and a 7c LONG_500K step were counted in phase 7, each
    on its own beside the step the profiler times; each step's roofline
    bound must not exceed the profiled step's device-busy time (the ratio
    is logged).  Then one dry-run cell
    (`launch.dryrun`, llama3.2-3b decode_32k on the single-pod mesh, a
    fake process group of 256 ranks, meta DTensors) in a subprocess: its
    record's status ok.

The line before the last is the `kernels` JSON object; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
FP8_TC_FLOPS = 1979e12             # dense fp8 tensor cores
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12                  # f32 outside the tensor cores
# at least the SM clock (1.98 GHz at most): a spin of n cycles lasts
# n / SPIN_HZ seconds or more
SPIN_HZ = 2.0e9
# `device_time_ms` lengthens its spin this many times before it fails
SPIN_TRIES = 4
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
# the fleet's engines (phase 9, `RLConfig.fleet_block_size`, the
# launcher's default): block size 4 in bf16-KV tokens, 64 positions a slot
FLEET_BLOCK_SIZE = 4
FLEET_MAX_SEQ = 64
FLEET_MAX_NEW = 24
# (start, lengths, C): the fleet's first chunks (short prompts in a
# 128-wide chunk) and a forced-prefix replay starting past a block edge
FLEET_PREFILL_CASES = (([0, 0, 0], [5, 7, 40], 128), ([8, 13], [21, 44], 16))
KERNEL_SOURCES = {
    "quant_act": ("src/repro_torch/csrc/fp8_quant.cu", "src/repro/kernels/fp8_quant.py:55"),
    "quant_weight": ("src/repro_torch/csrc/fp8_quant.cu", "src/repro/kernels/fp8_quant.py:90"),
    "fp8_gemm": ("src/repro_torch/csrc/fp8_gemm.cu", "src/repro/kernels/fp8_gemm.py:72"),
    # kernel 3's expert-batched launch (the reference vmaps the GEMM over
    # an MoE layer's experts)
    "fp8_gemm_batched": ("src/repro_torch/csrc/fp8_gemm.cu",
                         "src/repro/kernels/fp8_gemm.py:72"),
    "paged_decode": ("src/repro_torch/csrc/fp8_paged_decode.cu",
                     "src/repro/kernels/fp8_kv_attention.py:285"),
    "paged_prefill": ("src/repro_torch/csrc/fp8_paged_prefill.cu",
                      "src/repro/kernels/fp8_kv_attention.py:402"),
    "decode": ("src/repro_torch/csrc/fp8_decode.cu",
               "src/repro/kernels/fp8_kv_attention.py:169"),
}
# kernel 3 at the four (K, N) of qwen3-8b's linears (wv is wk's, wo wq's,
# wu wg's), keyed by the leaf timed on the rollout weights, and at the M
# the paths run: LONG_500K, decode, GRPO decode, the engine's spec verify
# (k 4, up to 8 slots), its chunk, the `generate` prefill
GEMM_SHAPES = {("attn", "wq"): (4096, 4096), ("attn", "wk"): (4096, 1024),
               ("mlp", "wg"): (4096, 12288), ("mlp", "wd"): (12288, 4096)}
GEMM_MS = (1, 8, 32, 40, 128, 1024)
# kernel 1 held bit-equal to its plain version: M 1-16384 at K 4096 (the
# paths' decode, verify, chunk and prefill rows; 3 and 129 are ragged),
# M 8 at K 12288 (wd's input), and f32 input, E5M2 and UE8M0 at one shape
# each: ((M, K), input dtype, fp8 dtype, scale format)
QUANT_ACT_HOLDS = (
    [((m, 4096), "bfloat16", "E4M3", "FP32") for m in (1, 3, 8, 40, 129, 1024, 16384)]
    + [((8, 12288), "bfloat16", "E4M3", "FP32"), ((129, 4096), "float32", "E4M3", "FP32"),
       ((40, 4096), "bfloat16", "E5M2", "FP32"), ((1024, 4096), "bfloat16", "E4M3", "UE8M0")])
# phase 6: kernel 1's timed shapes (decode, `generate`'s prefill, 7b's
# 16K prefill) and the M of the kernel 1 + kernel 3 pair rows
QUANT_ACT_MS = (8, 1024, 16384)
PAIR_M = 8
# phase 7: kernel 6 at 7a's shape, and the chunked-attention prefill of 7b
CONTIG_SHAPE = ("smoke_prefill", 1056, 8, "prefill")
CONTIG_STEPS = 32
LONG_PROMPT = 16384            # half of PREFILL_32K's 32768
LONG_STEPS = 16
LONG_500K_LENGTH = 524284
LONG_500K_STEPS = 4
# kernel 6 vs its plain version: within DECODE_TOL elementwise (rtol and
# atol) and within DECODE_TOL x the output's largest magnitude.  The second
# bound keeps a long flat softmax honest: unit q over 524288 unit keys
# averages V into outputs of ~1e-2, all inside the absolute bound.  Each
# shape is also held at q x PEAKED_Q (scores ~ N(0, 16)), where a few keys
# carry the softmax and the output is O(1), so a wrong split weight shows.
DECODE_TOL = 1e-2
PEAKED_Q = 4.0
# 7a: contiguous vs paged, and kernels vs plain, were measured at most
# 0.328 apart in a decode step's logits on the H100.  No such difference
# can flip a top-2 gap over twice that (rounded up): there the two paths
# must pick the same token
DECISIVE_GAP = 0.7
# phase 8: the RL trainer's train steps; a dense layer's 7 quantized leaves
# take one kernel-2 launch each per weight sync
TRAIN_STEPS = 3
SYNC_LEAVES = 7
CARD_BYTES = 80e9
# phase 10d: fp8_dot at qwen3-8b's wg with the scoring pass's rows (B 32 x
# 44 tokens); y, dx and dw within one bf16 rounding (2**-7 relative) plus
# this share of the output's largest magnitude, for sums near zero whose
# f32 order differs between the card's GEMM and the CPU's
FP8_DOT_SHAPE = (1408, 4096, 12288)
FP8_DOT_ATOL = 1e-3
# phase 11: the dense registry at full width and depth (mistral-large-123b,
# 123B parameters, does not fit one card), and its serve steps at ~1K
BREADTH = ("llama3.2-3b", "stablelm-3b", "starcoder2-15b")
BREADTH_STEPS = 4
# phase 12: MoE at full width and depth — the paper's MoE model serves,
# granite-moe trains (30.5B parameters with grads and moments do not fit
# one card); the expert-batched kernel 3 is held and timed at the M of a
# B-8 decode (8 rows an expert) and of a 128-token engine chunk (8 rows
# of capacity 16)
MOE_SERVE = "qwen3-30b-a3b"
MOE_TRAIN = "granite-moe-3b-a800m"
MOE_GEMM_MS = (8, 128)
# phase 13: SSM and hybrid at full width — mamba2-780m at full depth, one
# period (8 of 72 layers) of jamba-1.5-large-398b; an engine's budget cut to
# SHRINK_FRAC after SHRINK_AT decode steps forces its swaps.  The
# attention-free engine has no KV: its block is a 64 KiB accounting unit
# of slot state (at 8 bytes its allocator would list ~76M blocks)
SSM_SERVE = "mamba2-780m"
HYBRID = "jamba-1.5-large-398b"
SSM_GEMM_MS = (8, 128)
SSM_ENGINE_BLOCK = 1 << 16
SHRINK_AT = 8
SHRINK_FRAC = 0.6
# 13b's decode step with each layer's input forced to the kernel step's:
# a layer's update (output less input) through the kernels vs the plain
# versions, over its largest entry (set before its first reading; kernel
# 3 alone is held within 2**-7)
FORCED_LAYER_RTOL = 5e-2
# phase 14: enc-dec and VLM at full width and depth.  Seamless requests
# carry ENCDEC_FRAMES frames (padded to ENCDEC_SRC, the engine's
# max_src_len); pixtral's rollout pages its 1024-patch prefix at
# VLM_PAGE, its `launch.steps` cell is VLM_STEPS_S positions (1024 of them
# patches) and VLM_STEPS serve steps (its cache holds S + 1), and kernel 3
# is timed at w_patch over a B-8 prefill's patch rows
ENCDEC = "seamless-m4t-medium"
VLM = "pixtral-12b"
ENCDEC_FRAMES = (256, 1024)
ENCDEC_SRC = 1024
VLM_PAGE = 16
VLM_STEPS_S = 2048
VLM_STEPS = 16
VLM_PATCH_M = 8 * 1024
# phase 15: the distributed runtime.  Ranks on one card join a gloo group;
# 15a sums qwen3-8b's wq and wg gradients compressed, 15b trains two of
# llama3.2-3b's layers at full width on a (2, 2) mesh, 15c pipelines four
# qwen3-8b layers; kernel 1 is held on one long f32 row at each leaf's n
# and at an odd n
DIST_RANKS = 4
DIST_TIMEOUT_S = 150
DIST_PHASE_S = 150
DIST_GRAD_LEAVES = (("wq", (4096, 4096)), ("wg", (4096, 12288)))
DIST_SUM_REPS = 2
DIST_ROWS = (4096 * 4096, 4096 * 12288, 4 * 333)
DIST_TRAIN = "llama3.2-3b"
DIST_TRAIN_LAYERS = 2
DIST_TRAIN_BT = (8, 256)
DIST_STEPS = 3
DIST_PIPE_M = 8
DIST_PIPE_T = 128
# 15d: the sharded W8A8 prefill + DIST_SERVE_STEPS serve steps of
# llama3.2-3b at full width, DIST_SERVE_LAYERS of its layers
DIST_SERVE = "llama3.2-3b"
DIST_SERVE_LAYERS = 2
DIST_SERVE_BT = (8, 256)
DIST_SERVE_STEPS = 4
# phase 16: `roofline.analysis.count_step` over a 7a and a 7c serve step
# (stashed here by phase 7) and one dry-run cell in a subprocess
ROOFLINE_COUNTS = {}
DRYRUN_CELL = ("llama3.2-3b", "decode_32k", "single")
DRYRUN_TIMEOUT_S = 300


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


def device_time_ms(fn, reps=20, warmup=3):
    """Mean device time of `fn()` over `reps` back-to-back calls, with the
    host's time between launches hidden: a spin kernel holds the stream
    while the calls are enqueued behind it, so the CUDA events around
    them see the kernels run back to back (as a replayed graph would).
    Unlike `cuda_time_ms`, a call shorter than its wrapper's host work is
    not timed at the host's pace."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin_s = 1e-3
    for _ in range(SPIN_TRIES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue_s < spin_s / 2:       # the queue never ran dry
            return start.elapsed_time(end) / reps
        spin_s = 4 * enqueue_s
    check(False, f"device_time_ms: enqueuing {reps} calls took {enqueue_s * 1e3:.1f} ms, "
                 f"more than half the spin before them, {SPIN_TRIES} times (does a call "
                 "wait for the card?)")


def timed_row(fn, plain, library=None, reps=20, plain_reps=20, plain_warmup=3):
    """A phase-6 row's times: `ms` (CUDA events around back-to-back
    wrapper calls, host work included), `device_ms` (the kernels alone,
    `device_time_ms`), `plain_ms`, and `library_ms` with its
    `library_device_ms` (None without a library call)."""
    row = dict(ms=cuda_time_ms(fn, reps=reps), device_ms=device_time_ms(fn, reps=reps),
               plain_ms=cuda_time_ms(plain, reps=plain_reps, warmup=plain_warmup),
               library_ms=None, library_device_ms=None)
    if library is not None:
        row.update(library_ms=cuda_time_ms(library, reps=reps),
                   library_device_ms=device_time_ms(library, reps=reps))
    return row


def bound(nbytes, flops, peak_flops):
    """(bound_ms, bound_by): the larger of bytes/HBM rate and flops/peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def compare_quantizers(dev, gen, results):
    import torch
    from repro_torch.core import precision
    from repro_torch.core.precision import E4M3, ScaleFormat
    from repro_torch.kernels import fp8_quant as fq

    def mismatches(a, b):
        return int((a.view(torch.uint8) != b.view(torch.uint8)).sum())

    # kernel 2 also at the stacked (L, K, N) of the sync's wg and wu
    # leaves; its payload is the (..., K, N) view of K-major storage
    for shape in [(4096, 12288), (12288, 4096), (36, 4096, 12288)]:
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        qk, sk = fq.quantize_weight_kernel(w, E4M3, ScaleFormat.FP32)
        qp, sp = fq.quantize_weight_ref(w, E4M3, ScaleFormat.FP32)
        torch.cuda.synchronize()
        bad_q, bad_s = mismatches(qk, qp), int((sk != sp).sum())
        log(f"quant_weight {shape}: payload mismatches {bad_q}, scale mismatches {bad_s}")
        check(bad_q == 0 and bad_s == 0, f"quant_weight {shape} not bit-equal")
        qk, sk = fq.quantize_weight_kernel(w, E4M3, ScaleFormat.UE8M0)
        qp, sp = fq.quantize_weight_ref(w, E4M3, ScaleFormat.UE8M0)
        torch.cuda.synchronize()
        log(f"quant_weight {shape} UE8M0: mismatching scale tiles {int((sk != sp).sum())} "
            f"of {sk.numel()}, payload bytes {mismatches(qk, qp)}")
    results["quant_weight"]["max_abs_err"] = 0.0
    for (m, k), dtype, fp8, fmt in QUANT_ACT_HOLDS:
        x = (torch.randn((m, k), generator=gen, device=dev) * 3.0).to(getattr(torch, dtype))
        hold_quant_act(x, getattr(precision, fp8), ScaleFormat[fmt])
    results["quant_act"]["max_abs_err"] = 0.0


def hold_quant_act(x, fp8, fmt):
    """Kernel 1 against its plain version on the same tensor: 0
    mismatching payload bytes and scales."""
    import torch
    from repro_torch.kernels import fp8_quant as fq
    qk, sk = fq.quantize_activation_kernel(x, fp8, fmt)
    qp, sp = fq.quantize_activation_ref(x, fp8, fmt)
    torch.cuda.synchronize()
    bad_q = int((qk.view(torch.uint8) != qp.view(torch.uint8)).sum())
    bad_s = int((sk.view(torch.int32) != sp.view(torch.int32)).sum())
    tag = f"quant_act {tuple(x.shape)} {x.dtype} -> {fp8} {fmt.name}"
    log(f"{tag}: payload mismatches {bad_q}, scale mismatches {bad_s}")
    check(bad_q == 0 and bad_s == 0, f"{tag} not bit-equal")


def hold_gemm(a, w, a_s, w_s, tag):
    """Kernel 3 against its plain version on the same tensors, within one
    bf16 rounding (rtol 2**-7, atol 1e-5 x max|plain|); returns the
    largest |kernel - plain|."""
    import torch
    from repro_torch.kernels import fp8_gemm as fg
    yk = fg.fp8_gemm(a, w, a_s, w_s).float()
    yp = fg.fp8_gemm_ref(a, w, a_s, w_s).float()
    torch.cuda.synchronize()
    err = (yk - yp).abs().max().item()
    scale = yp.abs().max().item()
    ok = bool(torch.isfinite(yk).all()) and torch.allclose(yk, yp, rtol=2 ** -7,
                                                           atol=1e-5 * scale)
    log(f"{tag}: max|kernel-plain| {err:.3e} (max|plain| {scale:.3f}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{tag}: kernel 3 disagrees with its plain version")
    return err


def hold_gemm_rows(a, w, a_s, w_s, tag):
    """The invariant of kernel 3: a row's bits never depend on M or on
    which rows share the call.  The rows of one call over all of `a` are
    recomputed at M 1, 8, 40 and 128 (leading and interior rows) and in a
    permuted batch; every one must be bit-equal."""
    import torch
    from repro_torch.kernels import fp8_gemm as fg
    m = a.shape[0]
    full = fg.fp8_gemm(a, w, a_s, w_s).view(torch.int16)
    subsets = [torch.arange(lo, lo + rows, device=a.device)
               for rows in (1, 8, 40, 128) for lo in (0, m // 2 - rows // 2) if lo + rows <= m]
    subsets.append(torch.randperm(m, device=a.device))
    for rows in subsets:
        part = fg.fp8_gemm(a[rows].contiguous(), w, a_s[rows].contiguous(), w_s)
        check(torch.equal(part.view(torch.int16), full[rows]),
              f"{tag}: rows at M {len(rows)} differ from the same rows at M {m}")
    log(f"{tag}: rows of M {m} bit-equal at M 1, 8, 40, 128 and in a permuted batch")


def gemm_weight(dev, gen, k, n, layers=1):
    """A seeded (layers, K, N) weight stack in the layout the sync makes
    (`ops.quantize_weight`)."""
    import torch
    from repro_torch.kernels import ops
    w = torch.empty((layers, k, n), dtype=torch.bfloat16, device=dev)
    w.normal_(generator=gen)
    w *= k ** -0.5
    return ops.quantize_weight(w)


def compare_gemm(dev, gen, results):
    import torch
    from repro_torch.kernels import fp8_quant as fq
    worst = 0.0
    for k, n in GEMM_SHAPES.values():
        wqt = gemm_weight(dev, gen, k, n).layer(0)
        x = torch.randn((max(GEMM_MS), k), generator=gen, device=dev).to(torch.bfloat16)
        a, a_s = fq.quantize_activation_kernel(x)
        for m in GEMM_MS:
            worst = max(worst, hold_gemm(a[:m], wqt.data, a_s[:m], wqt.scales,
                                         f"fp8_gemm M={m} K={k} N={n}"))
        hold_gemm_rows(a, wqt.data, a_s, wqt.scales, f"fp8_gemm K={k} N={n}")
    results["fp8_gemm"]["max_abs_err"] = worst


def _pool(dev, gen, nrows, bs, kvh, d, fp8):
    """Random K/V pools of `nrows` rows, E4M3 with per-tensor scales or
    bf16 with unit scales."""
    import torch
    from repro_torch.core.precision import E4M3
    k = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    v = torch.randn((nrows, bs, kvh, d), generator=gen, device=dev)
    if not fp8:
        one = torch.ones((), device=dev)
        return k.to(torch.bfloat16), v.to(torch.bfloat16), one, one
    ks, vs = k.abs().amax() / 448, v.abs().amax() / 448
    return (k / ks).clamp(-448, 448).to(E4M3), (v / vs).clamp(-448, 448).to(E4M3), ks, vs


def _tables(dev, gen, nrows, b, w, order):
    """(b, w) table rows out of the first nrows - 1: a random permutation,
    or ascending (each slot's blocks in pool order)."""
    import torch
    if order == "seq":
        return torch.arange(b * w, device=dev).reshape(b, w)
    return torch.randperm(nrows - 1, generator=gen, device=dev)[: b * w].reshape(b, w)


def decode_case(dev, gen, b=8, kvh=8, g=4, d=128, bs=16, max_len=300, lengths=None,
                fp8=True, order="perm"):
    """A paged pool with ragged live regions and the rest of every table
    pointing at one poison row (the last)."""
    import torch
    w = -(-max_len // bs)
    nrows = b * w + 1
    poison = nrows - 1
    kq, vq, ks, vs = _pool(dev, gen, nrows, bs, kvh, d, fp8)
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    if lengths is None:
        lengths = torch.randint(1, max_len + 1, (b,), generator=gen, device=dev)
    lengths = lengths.to(torch.int32)
    tables = _tables(dev, gen, nrows, b, w, order)
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
                 w=-(-ENGINE_MAX_SEQ // KV_BLOCK), fp8=True, order="perm"):
    """A chunk of C queries per slot over a paged pool whose table entries
    past each slot's live blocks point at one poison row (the last)."""
    import torch
    b = len(start)
    nrows = b * w + 1
    poison = nrows - 1
    kq, vq, ks, vs = _pool(dev, gen, nrows, bs, kvh, d, fp8)
    q = torch.randn((b, c, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    start = torch.tensor(start, dtype=torch.int32, device=dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tables = _tables(dev, gen, nrows, b, w, order)
    ctx = torch.minimum(start + c, lengths).long()
    live = ((ctx + bs - 1) // bs).clamp(1, w)
    dead = torch.arange(w, device=dev)[None, :] >= live[:, None]
    tables = torch.where(dead, poison, tables).to(torch.int32)
    return q, kq, vq, ks.float(), vs.float(), tables, start, lengths, poison


def compare_fleet_block(dev, gen, results):
    """Kernels 4 and 5 at the fleet's block size (`FLEET_BLOCK_SIZE` bf16-KV
    tokens: pages of 8 tokens in an E4M3 pool, 4 in a bf16 one), table rows
    in random and in pool order, at the fleet engines' table width
    (`FLEET_MAX_SEQ`): within 1e-2 of the plain versions, stale entries
    never read, idle slots and dead rows exact zeros."""
    import torch
    from repro_torch.kernels import fp8_kv_attention as fa
    worst_d = worst_p = 0.0
    for fp8 in (True, False):
        bs = FLEET_BLOCK_SIZE * (2 if fp8 else 1)
        w = -(-FLEET_MAX_SEQ // bs)
        pool = "e4m3" if fp8 else "bf16"
        for order in ("perm", "seq"):
            q, kq, vq, ks, vs, tables, lengths, poison = decode_case(
                dev, gen, bs=bs, max_len=FLEET_MAX_SEQ, fp8=fp8, order=order)
            lengths[0] = 0                                   # an idle slot
            out_k = fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths)
            out_p = fa.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lengths)
            kn, vn = kq.clone(), vq.clone()
            kn[poison] = 448.0
            vn[poison] = 448.0
            out_n = fa.fp8_paged_decode_attention(q, kn, vn, ks, vs, tables, lengths)
            torch.cuda.synchronize()
            err = (out_k.float() - out_p.float()).abs().max().item()
            ok = torch.allclose(out_k.float(), out_p.float(), rtol=1e-2, atol=1e-2)
            log(f"paged_decode {pool} BS={bs} W={w} tables {order} lengths "
                f"{lengths.tolist()}: max|kernel-plain| {err:.3e} {'ok' if ok else 'FAIL'}")
            check(ok, f"paged decode at block size {bs} disagrees with its plain version")
            check(torch.equal(out_n.view(torch.int16), out_k.view(torch.int16)),
                  f"a poisoned stale table entry reached paged decode at block size {bs}")
            check(bool((out_k[0] == 0).all()), "an idle slot (length 0) is not exact zeros")
            worst_d = max(worst_d, err)
            for start, lens, c in FLEET_PREFILL_CASES:
                q, kq, vq, ks, vs, tables, st, ln, poison = prefill_case(
                    dev, gen, start, lens, c, bs=bs, w=w, fp8=fp8, order=order)
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
                log(f"paged_prefill {pool} BS={bs} W={w} C={c} tables {order} start "
                    f"{start} lengths {lens}: max|kernel-plain| {err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                check(ok, f"paged prefill at block size {bs} C={c} disagrees with its "
                          "plain version")
                check(torch.equal(out_n.view(torch.int16), out_k.view(torch.int16)),
                      f"a poisoned stale table entry reached paged prefill at block size {bs}")
                check(bool((out_k[dead] == 0).all()), "a row past `lengths` is not exact zeros")
                worst_p = max(worst_p, err)
    log("paged kernels at the fleet's block size: held, stale entries never read")
    for name, worst in (("paged_decode", worst_d), ("paged_prefill", worst_p)):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], worst)


def contiguous_case(dev, gen, b, s_len, lengths, kvh=8, g=4, d=128, fp8=True):
    """One layer's contiguous cache (B, S, KVH, D) and q (B, KVH, G, D)."""
    import torch
    from repro_torch.core.precision import E4M3
    k = torch.randn((b, s_len, kvh, d), generator=gen, device=dev)
    v = torch.randn((b, s_len, kvh, d), generator=gen, device=dev)
    if fp8:
        ks, vs = k.abs().amax() / 448, v.abs().amax() / 448
        kq, vq = (k / ks).clamp(-448, 448).to(E4M3), (v / vs).clamp(-448, 448).to(E4M3)
    else:
        ks = vs = torch.ones((), device=dev)
        kq, vq = k.to(torch.bfloat16), v.to(torch.bfloat16)
    del k, v
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return q, kq, vq, ks.float(), vs.float(), lengths


def nan_past(x, lengths):
    """A copy of cache `x` (B, S, ...) with NaN bits at every position at
    or past each row's length (e4m3fn 0x7f, bf16 0x7fc0)."""
    import torch
    dead = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None].long()
    bits, nan = (torch.uint8, 0x7F) if x.element_size() == 1 else (torch.int16, 0x7FC0)
    out = x.clone()
    out.view(bits)[dead] = nan
    return out


def hold_decode(args, tag, results):
    """Kernel 6 vs its plain version on `args`, at q and at q x PEAKED_Q
    (see DECODE_TOL); the worst error goes into the kernels line.
    Returns the kernel's output at q."""
    import torch
    from repro_torch.kernels import fp8_kv_attention as fa
    q, rest = args[0], args[1:]
    outs = []
    for q_scale in (1.0, PEAKED_Q):
        qs = (q.float() * q_scale).to(q.dtype)
        out_k = fa.fp8_decode_attention(qs, *rest)
        out_p = fa.fp8_decode_attention_ref(qs, *rest).float()
        torch.cuda.synchronize()
        err = (out_k.float() - out_p).abs().max().item()
        top = out_p.abs().max().item()
        ok = (torch.allclose(out_k.float(), out_p, rtol=DECODE_TOL, atol=DECODE_TOL)
              and err <= DECODE_TOL * top)
        log(f"{tag}, q x {q_scale:g}: max|kernel-plain| {err:.3e}, max|plain| {top:.3e} "
            f"(tol {DECODE_TOL} and {DECODE_TOL} x max|plain|) {'ok' if ok else 'FAIL'}")
        check(ok, f"{tag}: kernel 6 disagrees with its plain version at q x {q_scale:g}")
        results["decode"]["max_abs_err"] = max(results["decode"].get("max_abs_err", 0.0), err)
        outs.append(out_k)
        del out_p
    return outs[0]


def compare_contiguous_decode(dev, gen, results):
    import torch
    from repro_torch.kernels import fp8_kv_attention as fa
    for fp8 in (True, False):
        lengths = torch.randint(1, 1058, (8,), generator=gen, device=dev)
        lengths[0], lengths[1] = 0, 1057
        q, kq, vq, ks, vs, ln = contiguous_case(dev, gen, 8, 1057, lengths, fp8=fp8)
        out_k = hold_decode((q, kq, vq, ks, vs, ln), f"decode {'e4m3' if fp8 else 'bf16'} "
                            f"B=8 KVH=8 G=4 D=128 S=1057 lengths {ln.tolist()}", results)
        out_n = fa.fp8_decode_attention(q, nan_past(kq, ln), nan_past(vq, ln), ks, vs, ln)
        torch.cuda.synchronize()
        check(torch.equal(out_n.view(torch.int16), out_k.view(torch.int16)),
              "NaN past a row's length reached the contiguous-decode output")
        check(bool((out_k[0] == 0).all()), "an idle row (length 0) is not exact zeros")
    log("decode: nothing past a length is read (NaN poison), idle row exact zeros")


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


def _prefilled(model, roll, prec, prompts, lengths, dev, extra=None, room=2):
    """A paged cache prefilled with `prompts` (and `extra` inputs: an
    enc-dec model's frames and src_lengths, a VLM's patches), with `room`
    positions past the longest row, and each row's next token."""
    import torch
    extra = extra or {}
    prefix = extra["patches"].shape[1] if "patches" in extra else 0
    src = extra["frames"].shape[1] if "frames" in extra else 0
    cache = model.init_cache(len(prompts), prefix + prompts.shape[1] + room, prec,
                             page_size=16, src_len=src)
    logits, cache = model.prefill(roll, {"tokens": torch.from_numpy(prompts).to(dev),
                                         "lengths": torch.from_numpy(lengths).to(dev),
                                         **extra}, cache, prec)
    return cache, logits.argmax(-1)


def _hold_decode_logits(lk, lp, what=""):
    """Kernel-step logits `lk` against plain-step logits `lp`: within
    LOGIT_ATOL, argmax equal on the rows whose top two differ by more
    than 2 x LOGIT_ATOL.  Returns the largest gap."""
    import torch
    torch.cuda.synchronize()
    err = (lk - lp).abs().max().item()
    mean_err = (lk - lp).abs().mean().item()
    top2 = lp.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_ATOL
    agree = bool((lk.argmax(-1) == lp.argmax(-1))[decisive].all())
    log(f"decode-step logits kernel vs plain{what}: max abs err {err:.4f}, mean {mean_err:.5f} "
        f"(max|logit| {lp.abs().max().item():.3f}, tol {LOGIT_ATOL}); "
        f"argmax equal on {int(decisive.sum())} decisive rows: {agree}; "
        f"on all rows: {bool((lk.argmax(-1) == lp.argmax(-1)).all())}")
    check(bool(torch.isfinite(lk).all()), "kernel logits not finite")
    check(err <= LOGIT_ATOL and agree, f"decode-step logits{what}: kernels disagree with plain")
    return err


def decode_logits_check(model, roll, prec, prompts, lengths, dev, extra=None):
    """One decode step through the kernels vs the plain versions called on
    the same CUDA tensors (the same cache, cloned)."""
    import copy

    from repro_torch.kernels import ops
    cache, tok = _prefilled(model, roll, prec, prompts, lengths, dev, extra)
    twin = copy.deepcopy(cache)
    lk, _ = model.decode_step(roll, tok, cache, prec)
    with mock.patch.object(ops, "_route", lambda t, kernel, plain: plain):
        lp, _ = model.decode_step(roll, tok, twin, prec)
    return _hold_decode_logits(lk, lp)


def forced_decode_logits_check(model, roll, prec, prompts, lengths, dev, extra=None):
    """`decode_logits_check` teacher-forced: each layer of the plain step
    takes the kernel step's input to that layer, so no gap compounds over
    the layers (through random weights a last-bit difference that moves
    an activation across an fp8 rounding boundary grows layer by layer).
    Each layer's update (its output less its input) within
    FORCED_LAYER_RTOL of its largest entry, and the logits held as
    `decode_logits_check` holds them.  Beside it, logged: the free-running
    plain step's gap and how many MoE expert sets it routes differently
    from the kernel step."""
    import copy

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    cache, tok = _prefilled(model, roll, prec, prompts, lengths, dev, extra)
    twin, free = copy.deepcopy(cache), copy.deepcopy(cache)
    step = blocks.apply_slot_decode
    inputs, outputs = [], {"kernel": [], "plain": []}     # in layer order

    def recording(x, *args, **kw):
        inputs.append(x.clone())
        out = step(x, *args, **kw)
        outputs["kernel"].append(out[0].clone())
        return out
    forced = iter(inputs)

    def forcing(x, *args, **kw):
        out = step(next(forced), *args, **kw)
        outputs["plain"].append(out[0])
        return out
    with mock.patch.object(blocks, "apply_slot_decode", recording):
        lk, _, kernel_aux = model.decode_step(roll, tok, cache, prec, want_routing=True)
    with mock.patch.object(ops, "_route", lambda t, kernel, plain: plain), \
            mock.patch.object(blocks, "apply_slot_decode", forcing):
        lp, _ = model.decode_step(roll, tok, twin, prec)
    with mock.patch.object(ops, "_route", lambda t, kernel, plain: plain):
        lf, _, free_aux = model.decode_step(roll, tok, free, prec, want_routing=True)
    torch.cuda.synchronize()
    layer_gaps = [((k - p).float().abs().max() / (p - x).float().abs().max().clamp_min(1e-30))
                  .item() for x, k, p in zip(inputs, outputs["kernel"], outputs["plain"])]
    pairs = [(a, free_aux["routing"][name]) for name, a in kernel_aux["routing"].items()]
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum()) for a, b in pairs)
    log(f"decode step, each layer's input forced: its update kernel vs plain over its largest "
        f"entry " + json.dumps([f"{g:.2e}" for g in layer_gaps])
        + f" (tol {FORCED_LAYER_RTOL}); plain free-running: logits max abs err "
        f"{(lk - lf).abs().max().item():.4f}, {flips} of "
        f"{sum(a[..., 0].numel() for a, _ in pairs)} token-layer expert sets routed "
        "differently from the kernel step")
    check(len(layer_gaps) == len(outputs["plain"]) == model.repeats * len(model.pattern)
          and max(layer_gaps) <= FORCED_LAYER_RTOL,
          "decode step, each layer's input forced: a layer's kernels disagree with plain")
    del inputs[:], outputs, cache, twin, free
    return _hold_decode_logits(lk, lp, ", each layer's input forced")


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


def profile_decode_step(model, roll, prec, prompts, lengths, dev, tag="", extra=None):
    """Device-busy share of one decode step: kernel time on the stream
    (torch.profiler) over the step's wall time without the profiler
    (`extra`: the prefill's frames or patches).  The keys of the result
    start with `tag`."""
    cache, tok = _prefilled(model, roll, prec, prompts, lengths, dev, extra, room=4)
    model.decode_step(roll, tok, cache, prec)          # warm
    _, wall_ms = _sync_ms(model.decode_step, roll, tok, cache, prec)
    _, busy_ms, n_kernels, by_name = _profile(lambda: model.decode_step(roll, tok, cache, prec))
    if not n_kernels:
        log(f"{tag}decode step: wall {wall_ms:.1f} ms; device time not measured "
            "(the profiler saw no CUDA events)")
        return {f"{tag}decode_step_wall_ms": wall_ms}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    quant_ms = sum(ms for name, ms in by_name.items() if "quant_act" in name)
    gemm_ms = sum(ms for name, ms in by_name.items() if "fp8_gemm" in name)
    out = {f"{tag}decode_step_wall_ms": wall_ms, f"{tag}decode_step_device_busy_ms": busy_ms,
           f"{tag}decode_step_device_kernels": n_kernels,
           f"{tag}decode_step_device_busy_share": busy_ms / wall_ms,
           f"{tag}decode_step_quant_act_ms": quant_ms,
           f"{tag}decode_step_fp8_gemm_ms": gemm_ms,
           f"{tag}decode_step_quant_act_share_of_busy": quant_ms / busy_ms}
    log(f"{tag}decode step profile: " + json.dumps(out) + "; top kernels (ms): "
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
    check_quant_per_gemm(launches, "the rollout path", _quant_ratio(cfg))

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
    stats.update(bf16_rollout(model, params, prompts, lengths, greedy, cfg, dev))
    log(f"greedy rollout, same prompts, PrecisionConfig() vs BF16_ROLLOUT: "
        f"{stats['greedy_tokens_per_s']:.1f} vs {stats['bf16_greedy_tokens_per_s']:.1f} "
        f"tokens/s, decode {stats['decode_ms_per_step']:.1f} vs "
        f"{stats['bf16_decode_ms_per_step']:.1f} ms/step")
    log("main path: " + json.dumps(stats))
    return model, roll, t_greedy


def bf16_rollout(model, params, prompts, lengths, sampler, cfg, dev):
    """The paper's baseline beside the FP8 run: one greedy `generate` under
    BF16_ROLLOUT (bf16 linears through `_dot`, a bf16 paged KV cache) on
    the same prompts; its tokens/s and decode ms/step, measured as the FP8
    run's are, and one decode step profiled."""
    import torch
    from repro_torch.core.precision import BF16_ROLLOUT
    from repro_torch.kernels import build
    from repro_torch.rl import generate, sync_policy_weights
    roll, _ = sync_policy_weights(params, BF16_ROLLOUT)
    before = build.LAUNCHES["paged_decode"]
    traj, gen_ms = _sync_ms(lambda: generate(roll, prompts, lengths, None, cfg, BF16_ROLLOUT,
                                             sampler, page_size=16, device=dev))
    steps = (build.LAUNCHES["paged_decode"] - before) // cfg.n_layers
    check_trajectory(traj, len(prompts), sampler.max_new_tokens, cfg.vocab_size, "bf16 greedy")
    cache = model.init_cache(len(prompts), prompts.shape[1] + 33, BF16_ROLLOUT, page_size=16)
    inputs = {"tokens": torch.from_numpy(prompts).to(dev),
              "lengths": torch.from_numpy(lengths).to(dev)}
    _, prefill_ms = _sync_ms(model.prefill, roll, inputs, cache, BF16_ROLLOUT)
    tokens = int(traj.response_lengths.sum())
    return {"bf16_greedy_generate_s": gen_ms / 1e3, "bf16_greedy_tokens": tokens,
            "bf16_greedy_tokens_per_s": tokens / (gen_ms / 1e3), "bf16_prefill_ms": prefill_ms,
            "bf16_decode_ms_per_step": (gen_ms - prefill_ms) / max(steps, 1),
            **profile_decode_step(model, roll, BF16_ROLLOUT, prompts, lengths, dev, "bf16_")}


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


def _timed(fn, log_to, profiled=None):
    """`fn` between two synchronizes; appends (ms, chunk width or None).
    Given a dict `profiled`, the third 128-token chunk runs under the
    profiler instead (untimed): its device busy ms, kernel count and
    kernel 5's share go into the dict."""
    import torch

    def wrapper(*args, **kw):
        width = args[1].shape[1] if fn.__name__ == "prefill_chunk" else None
        if profiled is not None and not profiled and width == 128 \
                and sum(w == 128 for _, w in log_to) == 2:
            out, busy, n, by_name = _profile(lambda: fn(*args, **kw))
            profiled.update(busy_ms=busy, kernels=n, paged_prefill_ms=sum(
                ms for name, ms in by_name.items() if "paged_prefill" in name))
            return out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log_to.append(((time.perf_counter() - t0) * 1e3, width))
        return out
    return wrapper


def _profile(fn):
    """`fn()` under torch.profiler: (its result, device busy ms, kernels,
    busy ms by kernel name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out, sum(by_name.values()), len(kernels), by_name


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
    calls, decode_walls, profiled, chunk_profile = [], [], None, {}
    tight_eng.model.prefill_chunk = _timed(tight_eng.model.prefill_chunk, calls, chunk_profile)
    tight_eng.model.decode_step = _timed(tight_eng.model.decode_step, calls)
    for i, p in enumerate(trace):
        tight_eng.submit(p, max_new=ENGINE_MAX_NEW, rid=i)
    t0 = time.perf_counter()
    while tight_eng.queue or any(r is not None for r in tight_eng.slot_req):
        # after a pure decode step with nothing queued, the next step is one
        # fused decode too: profile one such step
        if profiled is None and len(decode_walls) >= 2 and not tight_eng.queue and all(
                r is None or r.prefilled >= len(r.prompt) for r in tight_eng.slot_req):
            profiled = _profile(tight_eng.step)[1:3]
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
    check_quant_per_gemm(launches, "the serving path", _quant_ratio(cfg))
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
    if chunk_profile:
        stats.update(engine_chunk128_device_busy_ms=chunk_profile["busy_ms"],
                     engine_chunk128_kernels=chunk_profile["kernels"],
                     engine_chunk128_paged_prefill_ms=chunk_profile["paged_prefill_ms"],
                     engine_chunk128_busy_share=chunk_profile["busy_ms"] / statistics.mean(
                         chunk_ms))
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
# phase 7: the contiguous-cache path (launch.steps, kernel 6)
# ---------------------------------------------------------------------------

def _sync_ms(fn, *args):
    """(fn(*args), ms between two synchronizes)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _path_launches(tag, need, ratio):
    """Read the counts of the run just driven; every kernel in `need` must
    have launched, and kernel 1 once per distinct linear input (`ratio`,
    the model's `_quant_ratio`; see `check_quant_per_gemm`; None for a path
    that mixes prefills and decode steps of unequal ratios, which
    `check_forward_launches` counts exactly)."""
    from repro_torch.kernels import build
    launches = dict(build.LAUNCHES)
    log(f"{tag} launches: {launches}")
    for name in need:
        check(launches[name] > 0, f"kernel {name} was not launched on {tag}")
    if ratio is not None:
        check_quant_per_gemm(launches, tag, ratio)
    return launches


def check_quant_per_gemm(launches, tag, ratio):
    """Kernel 1 launches exactly `ratio` (kernel 1 : kernel 3 of the
    path's layer pattern, `_quant_ratio`) of kernel 3's: one quantization
    per distinct activation, never one per linear."""
    q, g = ratio
    gemms = launches["fp8_gemm"] + launches["fp8_gemm_batched"]
    check(launches["quant_act"] * g == gemms * q,
          f"{tag}: kernel 1 launched {launches['quant_act']} times for "
          f"{gemms} of kernel 3, not {q}/{g} of them")


def _top2_gap(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


def contiguous_7a(dev, cfg, roll, prec, stats):
    """Prefill + 32 greedy serve steps at (B 8, S 1056), held against the
    paged path and against the plain versions."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import build, ops
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.rl import SamplerConfig, generate
    from repro_torch.roofline.analysis import count_step
    shape = ShapeConfig(*CONTIG_SHAPE)
    b = shape.global_batch
    prompts, lengths = make_prompts(np.random.default_rng(SEED + 7), b=b, lo=512, hi=1024)
    tokens = np.zeros((b, shape.seq_len), np.int32)
    tokens[:, :prompts.shape[1]] = prompts
    batch = {"tokens": torch.from_numpy(tokens).to(dev), "lengths": torch.from_numpy(lengths)}
    prefill_step = steps.make_prefill_step(cfg, shape, prec, device=dev)
    serve_step = steps.make_serve_step(cfg, prec, device=dev)

    build.reset_launch_counts()
    # --- the contiguous path: prefill, then 32 greedy serve steps ----------
    (logits, cache), prefill_ms = _sync_ms(prefill_step, roll, batch)
    prefill_logits = logits
    toks, gaps, step_ms = [logits.argmax(-1)], [_top2_gap(logits)], []
    for i in range(CONTIG_STEPS):
        (logits, cache), ms = _sync_ms(serve_step, roll, toks[-1], cache)
        if i == 0:
            first_step_logits = logits
        step_ms.append(ms)
        toks.append(logits.argmax(-1))
        gaps.append(_top2_gap(logits))
    launches = _path_launches("contiguous path 7a", ("quant_act", "fp8_gemm", "decode"),
                              _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["decode"] == cfg.n_layers * CONTIG_STEPS,
          f"kernel 6 launched {launches['decode']} times, not {cfg.n_layers} x {CONTIG_STEPS}")
    check(bool(torch.isfinite(logits).all()), "7a: serve-step logits not finite")
    check(cache["max_length"] == int(lengths.max()) + CONTIG_STEPS, "7a: host length bound")
    stats.update(contig_prefill_ms=prefill_ms, contig_serve_step_ms_mean=float(np.mean(step_ms)),
                 contig_serve_step_ms_median=float(np.median(step_ms)),
                 contig_prompt_lengths=lengths.tolist())

    # against the paged path (kernel 4) on the same prompts
    model = Transformer(cfg, dev)
    pc = model.init_cache(b, shape.seq_len + 1, prec, page_size=16)
    lp, pc = model.prefill(roll, batch, pc, prec)
    lp1, _ = model.decode_step(roll, lp.argmax(-1), pc, prec)
    del pc
    torch.cuda.synchronize()
    prefill_gap = (lp - prefill_logits).abs().max().item()
    step_gap = (lp1 - first_step_logits).abs().max().item()
    decisive = _top2_gap(first_step_logits) > DECISIVE_GAP
    agree = bool((lp1.argmax(-1) == first_step_logits.argmax(-1))[decisive].all())
    log(f"7a contiguous vs paged: prefill logits max gap {prefill_gap:.4f}, first decode "
        f"step {step_gap:.4f} (tol {LOGIT_ATOL}); argmax equal on {int(decisive.sum())} "
        f"decisive rows: {agree}")
    check(prefill_gap <= LOGIT_ATOL and step_gap <= LOGIT_ATOL and agree,
          "contiguous and paged first-step logits disagree")
    greedy = SamplerConfig(max_new_tokens=CONTIG_STEPS, temperature=0.0)
    traj = generate(roll, prompts, lengths, None, cfg, prec, greedy, page_size=16, device=dev)
    mine = torch.stack(toks[:CONTIG_STEPS], 1).cpu()
    gap_t = torch.stack(gaps[:CONTIG_STEPS], 1).cpu()
    theirs, mask = traj.response_tokens.cpu(), traj.response_mask.cpu()
    # while a row's tokens agree, both paths see the same inputs: every
    # decisive step must agree; the first near-tie they part at ends the row
    compared = equal_run = 0
    for r in range(b):
        for i in range(CONTIG_STEPS):
            if mask[r, i] == 0:
                break                      # past EOS
            same = int(mine[r, i]) == int(theirs[r, i])
            if gap_t[r, i] > DECISIVE_GAP:
                compared += 1
                check(same, f"7a: greedy token {i} of row {r} differs from paged generate's")
            elif not same:
                break                      # a near-tie: the two part here
        equal_run += int(torch.equal(mine[r][mask[r] > 0], theirs[r][mask[r] > 0]))
    log(f"7a greedy tokens vs paged generate: {compared} decisive steps (top-2 gap > "
        f"{DECISIVE_GAP}) equal; {equal_run} of {b} rows equal throughout")
    check(compared > 0, "7a: no decisive step compared against paged generate")

    # one serve step through the kernels vs the plain versions, same tensors
    twin = copy.deepcopy(cache)
    tok = toks[-1]
    # phase 16 reads this step's count (roofline) against its device time:
    # counted on its own first (a shallow copy of the cache: the count's
    # step writes the K/V row the kernel step rewrites with the same
    # values, and its lengths stay), then the kernel step profiled alone
    _, costs = count_step(serve_step, roll, tok, dict(cache))
    (lk, _), busy, _, _ = _profile(lambda: serve_step(roll, tok, cache))
    ROOFLINE_COUNTS["7a"] = dict(costs=costs, busy_ms=busy, shape=("7a", shape.seq_len, b))
    with mock.patch.object(ops, "_route", lambda t, kernel, plain: plain):
        lpl, _ = serve_step(roll, tok, twin)
    torch.cuda.synchronize()
    err = (lk - lpl).abs().max().item()
    decisive = _top2_gap(lpl) > DECISIVE_GAP
    agree = bool((lk.argmax(-1) == lpl.argmax(-1))[decisive].all())
    log(f"7a serve-step logits kernels vs plain: max abs err {err:.4f}, mean "
        f"{(lk - lpl).abs().mean().item():.5f} (tol {LOGIT_ATOL}); argmax equal on "
        f"{int(decisive.sum())} decisive rows: {agree}")
    check(err <= LOGIT_ATOL and agree, "serve-step logits: kernels disagree with plain")
    stats.update(contig_vs_paged_prefill_gap=prefill_gap, contig_vs_paged_step_gap=step_gap,
                 contig_decisive_tokens_equal=compared, contig_serve_logit_err=err)
    final_lengths = cache["lengths"].clone()
    del cache, twin
    return launches, final_lengths


def fresh_peak(tag, stats):
    """Reset the peak-memory counter before a phase, after collecting the
    earlier phases' garbage: a reference cycle would keep its device
    tensors allocated until Python's collector runs, and they would count
    in the phase's peak (a dropped engine no longer sits in one).  Logs,
    and puts into `stats` under `tag`, what stays allocated and what the
    collection freed (GB)."""
    import gc
    import torch
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    stats[f"{tag}_resident_gb"], stats[f"{tag}_gc_freed_gb"] = after / 1e9, (before - after) / 1e9
    log(f"{tag}: {after / 1e9:.2f} GB allocated before the phase, "
        f"{(before - after) / 1e9:.2f} GB of it freed by gc.collect()")
    torch.cuda.reset_peak_memory_stats()


def contiguous_7b(dev, cfg, roll, prec, stats):
    """A 16384-token prompt through the chunked attention impl, then 16
    serve steps at 16K context."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import tasks
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models.attention import attention_impl
    shape = ShapeConfig("smoke_prefill_16k", LONG_PROMPT + LONG_STEPS, 1, "prefill")
    tokens = np.zeros((1, shape.seq_len), np.int32)
    tokens[0, :LONG_PROMPT] = tasks.random_prompt(SEED + 9, LONG_PROMPT)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "lengths": torch.tensor([LONG_PROMPT], dtype=torch.int32)}
    prefill_step = steps.make_prefill_step(cfg, shape, prec, device=dev)
    serve_step = steps.make_serve_step(cfg, prec, device=dev)
    fresh_peak("long", stats)
    build.reset_launch_counts()
    # --- the contiguous path at 16K: chunked prefill, 16 serve steps -------
    with attention_impl("chunked"):
        (logits, cache), prefill_ms = _sync_ms(prefill_step, roll, batch)
    step_ms = []
    for _ in range(LONG_STEPS):
        (logits, cache), ms = _sync_ms(serve_step, roll, logits.argmax(-1), cache)
        step_ms.append(ms)
    launches = _path_launches("contiguous path 7b", ("quant_act", "fp8_gemm", "decode"),
                              _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["decode"] == cfg.n_layers * LONG_STEPS, "7b: kernel 6 launch count")
    check(bool(torch.isfinite(logits).all()), "7b: logits not finite")
    check(cache["lengths"].tolist() == [LONG_PROMPT + LONG_STEPS], "7b: lengths")
    stats.update(long_prefill_s=prefill_ms / 1e3,
                 long_serve_step_ms_median=float(np.median(step_ms)),
                 long_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"7b: {LONG_PROMPT}-token prompt prefilled (chunked attention) in "
        f"{prefill_ms / 1e3:.2f} s, serve step at 16K context {np.median(step_ms):.1f} ms "
        f"(median of {LONG_STEPS}), peak {stats['long_peak_gib']:.1f} GiB")
    del cache
    return launches


def contiguous_7c(dev, gen, cfg, roll, prec, stats, extra, results):
    """The LONG_500K decode cell: 4 serve steps at 524284-524288 tokens of
    context on one card, kernel 6 timed and held against its plain version
    on one layer."""
    import numpy as np
    import torch
    from repro_torch.configs import LONG_500K
    from repro_torch.core.quant import calibrate_scale, quantize_per_tensor
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.roofline.analysis import count_step
    b, s_len = LONG_500K.global_batch, LONG_500K.seq_len
    kvh, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    fresh_peak("long500k", stats)
    specs = steps.cache_specs(cfg, LONG_500K, prec)
    kv_spec = specs["slots"]["s0"]["kv"]
    kv = type(kv_spec)(*(torch.empty(t.shape, dtype=t.dtype, device=dev)
                         for t in (kv_spec.k, kv_spec.v, kv_spec.k_scale, kv_spec.v_scale)))
    cache = {"slots": {"s0": {"kv": kv}},
             "lengths": torch.full((b,), LONG_500K_LENGTH, dtype=torch.int32, device=dev),
             "max_length": LONG_500K_LENGTH}
    t0 = time.perf_counter()
    for r in range(cfg.n_layers):       # the reference's recipe, one layer at a time
        for data, scale in ((kv.k[r], kv.k_scale[r]), (kv.v[r], kv.v_scale[r])):
            x = torch.randn(data.shape, generator=gen, device=dev)
            scale.copy_(calibrate_scale(x.abs().amax(), margin=1.05))
            data.copy_(quantize_per_tensor(x, scale, data.dtype))
            del x
    torch.cuda.synchronize()
    cache_gb = 2 * kv.k.numel() * kv.k.element_size() / 1e9
    bf16_gb = 2 * kv.k.numel() * 2 / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    log(f"7c: LONG_500K cache {tuple(kv.k.shape)} x2 E4M3 = {cache_gb:.1f} GB filled in "
        f"{time.perf_counter() - t0:.1f} s; in bf16 it would be {bf16_gb:.1f} GB, the card "
        f"has {card_gb:.1f} GB")
    serve_step = steps.make_serve_step(cfg, prec, device=dev)
    tok = torch.randint(4, 19, (b,), generator=gen, device=dev)
    # phase 16's count (roofline) of one step, on its own, before the
    # cell's launches are counted: a shallow copy of the cache, so the
    # count's step writes the K/V row that the first step rewrites with
    # the same values, and the cache's lengths stay (the cache is full
    # after the cell's 4 steps; there is no room for a fifth)
    _, costs = count_step(serve_step, roll, tok, dict(cache))
    build.reset_launch_counts()
    # --- the LONG_500K decode cell: 4 serve steps, the last one profiled ---
    step_ms = []
    for _ in range(LONG_500K_STEPS - 1):
        (logits, cache), ms = _sync_ms(serve_step, roll, tok, cache)
        tok = logits.argmax(-1)
        step_ms.append(ms)
    (logits, cache), busy_ms, n_kernels, by_name = _profile(
        lambda: serve_step(roll, tok, cache))
    ROOFLINE_COUNTS["7c"] = dict(costs=costs, busy_ms=busy_ms,
                                 shape=("long_500k", s_len, b))
    launches = _path_launches("LONG_500K decode 7c", ("quant_act", "fp8_gemm", "decode"),
                              _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["decode"] == cfg.n_layers * LONG_500K_STEPS, "7c: kernel 6 launch count")
    check(bool(torch.isfinite(logits).all()), "7c: logits not finite")
    check(cache["lengths"].tolist() == [LONG_500K_LENGTH + LONG_500K_STEPS], "7c: lengths")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms = float(np.median(step_ms))
    attn_ms = sum(ms for name, ms in by_name.items() if "decode_" in name)
    fp8_gemm_ms = sum(ms for name, ms in by_name.items() if "fp8_gemm" in name)
    # the lm_head is the step's one library GEMM (bf16 in, f32 sums: `_dot`)
    head_ms = sum(ms for name, ms in by_name.items() if "fp8_gemm" not in name
                  and any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass")))
    head_bound_ms = cfg.d_model * cfg.vocab_size * 2 / HBM_BYTES_PER_S * 1e3
    gemm_ms = fp8_gemm_ms + head_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"7c profiled serve step: {n_kernels} kernels, device busy {busy_ms:.2f} ms of a "
        f"{wall_ms:.2f} ms step (median of {len(step_ms)} unprofiled): kernel 6 (split + "
        f"combine) {attn_ms:.2f} ms, fp8 linears {fp8_gemm_ms:.2f} ms, the lm_head GEMM "
        f"{head_ms:.3f} ms (bound {head_bound_ms:.3f} ms: its bf16 weight read once), "
        f"other kernels {busy_ms - attn_ms - gemm_ms:.2f} ms, host (not kernel time) "
        f"{wall_ms - busy_ms:.2f} ms; top kernels (ms): "
        + json.dumps([[name[:60], round(ms, 3)] for name, ms in top]))

    # kernel 6 on one layer at this shape: held to its plain version, timed
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(torch.bfloat16)
    args = (q, kv.k[0], kv.v[0], kv.k_scale[0], kv.v_scale[0], cache["lengths"])
    hold_decode(args, f"7c kernel 6 vs plain, one layer at S {s_len}, length "
                f"{int(cache['lengths'][0])}", results)
    row = decode_row(args, reps=20, plain_reps=3)
    extra.append(dict(kernel="decode", shape=[b, kvh, g, d], s_max=s_len,
                      context=int(cache["lengths"].sum()), **row))
    stats.update(long500k_serve_step_ms=step_ms, long500k_peak_gb=peak_gb,
                 long500k_cache_gb=cache_gb, long500k_bf16_cache_gb=bf16_gb,
                 long500k_card_gb=card_gb, long500k_kernel6_ms=row["ms"],
                 long500k_step_busy_ms=busy_ms, long500k_step_kernel6_ms=attn_ms,
                 long500k_step_gemm_ms=gemm_ms, long500k_step_lm_head_ms=head_ms,
                 long500k_step_host_ms=wall_ms - busy_ms)
    log(f"7c: serve steps at {LONG_500K_LENGTH}-{LONG_500K_LENGTH + LONG_500K_STEPS} tokens "
        f"of context: {[round(ms, 2) for ms in step_ms]} ms; kernel 6 {row['ms']:.4f} ms per "
        f"launch (bound {row['bound_ms']:.4f}), x {cfg.n_layers} layers = "
        f"{cfg.n_layers * row['ms']:.1f} ms of a step; peak device memory {peak_gb:.1f} GB "
        f"of {card_gb:.1f}")
    del cache, kv, args
    torch.cuda.empty_cache()
    return launches


def contiguous_path(dev, gen, results, cfg, roll, extra):
    """Phase 7: 7a, 7b and 7c, each a path whose launches are counted."""
    from repro_torch.core.precision import PrecisionConfig
    prec = PrecisionConfig()
    stats = {}
    runs = []
    la, final_lengths = contiguous_7a(dev, cfg, roll, prec, stats)
    runs.append(la)
    runs.append(contiguous_7b(dev, cfg, roll, prec, stats))
    runs.append(contiguous_7c(dev, gen, cfg, roll, prec, stats, extra, results))
    total = {k: sum(r[k] for r in runs) for k in runs[0]}
    results["decode"]["launches"] = total["decode"]
    stats["contiguous_path_launches"] = total
    log("contiguous path: " + json.dumps(stats))
    return final_lengths


# ---------------------------------------------------------------------------
# phase 8: the RL trainer (rl.RLTrainer) on full qwen3-8b
# ---------------------------------------------------------------------------

def _finite_metrics(m, tag):
    import math
    bad = [k for k, v in m.items()
           if not all(math.isfinite(x) for x in (v if isinstance(v, list) else [v]))]
    check(not bad, f"{tag}: metrics not finite: {bad}")


def _sync_fingerprint(params, prec):
    """Per quantized leaf of a weight sync: layer 0's fp8 payload bytes and
    the sum of every payload byte (the sync's 9 GB live only inside)."""
    import torch
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.rl import sync_policy_weights
    roll, _ = sync_policy_weights(params, prec)
    out = {}
    for slot, tree in roll["blocks"].items():
        for part, leaves in tree.items():
            for name, leaf in leaves.items():
                if isinstance(leaf, QuantizedTensor):
                    data = leaf.data.view(torch.uint8)
                    out[f"{slot}/{part}/{name}"] = (data[0].clone(),
                                                    int(data.sum(dtype=torch.int64)))
    del roll
    return out


def score_rollouts(trainer, presets, dev):
    """The same prompts and generator seed rolled out under each of
    `presets` ({name: PrecisionConfig}), every trajectory scored by the
    trainer's policy with the same advantages, drawn per GRPO group (with
    random weights every reward ties at 0): per preset the mismatch KL (k3
    and k1), the TIS weight mean, ESS and max, rollout s and tokens/s, and
    the rollout's decode steps and kernel-4 launches."""
    import numpy as np
    import torch
    from repro_torch.data import PromptPipeline
    from repro_torch.kernels import build
    from repro_torch.rl.rewards import batch_rewards
    from repro_torch.rl.trainer import stats_to_host
    rl = trainer.rl
    adv = np.repeat(np.random.default_rng(SEED).normal(size=rl.prompt_batch), rl.n_per_prompt)
    advantages = torch.tensor(adv, dtype=torch.float32, device=dev)
    prompts = PromptPipeline(rl.prompt_batch, rl.max_prompt_len, seed=SEED + 3).next_batch()
    problems = [p for p in prompts.problems for _ in range(rl.n_per_prompt)]
    out = {}
    for name, p in presets.items():
        trainer.generator.manual_seed(SEED)
        build.reset_launch_counts()
        traj, _, roll_s = trainer.rollout(prompts, p)
        kernel4 = build.LAUNCHES["paged_decode"]
        rewards = batch_rewards(problems, traj.response_tokens.cpu().numpy(),
                                traj.response_lengths.cpu().numpy())
        ub = trainer.make_update_batch(traj, rewards)
        ub["advantages"], ub["mask"] = advantages, ub["response_mask"]
        st = stats_to_host(trainer.batch_loss(trainer.params, ub)[1])
        _finite_metrics(st, f"{name} rollout stats")
        tokens = float(traj.response_mask.sum())
        out[name] = dict(rollout_s=roll_s, tokens=tokens, tokens_per_s=tokens / roll_s,
                         decode_steps=_decode_steps(traj), kernel4_launches=kernel4,
                         **{k: st[k] for k in ("mismatch_kl", "mismatch_kl_k1",
                                               "corr_weight_mean", "corr_weight_ess",
                                               "is_weight_max")})
    return out


def train_path(dev, cfg):
    """Phase 8: `RLTrainer` on full-width, full-depth qwen3-8b over the
    main path's bf16 weights, drawn again from the same seed (held through
    phases 5-7 they would count in 7c's LONG_500K peak) — TRAIN_STEPS
    train steps, FP8 against BF16 rollout mismatch on the same prompts,
    then one update with nonzero advantages on the last step's
    trajectory."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.core.precision import BF16_ROLLOUT, PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.optim import AdamWConfig, state_bytes
    from repro_torch.rl import RLConfig, RLTrainer
    from repro_torch.rl.trainer import stats_to_host

    prec = PrecisionConfig()
    rl = RLConfig(precision=prec, prompt_batch=8, n_per_prompt=4, max_prompt_len=12,
                  max_new_tokens=32, temperature=1.0,
                  optimizer=AdamWConfig(lr=3e-4, b2=0.98, grad_clip=1.0, fp8_moments=True))
    stats = {}
    fresh_peak("train", stats)
    trainer = RLTrainer(cfg, rl, params=Transformer(cfg, dev).init_params(SEED), device=dev)
    stats["opt_state_gb"] = state_bytes(trainer.opt_state) / 1e9
    build.reset_launch_counts()
    # --- the trainer path: TRAIN_STEPS train steps --------------------------
    rows = [trainer.train_step() for _ in range(TRAIN_STEPS)]
    launches = _path_launches("trainer path", ("quant_act", "quant_weight", "fp8_gemm",
                                               "paged_decode"), _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["quant_weight"] == SYNC_LEAVES * TRAIN_STEPS,
          f"trainer path: kernel 2 launched {launches['quant_weight']} times for "
          f"{TRAIN_STEPS} syncs of {SYNC_LEAVES} leaves")
    keys = ("step", "loss", "grad_norm", "reward_mean", "response_len_mean", "mismatch_kl",
            "corr_weight_mean", "corr_weight_ess", "sync_ms", "rollout_s", "score_backward_ms",
            "optimizer_ms", "step_s", "rollout_tokens_per_s")
    for m in rows:
        _finite_metrics(m, f"train step {m['step']}")
        log("train step: " + json.dumps({k: m[k] for k in keys}))
    stats["train_launches"] = launches
    stats["train_steps"] = [{k: m[k] for k in keys} for m in rows]

    adv = np.repeat(np.random.default_rng(SEED).normal(size=rl.prompt_batch), rl.n_per_prompt)
    advantages = torch.tensor(adv, dtype=torch.float32, device=dev)

    # FP8 against BF16 rollout: the same prompts and generator seed, each
    # trajectory scored by the policy the train steps left
    for name, row in score_rollouts(trainer, {"fp8": prec, "bf16": BF16_ROLLOUT},
                                    dev).items():
        stats[f"{name}_rollout"] = row
    log("same prompts, FP8 vs BF16 rollout scored by the bf16 policy: fp8 "
        + json.dumps(stats["fp8_rollout"]) + "; bf16 " + json.dumps(stats["bf16_rollout"]))

    # one update with nonzero advantages on the last trajectory (with random
    # weights every reward ties at 0 and the DAPO mask zeroes the loss)
    batch = dict(trainer.last_update_batch)
    batch["advantages"], batch["mask"] = advantages, batch["response_mask"]
    before_sync = _sync_fingerprint(trainer.params, prec)
    # layer 0 of each stacked leaf, the others whole
    def probe(k, v):
        return v[0] if k.startswith("blocks") else v
    before = {k: probe(k, v).clone() for k, v in flatten_tree(trainer.params)}
    timings = {}
    _, opt_state, upd = trainer.update_fn(trainer.params, trainer.opt_state, batch, timings)
    upd = stats_to_host(upd)
    _finite_metrics(upd, "nonzero-advantage update")
    check(upd["grad_norm"] > 0, f"grad_norm {upd['grad_norm']}")
    after_loss = float(trainer.batch_loss(trainer.params, batch)[0])
    moved, still = [], []
    for k, v in flatten_tree(trainer.params):
        m = opt_state.m
        for part in k.split("/"):
            m = m[part]
        check(bool(m.data.view(torch.uint8).any()), f"{k}: no gradient reached its moment")
        (still if torch.equal(before[k], probe(k, v)) else moved).append(k)
    # lr x |update| <= 3e-4 is under half a bf16 ulp of the norm scales' 1.0
    check(all(k.endswith("norm_scale") for k in still), f"params unchanged: {still}")
    after_sync = _sync_fingerprint(trainer.params, prec)
    same = [k for k in before_sync if torch.equal(before_sync[k][0], after_sync[k][0])
            and before_sync[k][1] == after_sync[k][1]]
    check(not same and len(before_sync) == SYNC_LEAVES,
          f"re-sync after the update left the payloads of {same} unchanged")
    stats["update"] = dict(loss_before=upd["loss"], loss_after=after_loss, **timings,
                           **{k: upd[k] for k in ("grad_norm", "clip_scale", "mismatch_kl",
                                                  "corr_weight_mean", "corr_weight_ess")},
                           params_moved=len(moved), params_unchanged=still)
    log("nonzero-advantage update: " + json.dumps(stats["update"]))
    del before, before_sync, after_sync
    stats["update_profile"] = profile_update(trainer, batch, rl.optimizer, timings)

    stats["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["train_peak_gb"] * 1e9 < CARD_BYTES,
          f"trainer peak {stats['train_peak_gb']:.1f} GB is not under 80 GB")
    log("trainer path: " + json.dumps(stats))
    return stats


def profile_update(trainer, batch, opt_cfg, timings):
    """Device busy ms of the update's two halves under torch.profiler —
    the scoring pass + backward, then one more AdamW step on its
    gradients — beside their wall ms from `timings` (the same update,
    unprofiled).  The params move once more: run it last."""
    from repro_torch.optim import update as opt_update
    out = {}
    def top(by_name):
        return [[k[:50], round(ms, 2)] for k, ms in sorted(by_name.items(),
                                                           key=lambda kv: -kv[1])[:5]]
    (_, _, grads), busy, n, by_name = _profile(
        lambda: trainer.loss_and_grads(trainer.params, batch))
    out["score_backward"] = dict(wall_ms=timings["score_backward_ms"], busy_ms=busy,
                                 kernels=n, top_ms=top(by_name))
    _, busy, n, by_name = _profile(lambda: opt_update(trainer.params, grads,
                                                      trainer.opt_state, opt_cfg))
    out["optimizer"] = dict(wall_ms=timings["optimizer_ms"], busy_ms=busy, kernels=n,
                            top_ms=top(by_name))
    log("update profile: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 9: the serving fleet (serving.ServingFrontend) on full qwen3-8b
# ---------------------------------------------------------------------------

def fleet_trainer(dev, cfg):
    """9a: `RLTrainer` with phase 8's config and the fleet rollout backend
    (2 replicas of 8 slots, block size 4): TRAIN_STEPS train steps at
    weight versions 1..TRAIN_STEPS, then one update with advantages drawn
    per GRPO group on the last step's (versioned) trajectory."""
    import numpy as np
    import torch
    from repro_torch.core.fp8_params import count_quantized
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.optim import AdamWConfig
    from repro_torch.rl import RLConfig, RLTrainer
    from repro_torch.rl.trainer import stats_to_host

    rl = RLConfig(precision=PrecisionConfig(), prompt_batch=8, n_per_prompt=4,
                  max_prompt_len=12, max_new_tokens=32, temperature=1.0,
                  optimizer=AdamWConfig(lr=3e-4, b2=0.98, grad_clip=1.0, fp8_moments=True),
                  rollout_backend="fleet", fleet_replicas=2, fleet_max_slots=8,
                  fleet_block_size=FLEET_BLOCK_SIZE)
    stats = {}
    fresh_peak("fleet_train", stats)
    trainer = RLTrainer(cfg, rl, params=Transformer(cfg, dev).init_params(SEED), device=dev)
    resident = torch.cuda.memory_allocated()
    build.reset_launch_counts()
    # --- the fleet trainer path: TRAIN_STEPS train steps --------------------
    rows = [trainer.train_step() for _ in range(TRAIN_STEPS)]
    launches = _path_launches("fleet trainer path", ("quant_act", "quant_weight", "fp8_gemm",
                                                     "paged_decode"), _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["quant_weight"] == SYNC_LEAVES * TRAIN_STEPS,
          f"fleet trainer path: kernel 2 launched {launches['quant_weight']} times for "
          f"{TRAIN_STEPS} pushes of {SYNC_LEAVES} leaves")
    fleet = trainer._fleet
    check(trainer.syncer.version == TRAIN_STEPS
          and [e.weight_version for e in fleet.engines] == [TRAIN_STEPS] * 2,
          f"versions: syncer {trainer.syncer.version}, engines "
          f"{[e.weight_version for e in fleet.engines]}")
    # one live version: what the steps left resident beyond params and
    # moments is one version's fp8 linears and the replicas' KV pools
    version_gb = count_quantized(fleet._fleet_params)["quantized_bytes"] / 1e9
    kv_gb = sum(t.numel() * t.element_size() for e in fleet.engines
                for sd in e.cache["slots"].values() for t in (sd["kv"].k, sd["kv"].v)) / 1e9
    grown_gb = (torch.cuda.memory_allocated() - resident) / 1e9
    keys = ("step", "loss", "grad_norm", "reward_mean", "response_len_mean", "mismatch_kl",
            "corr_weight_mean", "corr_weight_ess", "mismatch_kl_per_version",
            "tokens_per_version", "sync_ms", "push_ms", "rollout_s", "score_backward_ms",
            "optimizer_ms", "step_s", "rollout_tokens_per_s")
    for m in rows:
        _finite_metrics(m, f"fleet train step {m['step']}")
        check(m["tokens_per_version"][0] > 0, "no token at the batch's version")
        log("fleet train step: " + json.dumps({k: m[k] for k in keys}))
    stats["launches"] = launches
    stats["steps"] = [{k: m[k] for k in keys} for m in rows]
    stats["resident_growth_gb"], stats["kv_pools_gb"] = grown_gb, kv_gb
    stats["version_gb"] = version_gb
    check(grown_gb < version_gb + kv_gb + 1.0,
          f"{grown_gb:.2f} GB stayed resident after the steps: more than one weight "
          f"version ({version_gb} GB) and the KV pools ({kv_gb:.2f} GB)")

    adv = np.repeat(np.random.default_rng(SEED).normal(size=rl.prompt_batch), rl.n_per_prompt)
    batch = dict(trainer.last_update_batch)
    check("token_versions" in batch, "the fleet's update batch carries no token versions")
    batch["advantages"] = torch.tensor(adv, dtype=torch.float32, device=dev)
    batch["mask"] = batch["response_mask"]
    timings = {}
    _, _, upd = trainer.update_fn(trainer.params, trainer.opt_state, batch, timings)
    upd = stats_to_host(upd)
    _finite_metrics(upd, "fleet nonzero-advantage update")
    check(upd["grad_norm"] > 0, f"grad_norm {upd['grad_norm']}")
    stats["update"] = dict(**timings, **{k: upd[k] for k in (
        "loss", "grad_norm", "mismatch_kl", "corr_weight_ess", "mismatch_kl_per_version")})
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES,
          f"fleet trainer peak {stats['peak_gb']:.1f} GB is not under 80 GB")
    log("fleet trainer path: " + json.dumps(stats))
    del trainer, fleet
    return stats


def _installed_versions(events):
    """From a launcher's JSONL event rows: rid -> (replica, the version each
    of its tokens must carry), in the order the tokens were produced.  The
    version is the last one whose install event on that replica came at or
    before the step that produced the token, read off the install events'
    step indices alone (not the version a token event carries)."""
    installs, produced = {}, []
    for e in events:
        if e["kind"] == "weights" and not e["staged"]:
            installs.setdefault(e["replica"], []).append((e["step"], e["version"]))
        elif e["kind"] == "prefill" and e["last"]:
            produced.append((e["replica"], e["step"], 0, e["rid"]))
        elif e["kind"] == "decode":
            produced += [(e["replica"], e["step"], 1, rid) for rid in e["rids"]]
    out = {}
    for replica, step, _, rid in sorted(produced):
        version = max((v for s, v in installs.get(replica, ()) if s <= step), default=0)
        out.setdefault(rid, (replica, []))[1].append(version)
    return out


def fleet_serve(dev):
    """9b: `launch.serve.run` as a user runs it: 2 replicas, a freshly
    requantized weight version every 4 fleet steps, 128-token chunks,
    greedy over the launcher's 16-prompt trace, the event log written.
    Every `RequestOutput` the launcher's front end streams is recorded on
    the way out, and each token's version is held against the version
    installed on its replica at the step that produced it."""
    from unittest import mock
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.serving import ServingFrontend
    stats = {}
    fresh_peak("fleet_serve", stats)
    events_path = ROOT / "build" / "chip_smoke_fleet_events.jsonl"
    events_path.parent.mkdir(exist_ok=True)
    streamed = {}
    fleet_step = ServingFrontend.step

    def recording_step(fe):
        outs = fleet_step(fe)
        for o in outs:
            s = streamed.setdefault(o.rid, dict(replica=o.replica, tokens=[], versions=[]))
            s["tokens"] += o.new_token_ids
            s["versions"] += o.new_versions
            if o.finished:
                s["final"] = o.output
        return outs

    build.reset_launch_counts()
    with mock.patch.object(ServingFrontend, "step", recording_step):
        # --- the launcher's fleet path ----------------------------------------
        out = serve.run(["--precision", "default", "--replicas", "2", "--update-every", "4",
                         "--prefill-chunk", "128", "--max-new", str(FLEET_MAX_NEW),
                         "--events-out", str(events_path)])
        launches = _path_launches("launch.serve fleet path", (
            "quant_act", "quant_weight", "fp8_gemm", "paged_decode", "paged_prefill"),
            _quant_ratio(get_config("qwen3-8b")))
        # ------------------------------------------------------------------
    log("launch.serve fleet report: " + json.dumps(out))
    check(out["completed"] == 16 and not out["stalled"], "fleet launcher run incomplete")
    check(launches["quant_weight"] == SYNC_LEAVES * (1 + out["weight_version"]),
          f"kernel 2 launched {launches['quant_weight']} times for "
          f"{1 + out['weight_version']} syncs")
    rows = [json.loads(line) for line in events_path.read_text().splitlines()]
    want = _installed_versions(rows)
    check(sorted(streamed) == list(range(16)) and sorted(want) == list(range(16)),
          f"streamed rids {sorted(streamed)}, produced rids {sorted(want)}")
    for rid, s in sorted(streamed.items()):
        final = s.get("final")
        check(final is not None and s["tokens"] == final.token_ids
              and s["versions"] == final.versions,
              f"rid {rid}: the streamed deltas are not the final output (exactly once)")
        check(want[rid] == (s["replica"], s["versions"]),
              f"rid {rid}: streamed versions {s['versions']} on replica {s['replica']}, "
              f"installed at their steps {want[rid]}")
    spans = sum(len(set(s["versions"])) >= 2 for s in streamed.values())
    check(spans >= 1, "no request spans two weight versions")
    check(sorted({v for s in streamed.values() for v in s["versions"]}) == out["versions_seen"],
          "the streamed versions are not the launcher's versions_seen")
    stats.update(report=out, launches=launches, requests_spanning_versions=spans,
                 tokens_attributed=sum(len(s["versions"]) for s in streamed.values()),
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("fleet serve path: " + json.dumps(stats))
    return stats


def _fleet_run(roll, cfg, prec, dev, prompts, faults=None, trace=False):
    """One greedy fleet run of 2 replicas over `prompts` to completion:
    (rid -> completion, rid -> streamed deltas joined, frontend, per-replica
    accounting, wall s)."""
    import torch
    from repro_torch.obs import StepTracer
    from repro_torch.serving import ServingEngine, ServingFrontend
    engines = [ServingEngine(
        roll, cfg, prec, max_slots=8, max_seq_len=FLEET_MAX_SEQ, prefill_chunk=128,
        block_size=FLEET_BLOCK_SIZE, seed=i, faults=faults, device=dev,
        tracer=StepTracer(replica=i) if trace else None) for i in range(2)]
    ledgers = [[] for _ in engines]
    for eng, ledger in zip(engines, ledgers):
        # the engine through a weak reference: a bound method stored on its
        # own instance would keep a dropped fleet for `gc.collect()`
        def step(me=weakref.ref(eng), ledger=ledger):
            decision = type(me()).step(me())
            ledger.append(decision.accounting())
            return decision
        eng.step = step
    fe = ServingFrontend(engines, tracer=StepTracer(replica=-1)
                         if faults is not None or trace else None)
    for i, p in enumerate(prompts):
        fe.submit(p, max_new=FLEET_MAX_NEW, rid=i)
    streams = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while fe.has_work():
        for o in fe.step():
            streams.setdefault(o.rid, []).extend(o.new_token_ids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report = fe.run()
    finals = {o.rid: list(o.output.token_ids) for o in report.outputs}
    return finals, streams, fe, report, ledgers, wall


def _reconcile(tracer, ledger, tag):
    """Per step: the StepEvent is the decision's accounting and the step's
    prefill / decode / swap events sum to it."""
    steps = [e for e in tracer.events if e.kind == "step"]
    check(len(steps) == len(ledger), f"{tag}: {len(steps)} step events, {len(ledger)} steps")
    by_step = {}
    for e in tracer.events:
        by_step.setdefault(e.step, []).append(e)
    for i, (se, acct) in enumerate(zip(steps, ledger)):
        evs = by_step[i]
        sums = dict(prefill_tokens=sum(e.cost_tokens for e in evs if e.kind == "prefill"),
                    decode_tokens=sum(e.cost_tokens for e in evs if e.kind == "decode"),
                    swap_tokens=sum(e.tokens_moved for e in evs if e.kind == "swap_out")
                    + sum(e.restored_tokens for e in evs if e.kind == "admit"))
        check({k: getattr(se, k) for k in acct} == acct, f"{tag}: step {i} event != accounting")
        check(all(sums[k] == acct[k] for k in sums), f"{tag}: step {i} event sums {sums}")


def fleet_chaos(dev, cfg):
    """9c: the launcher's trace with no weight updates through 2 replicas
    (W8A8 linears, bf16 KV: with an FP8 cache each replica calibrates its
    own KV scales, so a replayed request would read other scales), four
    ways: fault-free, replica 0 crashing for good at its step 2, replica 1
    crashing at its step 3 and rejoining 2 fleet steps later, and under a
    `StepTracer` on every replica.  Then the fault-free and crash runs once
    more under `PrecisionConfig()` (FP8 KV, what the fleet trainer runs),
    held to exactly-once delivery, a failover with replayed tokens, and
    bit-equality with the fault-free fleet of every request that was not
    failed over; a failed-over one keeps the tokens streamed before the
    crash, and past them may differ: the survivor calibrated its KV
    scales on its own first prompts."""
    import numpy as np
    import torch
    from repro_torch.core.precision import FP8_LINEAR_ROLLOUT, PrecisionConfig
    from repro_torch.data import tasks
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.rl import sync_policy_weights
    from repro_torch.serving import CrashFault, FaultInjector, FaultPlan
    stats = {}
    fresh_peak("fleet_chaos", stats)
    params = Transformer(cfg, dev).init_params(SEED)
    rng = np.random.default_rng(SEED)
    prompts = [tasks.sample_problem(rng).prompt_ids for _ in range(16)]

    def crash(**kw):
        return FaultInjector(FaultPlan(crashes=(CrashFault(**kw),)))

    for name, prec in (("fp8_linear", FP8_LINEAR_ROLLOUT), ("default", PrecisionConfig())):
        roll, _ = sync_policy_weights(params, prec)
        build.reset_launch_counts()
        # --- the fleet path, fault-free -------------------------------------
        base, base_streams, _, base_rep, _, wall = _fleet_run(roll, cfg, prec, dev, prompts)
        launches = _path_launches(f"fleet path ({name})", (
            "quant_act", "fp8_gemm", "paged_decode", "paged_prefill"), _quant_ratio(cfg))
        # ------------------------------------------------------------------
        permanent = _fleet_run(roll, cfg, prec, dev, prompts,
                               faults=crash(replica=0, step=2, transient=False))
        moved = {e.rid: e.replayed_tokens for e in permanent[2].tracer.events
                 if e.kind == "redispatch"}
        differ = sum(permanent[0][r] != base[r] for r in base)
        run = dict(wall_s=wall, steps=base_rep.steps, clock_tokens=base_rep.clock_tokens,
                   delivered_tokens=base_rep.delivered_tokens,
                   tokens_per_s=base_rep.delivered_tokens / wall, launches=launches,
                   crash=dict(redispatches=permanent[3].redispatches,
                              replayed_tokens=permanent[3].replayed_tokens,
                              failed_over=len(moved),
                              completions_differing=differ, wall_s=permanent[5]))
        stats[name] = run
        log(f"fleet chaos ({name}): " + json.dumps(run))
        check(len(base) == 16 and all(len(t) > 0 for t in base.values()),
              f"fault-free fleet ({name})")
        check(permanent[3].redispatches >= 1 and permanent[3].replayed_tokens > 0
              and len(moved) == permanent[3].redispatches,
              f"permanent crash ({name}): redispatches {permanent[3].redispatches}, "
              f"replayed {permanent[3].replayed_tokens}, redispatch events {len(moved)}")
        for tag, (got, streams) in (("fault-free", (base, base_streams)),
                                    ("permanent crash", permanent[:2])):
            check(sorted(got) == list(range(16)) and streams == got,
                  f"{tag} ({name}): a request is missing, or a streamed token was "
                  "emitted twice or dropped")
        for r in base:
            k = moved.get(r)
            check(permanent[0][r] == base[r] if k is None
                  else permanent[0][r][:k] == base[r][:k],
                  f"permanent crash ({name}): request {r} "
                  + ("was not failed over and differs" if k is None
                     else f"differs within the {k} tokens streamed before the crash"))
        if name == "default":
            continue                 # the rest needs one KV scale: see the docstring
        transient = _fleet_run(roll, cfg, prec, dev, prompts,
                               faults=crash(replica=1, step=3, transient=True, down_steps=2))
        traced = _fleet_run(roll, cfg, prec, dev, prompts, trace=True)
        for tag, (got, streams, fe, rep, _, _) in (("permanent crash", permanent),
                                                   ("transient crash", transient),
                                                   ("traced", traced)):
            check(got == base, f"{tag}: greedy completions differ from the fault-free "
                               f"fleet's in {sum(got[r] != base[r] for r in base)} requests")
            check(streams == got, f"{tag}: a streamed token was emitted twice or dropped")
        fe, rep = transient[2], transient[3]
        ups = [e for e in fe.tracer.events if e.kind == "replica_up"]
        check(rep.healthy_replicas == 2 and [(e.replica, e.version) for e in ups]
              == [(1, fe.weight_version)], f"transient replica did not rejoin: {ups}")
        check(transient[3].redispatches >= 1, "the transient crash failed nothing over")
        for i, (eng, ledger) in enumerate(zip(traced[2].engines, traced[4])):
            _reconcile(eng.tracer, ledger, f"traced replica {i}")
        run.update(transient=dict(redispatches=transient[3].redispatches,
                                  replayed_tokens=transient[3].replayed_tokens),
                   traced_wall_s=traced[5],
                   events=sum(len(e.tracer.events) for e in traced[2].engines))
        del permanent, transient, traced
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("fleet chaos path: " + json.dumps(stats))
    return stats


def fleet_path(dev, cfg):
    """Phase 9: 9a the fleet trainer, 9b the live-updated launcher fleet,
    9c chaos and the tracer."""
    return dict(trainer=fleet_trainer(dev, cfg), serve=fleet_serve(dev),
                chaos=fleet_chaos(dev, cfg))


# ---------------------------------------------------------------------------
# phase 10: full FP8 (FULL_FP8_ROLLOUT, E2E_FP8, fp8_dot) on full qwen3-8b
# ---------------------------------------------------------------------------

def _build_full_fp8_trainer(cfg, dev, precision):
    """`launch.train.build_trainer` as a user runs it: phase 8's B, lengths
    and fp8 moments under `--precision` (random weights from the seed)."""
    from repro_torch.launch import train as launch_train
    args = launch_train.parser().parse_args([
        "--arch", cfg.name, "--precision", precision, "--prompt-batch", "8",
        "--n-per-prompt", "4", "--max-new-tokens", "32", "--seed", str(SEED),
        "--fp8-moments", "--device", str(dev)])
    return launch_train.build_trainer(args)


def _decode_steps(traj):
    """`generate`'s decode steps: its loop stops before token i once every
    row is done, i.e. at the first all-zero mask column."""
    mask = traj.response_mask.sum(0).cpu()
    return next((i for i in range(len(mask)) if mask[i] == 0), len(mask))


def _step_keys(m):
    """A train step's metrics without its times."""
    return {k: v for k, v in m.items()
            if not k.endswith(("_ms", "_s", "tokens_per_s"))}


def _close(a, b):
    """Equal up to the last bits of a sum (the embedding's backward adds
    with atomics on the card)."""
    import math
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b or math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-9)


def full_fp8_trainer(dev, cfg):
    """10a: `launch.train`'s trainer under `--precision fp8` (FULL_FP8_ROLLOUT):
    TRAIN_STEPS train steps, then the same prompts rolled out under
    FULL_FP8_ROLLOUT, `PrecisionConfig()` and BF16_ROLLOUT and scored by
    the policy; 10b one `--precision e2e-fp8` step from the same seed, held
    equal to 10a's first."""
    import torch
    from repro_torch.core.precision import BF16_ROLLOUT, FULL_FP8_ROLLOUT, PrecisionConfig
    from repro_torch.kernels import build

    stats = {}
    fresh_peak("full_fp8_train", stats)
    trainer = _build_full_fp8_trainer(cfg, dev, "fp8")
    prec = trainer.rl.precision
    check(prec.quantize_attention and not prec.fp8_training
          and trainer.rl.optimizer.fp8_moments, f"10a: precision {prec}")
    build.reset_launch_counts()
    # --- the full-FP8 trainer path: TRAIN_STEPS train steps ----------------
    rows = [trainer.train_step() for _ in range(TRAIN_STEPS)]
    launches = _path_launches("full-FP8 trainer path", ("quant_act", "quant_weight", "fp8_gemm"),
                              _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["quant_weight"] == SYNC_LEAVES * TRAIN_STEPS,
          f"full-FP8 trainer path: kernel 2 launched {launches['quant_weight']} times")
    check(launches["paged_decode"] == 0,
          f"kernel 4 launched {launches['paged_decode']} times under FULL_FP8_ROLLOUT")
    keys = ("step", "loss", "grad_norm", "reward_mean", "response_len_mean", "mismatch_kl",
            "corr_weight_mean", "corr_weight_ess", "sync_ms", "rollout_s", "score_backward_ms",
            "optimizer_ms", "step_s", "rollout_tokens_per_s")
    for m in rows:
        _finite_metrics(m, f"full-FP8 train step {m['step']}")
        log("full-FP8 train step: " + json.dumps({k: m[k] for k in keys}))
    stats["launches"] = launches
    stats["steps"] = [{k: m[k] for k in keys} for m in rows]

    # the same prompts and generator seed under the three presets, each
    # trajectory scored by the policy the steps left (as phase 8); kernel 4
    # runs under PrecisionConfig() only
    presets = {"full_fp8": FULL_FP8_ROLLOUT, "fp8": PrecisionConfig(), "bf16": BF16_ROLLOUT}
    for name, row in score_rollouts(trainer, presets, dev).items():
        want = 0 if presets[name].quantize_attention else cfg.n_layers * row["decode_steps"]
        check(row["kernel4_launches"] == want,
              f"{name} rollout: kernel 4 launched {row['kernel4_launches']} times, "
              f"not {want}")
        stats[f"{name}_rollout"] = row
    log("same prompts, FULL_FP8 vs FP8 vs BF16 rollout scored by the bf16 policy: "
        + json.dumps({k: stats[f"{k}_rollout"] for k in ("full_fp8", "fp8", "bf16")}))
    check(stats["full_fp8_rollout"]["mismatch_kl"] > stats["bf16_rollout"]["mismatch_kl"],
          "the FULL_FP8 rollout's mismatch is not above BF16's")
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"10a peak {stats['peak_gb']:.1f} GB")
    del trainer

    fresh_peak("e2e_fp8_train", stats)
    e2e = _build_full_fp8_trainer(cfg, dev, "e2e-fp8")
    check(e2e.rl.precision.fp8_training, "10b: E2E_FP8 not selected")
    m = e2e.train_step()
    _finite_metrics(m, "E2E_FP8 train step")
    first = _step_keys(rows[0])
    apart = {k: (v, m[k]) for k, v in first.items() if not _close(v, m[k])}
    log("E2E_FP8 step against the FULL_FP8_ROLLOUT step 1 (same seed): "
        + json.dumps({k: m[k] for k in keys}) + f"; metrics apart: {apart}")
    check(not apart, f"the E2E_FP8 step differs from the FULL_FP8_ROLLOUT step: {apart}")
    stats["e2e_step"] = {k: m[k] for k in keys}
    stats["e2e_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del e2e
    log("full-FP8 trainer: " + json.dumps(stats))
    return stats


def full_fp8_fleet(dev, cfg):
    """10c: one train step with the fleet rollout backend under
    FULL_FP8_ROLLOUT: the replicas' default kernels resolve to the plain
    QDQ attention (no kernel 4 or 5), as the reference's engines run."""
    import torch
    from repro_torch.core.precision import FULL_FP8_ROLLOUT
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.optim import AdamWConfig
    from repro_torch.rl import RLConfig, RLTrainer
    rl = RLConfig(precision=FULL_FP8_ROLLOUT, prompt_batch=8, n_per_prompt=4,
                  max_prompt_len=12, max_new_tokens=32, temperature=1.0,
                  optimizer=AdamWConfig(lr=3e-4, b2=0.98, grad_clip=1.0, fp8_moments=True),
                  rollout_backend="fleet", fleet_replicas=2, fleet_max_slots=8,
                  fleet_block_size=FLEET_BLOCK_SIZE)
    stats = {}
    fresh_peak("full_fp8_fleet", stats)
    trainer = RLTrainer(cfg, rl, params=Transformer(cfg, dev).init_params(SEED), device=dev)
    build.reset_launch_counts()
    # --- the full-FP8 fleet path: one train step ----------------------------
    m = trainer.train_step()
    launches = _path_launches("full-FP8 fleet path", ("quant_act", "quant_weight", "fp8_gemm"),
                              _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["paged_decode"] == 0 and launches["paged_prefill"] == 0,
          f"the fleet launched kernels 4/5 under FULL_FP8_ROLLOUT: {launches}")
    check(all(not e.kernels.any for e in trainer._fleet.engines),
          "a replica resolved to kernels under FULL_FP8_ROLLOUT")
    _finite_metrics(m, "full-FP8 fleet train step")
    keys = ("loss", "mismatch_kl", "corr_weight_ess", "push_ms", "rollout_s",
            "score_backward_ms", "optimizer_ms", "step_s", "rollout_tokens_per_s")
    stats.update(launches=launches, step={k: m[k] for k in keys},
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"10c peak {stats['peak_gb']:.1f} GB")
    log("full-FP8 fleet path: " + json.dumps(stats))
    del trainer
    return stats


def fp8_dot_check(dev):
    """10d: `fp8_dot` forward and backward at qwen3-8b's wg shape (the
    scoring pass's 1408 rows, (1408, 4096) @ (4096, 12288)) under both
    recipes, on the card against the plain CPU computation: the quantized
    payloads and scales (kernels 1 and 2 against their plain versions)
    bit-equal; y, dx and dw each within one bf16 rounding (2**-7 relative)
    plus FP8_DOT_ATOL of the output's largest magnitude (the GEMMs' f32
    sums run in another order).  Also its card time beside the bf16
    `_dot`'s, forward + backward."""
    import torch
    from repro_torch.core import fp8_linear
    from repro_torch.core.precision import E4M3, E5M2, Fp8Recipe, ScaleFormat
    from repro_torch.kernels import ops
    m, k, n = FP8_DOT_SHAPE
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen) * k ** -0.5).to(torch.bfloat16)
    g = (torch.randn((m, n), generator=gen)
         * torch.exp(torch.rand((m, n), generator=gen) * 12 - 10)).to(torch.bfloat16)
    stats = {}

    def payload(qt):
        return qt.data.contiguous().view(torch.uint8).cpu(), qt.scales.cpu()

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    xq = [payload(ops.quantize_activation(x.to(d), E4M3)) for d in ("cpu", dev)]
    wq = [payload(ops.quantize_weight(w.to(d), E4M3)) for d in ("cpu", dev)]
    check(same(*xq) and same(*wq), "fp8_dot: x or w payloads differ between kernel and plain")
    for recipe in Fp8Recipe:
        fmt = E5M2 if recipe == Fp8Recipe.HYBRID else E4M3
        gq = [[payload(ops.quantize_activation(t.to(d), fmt)) for d in ("cpu", dev)]
              for t in (g, g.t().contiguous())]
        check(all(same(*p) for p in gq), f"fp8_dot {recipe.value}: gradient payloads differ")
        outs = {}
        for d in ("cpu", dev):
            xr = x.to(d, copy=True).requires_grad_(True)
            wr = w.to(d, copy=True).requires_grad_(True)
            y = fp8_linear.fp8_dot(xr, wr, recipe)
            y.backward(g.to(d))
            outs[d] = [t.detach().cpu().float() for t in (y, xr.grad, wr.grad)]
        errs = {}
        for name, a, b in zip(("y", "dx", "dw"), outs["cpu"], outs[dev]):
            err = (a - b).abs()
            bound = 2 ** -7 * a.abs() + FP8_DOT_ATOL * a.abs().max()
            errs[name] = err.max().item()
            check(bool((err <= bound).all()), f"fp8_dot {recipe.value} {name}: max abs err "
                  f"{errs[name]:.3e} against its bound")
        xr = x.to(dev, copy=True).requires_grad_(True)
        wr = w.to(dev, copy=True).requires_grad_(True)
        gd = g.to(dev)

        def fwd_bwd(fn):
            def run():
                fn(xr, wr).backward(gd)
            return run
        ms = cuda_time_ms(fwd_bwd(lambda a, b: fp8_linear.fp8_dot(a, b, recipe)), reps=5)
        bf16_ms = cuda_time_ms(fwd_bwd(fp8_linear._dot), reps=5)
        stats[recipe.value] = dict(max_abs_err=errs, ms=ms, bf16_dot_ms=bf16_ms)
        log(f"fp8_dot {recipe.value} at ({m}, {k}) @ ({k}, {n}): payloads bit-equal, max abs "
            f"err {json.dumps(errs)} (within 2**-7 relative + {FP8_DOT_ATOL} x max); "
            f"forward + backward {ms:.3f} ms on the card, bf16 _dot {bf16_ms:.3f} ms")
        del xr, wr, gd
    return stats


def full_fp8_path(dev, cfg):
    """Phase 10: 10a-b the trainer under FULL_FP8_ROLLOUT and E2E_FP8, 10c
    the fleet under FULL_FP8_ROLLOUT, 10d `fp8_dot`."""
    return dict(trainer=full_fp8_trainer(dev, cfg), fleet=full_fp8_fleet(dev, cfg),
                fp8_dot=fp8_dot_check(dev))


# ---------------------------------------------------------------------------
# phase 11: breadth, the dense registry at full width and depth
# ---------------------------------------------------------------------------

def hold_attention_kernels(dev, gen, cfg):
    """Kernels 4, 5 and 6 at `cfg`'s (KVH, G, D) against their plain
    versions on phase 3's shapes, within 1e-2 (kernel 6 also within 1e-2 x
    max|plain|, at q and q x PEAKED_Q); stale entries never read.  Returns
    the worst error of each."""
    import torch
    from repro_torch.kernels import fp8_kv_attention as fa
    kvh, d = cfg.n_kv_heads, cfg.d_head
    g = cfg.n_heads // kvh
    errs = {}
    q, kq, vq, ks, vs, tables, lengths, poison = decode_case(dev, gen, kvh=kvh, g=g, d=d)
    out = fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths)
    plain = fa.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lengths)
    kq[poison] = float("nan")
    vq[poison] = float("nan")
    poisoned = fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths)
    torch.cuda.synchronize()
    errs["paged_decode"] = (out.float() - plain.float()).abs().max().item()
    check(torch.allclose(out.float(), plain.float(), rtol=1e-2, atol=1e-2)
          and torch.equal(poisoned.view(torch.int16), out.view(torch.int16)),
          f"{cfg.name}: kernel 4 disagrees with its plain version")
    del kq, vq
    worst = 0.0
    for (b, c), (start, lengths) in PREFILL_CASES.items():
        q, kq, vq, ks, vs, tables, st, ln, poison = prefill_case(
            dev, gen, start, lengths, c, kvh=kvh, g=g, d=d)
        out = fa.fp8_paged_prefill_attention(q, kq, vq, ks, vs, tables, st, ln)
        plain = fa.fp8_paged_prefill_attention_ref(q, kq, vq, ks, vs, tables, st, ln)
        kq[poison] = 448.0
        vq[poison] = 448.0
        poisoned = fa.fp8_paged_prefill_attention(q, kq, vq, ks, vs, tables, st, ln)
        torch.cuda.synchronize()
        worst = max(worst, (out.float() - plain.float()).abs().max().item())
        check(torch.allclose(out.float(), plain.float(), rtol=1e-2, atol=1e-2)
              and torch.equal(poisoned.view(torch.int16), out.view(torch.int16)),
              f"{cfg.name}: kernel 5 disagrees with its plain version (B {b}, C {c})")
        del kq, vq
    errs["paged_prefill"] = worst
    q, kq, vq, ks, vs, ln = contiguous_case(dev, gen, 8, 1057, [1057, 1, 0, 300, 512, 999,
                                                                64, 700], kvh=kvh, g=g, d=d)
    worst = 0.0
    for q_scale in (1.0, PEAKED_Q):
        qs = (q.float() * q_scale).to(q.dtype)
        out = fa.fp8_decode_attention(qs, kq, vq, ks, vs, ln).float()
        plain = fa.fp8_decode_attention_ref(qs, kq, vq, ks, vs, ln).float()
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        check(torch.allclose(out, plain, rtol=DECODE_TOL, atol=DECODE_TOL)
              and err <= DECODE_TOL * plain.abs().max().item(),
              f"{cfg.name}: kernel 6 disagrees with its plain version at q x {q_scale:g}")
        worst = max(worst, err)
    errs["decode"] = worst
    log(f"{cfg.name} (KVH {kvh}, G {g}, D {d}): kernels 4/5/6 vs plain, max abs err "
        + json.dumps(errs) + " (tol 1e-2)")
    return errs


def _slot_launches(cfg, spec, prefill=False):
    """Kernel 1 and kernel 3 launches of one layer, one kernel-1 call per
    distinct linear input: attention 2 : 4 (q/k/v share one), an SSM mixer
    2 : 2 (w_in, w_out); an enc-dec decoder's cross attention 2 : 2 at
    decode (q, wo over the cross cache) and 3 : 4 at prefill (its k/v from
    the encoder output share one, then q and wo); a gated MLP 2 : 3 (wu
    shares wg's input), a two-matrix MLP or an MoE layer (the experts' fc1
    and fc2) 2 : 2."""
    q, g = 2, (4 if spec.mixer == "attn" else 2)
    if spec.cross:
        q, g = q + (3 if prefill else 2), g + (4 if prefill else 2)
    if spec.ffn is not None:
        q, g = q + 2, g + (3 if spec.ffn == "mlp" and cfg.mlp_gated else 2)
    return q, g


def _quant_ratio(cfg):
    """Kernel 1 : kernel 3 launches of one period of `cfg`'s layer pattern
    at decode (`_slot_launches`).  Dense gated 4 : 7, starcoder2 and MoE
    4 : 6, mamba2 2 : 2, jamba's period 32 : 38, seamless 6 : 8."""
    from repro_torch.models.blocks import layer_pattern
    q = g = 0
    for spec in layer_pattern(cfg):
        a, b = _slot_launches(cfg, spec)
        q, g = q + a, g + b
    return q, g


def _forward_launches(cfg, prefill):
    """(kernel 1, kernel 3) launches of one forward of the whole model: a
    decode step, or a prefill — whose prefix (a VLM's patches, an enc-dec
    model's frames) takes w_patch (1 : 1), and whose encoder layers run
    as decoder layers without cross attention.  Seamless: a prefill
    1 + 12 x 4 + 12 x 7 = 133 : 1 + 12 x 6 + 12 x 10 = 193, a decode
    step 72 : 96; pixtral: a prefill 161 : 281, a decode step 160 : 280."""
    from repro_torch.models.blocks import layer_pattern, n_repeats
    q = g = 0
    stacks = [(layer_pattern(cfg), n_repeats(cfg))]
    if prefill and cfg.is_encdec:
        stacks.append((layer_pattern(cfg, decoder=False), n_repeats(cfg, decoder=False)))
    for pattern, repeats in stacks:
        for spec in pattern:
            a, b = _slot_launches(cfg, spec, prefill)
            q, g = q + a * repeats, g + b * repeats
    if prefill and cfg.frontend is not None:
        q, g = q + 1, g + 1
    return q, g


def check_forward_launches(launches, tag, cfg, prefills, decodes):
    """Kernel 1 and kernel 3 launched exactly as `prefills` prefills and
    `decodes` decode steps of `cfg` launch them (`_forward_launches`)."""
    (pq, pg), (dq, dg) = _forward_launches(cfg, True), _forward_launches(cfg, False)
    want = (prefills * pq + decodes * dq, prefills * pg + decodes * dg)
    got = (launches["quant_act"], launches["fp8_gemm"])
    check(got == want, f"{tag}: kernel 1 and kernel 3 launched {got} times, not {want} "
                       f"({prefills} prefills, {decodes} decode steps)")


def _sync_leaves(cfg):
    """Kernel-2 launches of one sync: the quantized (layer-stacked) leaves
    of one period of the pattern — wq, wk, wv, wo or an SSM mixer's w_in
    and w_out, an enc-dec decoder's cross wq, wk, wv, wo, then the MLP's
    (wg, wu, wd; no wu without the gate) or the experts' fc1 and fc2; the
    router stays bf16 under `PrecisionConfig()` — and the same of the
    encoder's pattern, and w_patch.  Dense 7 (starcoder2 6), MoE 6,
    mamba2 2, jamba's period 38, seamless 10 + 6 + 1, pixtral 7 + 1."""
    from repro_torch.models.blocks import layer_pattern
    n = 1 if cfg.frontend is not None else 0
    patterns = [layer_pattern(cfg)] + ([layer_pattern(cfg, decoder=False)]
                                       if cfg.is_encdec else [])
    for pattern in patterns:
        for spec in pattern:
            n += 4 if spec.mixer == "attn" else 2
            n += 4 if spec.cross else 0
            if spec.ffn == "mlp":
                n += 3 if cfg.mlp_gated else 2
            elif spec.ffn == "moe":
                n += 2
    return n


def model_paths(dev, cfg, roll, prec, stats, gemms=("fp8_gemm",)):
    """A greedy `generate` (8 prompts, 32 tokens), decode-step logits
    through the kernels held against the plain versions, a
    `ServingEngine(kernel_config "all", prefill_chunk 128)` run of 8
    requests, a `launch.steps` prefill at (B 8, S 1056) and BREADTH_STEPS
    serve steps, each path's launches counted (`gemms`: the kernel-3
    launches the model runs).  Fills `stats`; returns the greedy
    trajectory."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.rl import SamplerConfig, generate
    from repro_torch.serving import ServingEngine
    ratio = _quant_ratio(cfg)
    model = Transformer(cfg, dev)
    prompts, lengths = make_prompts(np.random.default_rng(SEED))
    greedy = SamplerConfig(max_new_tokens=32, temperature=0.0)

    build.reset_launch_counts()
    # --- generate -----------------------------------------------------------
    traj, gen_ms = _sync_ms(lambda: generate(roll, prompts, lengths, None, cfg, prec, greedy,
                                             page_size=16, device=dev))
    launches = _path_launches(f"{cfg.name} generate", ("quant_act", *gemms, "paged_decode"),
                              ratio)
    # ----------------------------------------------------------------------
    check(launches["paged_decode"] == cfg.n_layers * _decode_steps(traj),
          f"{cfg.name}: kernel 4 launches {launches['paged_decode']}")
    check_trajectory(traj, 8, 32, cfg.vocab_size, f"{cfg.name} greedy")
    stats.update(generate_s=gen_ms / 1e3,
                 generate_tokens_per_s=float(traj.response_mask.sum()) / (gen_ms / 1e3),
                 generate_launches=launches)
    stats["decode_logit_max_abs_err"] = decode_logits_check(model, roll, prec, prompts,
                                                            lengths, dev)

    trace = engine_trace(n=8)
    eng = ServingEngine(roll, cfg, prec, max_slots=8, max_seq_len=ENGINE_MAX_SEQ,
                        block_size=ENGINE_BLOCK_SIZE, admission="ondemand",
                        prefill_chunk=128, kernel_config="all", eos_id=None, device=dev)
    for i, p in enumerate(trace):
        eng.submit(p, max_new=ENGINE_MAX_NEW, rid=i)
    build.reset_launch_counts()
    # --- the serving engine -------------------------------------------------
    rep, eng_ms = _sync_ms(lambda: eng.run(max_steps=2000))
    launches = _path_launches(f"{cfg.name} engine", ("quant_act", *gemms, "paged_decode",
                                                      "paged_prefill"), ratio)
    # ----------------------------------------------------------------------
    check_engine_report(eng, rep, len(trace), f"{cfg.name} engine")
    stats.update(engine_s=eng_ms / 1e3, engine_tokens_per_s=rep.emitted_tokens / (eng_ms / 1e3),
                 engine_launches=launches)
    del eng

    shape = ShapeConfig("breadth", CONTIG_SHAPE[1], 8, "prefill")
    cprompts, clengths = make_prompts(np.random.default_rng(SEED + 7), b=8, lo=512, hi=1024)
    tokens = np.zeros((8, shape.seq_len), np.int32)
    tokens[:, :cprompts.shape[1]] = cprompts
    batch = {"tokens": torch.from_numpy(tokens).to(dev), "lengths": torch.from_numpy(clengths)}
    prefill_step = steps.make_prefill_step(cfg, shape, prec, device=dev)
    serve_step = steps.make_serve_step(cfg, prec, device=dev)
    build.reset_launch_counts()
    # --- launch.steps: prefill, then BREADTH_STEPS serve steps --------------
    (logits, cache), prefill_ms = _sync_ms(prefill_step, roll, batch)
    step_ms = []
    for _ in range(BREADTH_STEPS):
        (logits, cache), ms = _sync_ms(serve_step, roll, logits.argmax(-1), cache)
        step_ms.append(ms)
    launches = _path_launches(f"{cfg.name} launch.steps", ("quant_act", *gemms, "decode"),
                              ratio)
    # ----------------------------------------------------------------------
    check(launches["decode"] == cfg.n_layers * BREADTH_STEPS,
          f"{cfg.name}: kernel 6 launched {launches['decode']} times")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: serve-step logits not finite")
    del cache
    stats.update(steps_prefill_ms=prefill_ms, serve_step_ms=step_ms, steps_launches=launches)
    return traj


def breadth_model(dev, gen, cfg):
    """One dense model at full width and depth: random weights, a sync,
    `model_paths`, kernels 4-6 at the model's heads, the peak."""
    import torch
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.rl import sync_policy_weights
    prec = PrecisionConfig()
    leaves = _sync_leaves(cfg)
    stats = {}
    fresh_peak(cfg.name, stats)
    params, init_ms = _sync_ms(Transformer(cfg, dev).init_params, SEED)
    build.reset_launch_counts()
    roll, sync_stats = sync_policy_weights(params, prec)
    check(build.LAUNCHES["quant_weight"] == leaves,
          f"{cfg.name}: kernel 2 launched {build.LAUNCHES['quant_weight']} times for {leaves}")
    del params               # the rollout tree keeps the leaves it shares
    stats.update(init_ms=init_ms, sync_ms=sync_stats["sync_ms"])
    model_paths(dev, cfg, roll, prec, stats)
    stats["kernel_errs"] = hold_attention_kernels(dev, gen, cfg)
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"{cfg.name} peak {stats['peak_gb']:.1f} GB")
    log(f"breadth {cfg.name}: " + json.dumps(stats))
    del roll
    return stats


def breadth_path(dev, gen):
    """Phase 11: each of BREADTH at full width and depth, one after the
    other."""
    from repro_torch.configs import get_config
    return {name: breadth_model(dev, gen, get_config(name)) for name in BREADTH}


# ---------------------------------------------------------------------------
# phase 12: MoE at full width and depth
# ---------------------------------------------------------------------------

def leafwise_sync(model, prec, stats):
    """`sync_policy_weights(model.init_params(SEED), prec)` one leaf at a
    time: each bf16 leaf is drawn (`Transformer.iter_params`), quantized
    (`core.fp8_params.quantize_leaf`, the sync's own function) and dropped
    before the next is drawn — the same rollout tree, without the whole
    bf16 tree (61 GB at qwen3-30b-a3b) beside its fp8 copy.  Puts the
    draw and sync ms (device synchronized around each leaf), the fc1
    leaf's sync ms and the peak into `stats`.  Kernel 2 takes the fc1
    leaf in one launch (a grid of L·E = 6144 slices, 1.93e10 elements):
    its last slice, past 2^31 elements, is held bit-equal to the plain
    version."""
    import torch
    from repro_torch.core.fp8_params import quantize_leaf
    from repro_torch.kernels import fp8_quant as fq
    roll, draw_ms, sync_ms = {}, 0.0, 0.0
    leaves = model.iter_params(SEED)
    while True:
        got, ms = _sync_ms(next, leaves, None)
        draw_ms += ms
        if got is None:
            break
        path, leaf = got
        q, ms = _sync_ms(quantize_leaf, "/".join(path), leaf, prec)
        sync_ms += ms
        if path[-1] == "fc1":
            stats["fc1_sync_ms"] = ms
            wq, ws = fq.quantize_weight_ref(leaf[-1, -1])
            check(torch.equal(q.data[-1, -1].contiguous().view(torch.uint8),
                              wq.view(torch.uint8)) and torch.equal(q.scales[-1, -1], ws),
                  f"kernel 2 on the fc1 leaf {tuple(leaf.shape)}: its last slice differs "
                  "from the plain version")
            del wq, ws
        tree = roll
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = q
        del got, leaf, q
    stats.update(draw_ms=draw_ms, sync_ms=sync_ms,
                 sync_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return roll


def routed_drops(routing, cfg):
    """The share of (token, k) units an MoE layer drops, from a prefill's
    routing {slot: (R, B, T, K)} (one group per row, capacity
    `group_capacity(T)`), over every layer and row."""
    import torch
    from repro_torch.models.moe import group_capacity
    dropped = units = 0
    for idx in routing.values():
        r, b, t, k = idx.shape
        counts = torch.zeros((r * b, cfg.n_experts), dtype=torch.long, device=idx.device)
        counts.scatter_add_(1, idx.reshape(r * b, t * k).long(),
                            torch.ones((r * b, t * k), dtype=torch.long, device=idx.device))
        dropped += int((counts - group_capacity(t, cfg)).clamp_min(0).sum())
        units += idx.numel()
    return dropped / max(units, 1)


def moe_gemm_row(stack, m, gen):
    """The expert-batched kernel 3 on a (L, E, K, N) expert stack at M rows
    an expert: bit-equal per expert to the 2-D kernel on that expert alone,
    within one bf16 rounding of the plain version; then its times, each
    call on the next layer's experts (cold in L2), and the bound (the
    experts' weight bytes, every expert's M rows, padding included)."""
    import itertools

    import torch
    from repro_torch.kernels import fp8_gemm as fg
    from repro_torch.kernels import fp8_quant as fq
    layers, e, k, n = stack.data.shape
    dev = stack.data.device
    x = torch.randn((e * m, k), generator=gen, device=dev).to(torch.bfloat16)
    a, a_s = fq.quantize_activation_kernel(x)
    a, a_s = a.view(e, m, k), a_s.view(e, m, k // 128)
    w = stack.layer(0)
    y = fg.fp8_gemm_batched(a, w.data, a_s, w.scales)
    for i in range(e):
        one = fg.fp8_gemm(a[i], w.data[i], a_s[i], w.scales[i])
        check(torch.equal(y[i].view(torch.int16), one.view(torch.int16)),
              f"batched fp8_gemm E {e} M {m} K {k} N {n}: expert {i} differs from the 2-D kernel")
    yp = fg.fp8_gemm_batched_ref(a, w.data, a_s, w.scales).float()
    torch.cuda.synchronize()
    err = (y.float() - yp).abs().max().item()
    scale = yp.abs().max().item()
    check(bool(torch.isfinite(y).all()) and torch.allclose(y.float(), yp, rtol=2 ** -7,
                                                           atol=1e-5 * scale),
          f"batched fp8_gemm E {e} M {m} K {k} N {n}: kernel disagrees with its plain version")
    ws = itertools.cycle([stack.layer(r) for r in range(layers)])

    def kernel():
        w = next(ws)
        return fg.fp8_gemm_batched(a, w.data, a_s, w.scales)

    def plain():
        w = next(ws)
        return fg.fp8_gemm_batched_ref(a, w.data, a_s, w.scales)
    row = timed_row(kernel, plain, reps=20, plain_reps=2, plain_warmup=1)
    nbytes = e * (m * k + k * n + m * (k // 128) * 4 + (k // 128) * (n // 128) * 4 + m * n * 2)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * e * m * n * k, FP8_TC_FLOPS)
    row["max_abs_err"] = err
    log(f"fp8_gemm batched E {e} M {m} K {k} N {n}: every expert bit-equal to the 2-D kernel; "
        f"max|kernel-plain| {err:.3e} (max|plain| {scale:.3f}); device {row['device_ms']:.4f} "
        f"ms (bound {row['bound_ms']:.4f}, {row['bound_by']}), ms {row['ms']:.4f}, plain "
        f"{row['plain_ms']:.2f}")
    return row


def moe_serve_path(dev, gen, results, extra):
    """12a: qwen3-30b-a3b at full width and depth under `PrecisionConfig()`:
    the leafwise sync, greedy and GRPO `generate` (routing recorded),
    `model_paths` (decode logits, the engine, `launch.steps`), the
    expert-batched kernel 3 at E 128 held and timed, the peak."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.rl import SamplerConfig, generate
    cfg = get_config(MOE_SERVE)
    prec = PrecisionConfig()
    gemms = ("fp8_gemm", "fp8_gemm_batched")
    stats = {}
    fresh_peak(cfg.name, stats)
    model = Transformer(cfg, dev)
    build.reset_launch_counts()
    roll = leafwise_sync(model, prec, stats)
    check(build.LAUNCHES["quant_weight"] == _sync_leaves(cfg),
          f"{cfg.name}: kernel 2 launched {build.LAUNCHES['quant_weight']} times")
    log(f"{cfg.name}: {cfg.n_layers} layers, {cfg.n_experts} experts top-{cfg.top_k}, "
        f"{cfg.param_count() / 1e9:.2f}B params drawn and synced leaf by leaf: "
        + json.dumps(stats))

    prompts, lengths = make_prompts(np.random.default_rng(SEED))
    build.reset_launch_counts()
    # --- the MoE main path: greedy and GRPO generate -------------------------
    greedy, g_ms = _sync_ms(lambda: generate(
        roll, prompts, lengths, None, cfg, prec, SamplerConfig(max_new_tokens=32,
                                                               temperature=0.0),
        page_size=16, want_routing=True, device=dev))
    sampler = torch.Generator(device=dev).manual_seed(SEED)
    group, grp_ms = _sync_ms(lambda: generate(
        roll, prompts, lengths, sampler, cfg, prec, SamplerConfig(max_new_tokens=32),
        page_size=16, num_samples_per_prompt=4, shared_prefix_blocks=int(lengths.min()) // 16,
        device=dev))
    launches = _path_launches(f"{cfg.name} rollout path",
                              ("quant_act", *gemms, "paged_decode"), _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    results["fp8_gemm_batched"]["launches"] = launches["fp8_gemm_batched"]
    forwards = 2 + _decode_steps(greedy) + _decode_steps(group)
    check(launches["fp8_gemm_batched"] == 2 * cfg.n_layers * forwards,
          f"{cfg.name}: kernel 3 batched {launches['fp8_gemm_batched']} times, not twice a "
          f"layer in each of {forwards} forwards")
    check_trajectory(greedy, 8, 32, cfg.vocab_size, f"{cfg.name} greedy")
    check_trajectory(group, 32, 32, cfg.vocab_size, f"{cfg.name} group")
    pre = greedy.routing["prefill"]["s0"]
    check(tuple(pre.shape) == (cfg.n_layers, 8, prompts.shape[1], cfg.top_k)
          and tuple(greedy.routing["decode"]["s0"].shape) == (32, cfg.n_layers, 8, 1,
                                                               cfg.top_k),
          f"{cfg.name}: routing shapes {tuple(pre.shape)}")
    stats.update(rollout_launches=launches, greedy_generate_s=g_ms / 1e3,
                 group_generate_s=grp_ms / 1e3,
                 greedy_tokens_per_s=float(greedy.response_mask.sum()) / (g_ms / 1e3),
                 group_tokens_per_s=float(group.response_mask.sum()) / (grp_ms / 1e3),
                 prefill_dropped_frac=routed_drops(greedy.routing["prefill"], cfg))
    del greedy, group
    stats.update(profile_decode_step(model, roll, prec, prompts, lengths, dev, "moe_"))
    model_paths(dev, cfg, roll, prec, stats, gemms)

    rows = {}
    for name in ("fc1", "fc2"):
        stack = roll["blocks"]["s0"]["moe"][name]
        for m in MOE_GEMM_MS:
            row = moe_gemm_row(stack, m, gen)
            _, e, k, n = stack.data.shape
            extra.append(dict(kernel="fp8_gemm_batched", shape=[e, m, k, n], weight=name, **row))
            rows[f"{name}_m{m}"] = {key: row[key] for key in ("ms", "device_ms", "bound_ms")}
            if (name, m) == ("fc1", 8):
                results["fp8_gemm_batched"].update(row)
    results["fp8_gemm_batched"]["max_abs_err"] = max(r["max_abs_err"] for r in extra)
    stats["batched_gemm"] = rows
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"{cfg.name} peak {stats['peak_gb']:.1f} GB")
    log(f"MoE {cfg.name}: " + json.dumps(stats))
    del roll, model
    return stats


def moe_train_path(dev, gen):
    """12b: `RLTrainer` on granite-moe-3b-a800m at full width and depth under
    `PrecisionConfig()` with rollout router replay on, phase 8's geometry,
    f32 AdamW moments: TRAIN_STEPS train steps (routing recorded, a finite
    `moe_aux_loss`), the same prompts rolled out under router BF16, FP32
    and FP8 and under BF16_ROLLOUT and scored side by side (the paper's
    fig. 6 comparison: a report, not a gate), kernels 4-6 at (G 3, D 64)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.precision import BF16_ROLLOUT, PrecisionConfig, RouterDtype
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.optim import AdamWConfig, state_bytes
    from repro_torch.rl import RLConfig, RLTrainer
    from repro_torch.rl import trainer as trainer_mod
    cfg = get_config(MOE_TRAIN)
    prec = PrecisionConfig(rollout_router_replay=True)
    rl = RLConfig(precision=prec, prompt_batch=8, n_per_prompt=4, max_prompt_len=12,
                  max_new_tokens=32, temperature=1.0,
                  optimizer=AdamWConfig(lr=3e-4, b2=0.98, grad_clip=1.0))
    stats = {}
    fresh_peak(cfg.name, stats)
    trainer = RLTrainer(cfg, rl, params=Transformer(cfg, dev).init_params(SEED), device=dev)
    stats["opt_state_gb"] = state_bytes(trainer.opt_state) / 1e9
    routings = []
    real = trainer_mod.generate

    def recording(*args, **kw):
        traj = real(*args, **kw)
        routings.append(traj.routing)
        return traj
    build.reset_launch_counts()
    # --- the MoE trainer path: TRAIN_STEPS train steps -----------------------
    with mock.patch.object(trainer_mod, "generate", recording):
        rows = [trainer.train_step() for _ in range(TRAIN_STEPS)]
    launches = _path_launches(f"{cfg.name} trainer path", (
        "quant_act", "quant_weight", "fp8_gemm", "fp8_gemm_batched", "paged_decode"),
        _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["quant_weight"] == _sync_leaves(cfg) * TRAIN_STEPS,
          f"{cfg.name} trainer: kernel 2 launched {launches['quant_weight']} times")
    r, k = cfg.n_layers, cfg.top_k
    for routing in routings:
        pre, dec = routing["prefill"]["s0"], routing["decode"]["s0"]
        check(pre.shape[0] == r and pre.shape[1] == rl.prompt_batch and pre.shape[3] == k
              and tuple(dec.shape) == (rl.max_new_tokens, r, rl.rollout_batch, 1, k),
              f"{cfg.name} trainer: routing shapes {tuple(pre.shape)}, {tuple(dec.shape)}")
    check(len(routings) == TRAIN_STEPS, f"{cfg.name} trainer: {len(routings)} routings recorded")
    keys = ("step", "loss", "moe_aux_loss", "grad_norm", "mismatch_kl", "corr_weight_ess",
            "sync_ms", "rollout_s", "score_backward_ms", "optimizer_ms", "step_s")
    for m in rows:
        _finite_metrics(m, f"{cfg.name} train step {m['step']}")
        log(f"{cfg.name} train step: " + json.dumps({key: m[key] for key in keys}))
    stats.update(launches=launches, steps=[{key: m[key] for key in keys} for m in rows],
                 routing_prefill_shape=list(routings[0]["prefill"]["s0"].shape))
    presets = {f"router_{rd.value}": PrecisionConfig(router_dtype=rd)
               for rd in (RouterDtype.BF16, RouterDtype.FP32, RouterDtype.FP8)}
    presets["bf16"] = BF16_ROLLOUT
    stats["rollouts"] = score_rollouts(trainer, presets, dev)
    log(f"{cfg.name}, same prompts, router BF16 / FP32 / FP8 (W8A8 + FP8 KV) and BF16 rollout "
        "scored by the policy: " + json.dumps(stats["rollouts"]))
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"{cfg.name} trainer peak "
          f"{stats['peak_gb']:.1f} GB")
    del trainer
    stats["kernel_errs"] = hold_attention_kernels(dev, gen, cfg)
    log(f"MoE trainer {cfg.name}: " + json.dumps(stats))
    return stats


def moe_path(dev, gen, results, extra):
    """Phase 12: 12a then 12b."""
    return {"serve": moe_serve_path(dev, gen, results, extra),
            "train": moe_train_path(dev, gen)}


# ---------------------------------------------------------------------------
# phase 13: SSM and hybrid at full width
# ---------------------------------------------------------------------------

def state_engine_runs(roll, cfg, prec, dev, trace, slots, block_size, stats, tag, need,
                      frames=None, **engine_kw):
    """The engine over `trace` twice on the same synced weights: roomy, then
    with its budget cut to SHRINK_FRAC after SHRINK_AT decode steps (the
    launcher's `--shrink-at`), so that victims' SSM or cross rows (and KV
    blocks) go to the host and come back.  Greedy completions must be
    bit-equal, with at least one swap-in.  Launch counts are zeroed before
    and read after the two runs (`need`; an enc-dec model's exactly, by
    its prefills and decode steps).  `frames[i]` go with request i;
    `engine_kw` override the engine's arguments (an enc-dec engine
    prefills one-shot).  Fills `stats`; returns the roomy run's report."""
    from repro_torch.kernels import build
    from repro_torch.serving import ServingEngine

    def engine():
        kw = dict(max_slots=slots, max_seq_len=ENGINE_MAX_SEQ, block_size=block_size,
                  admission="ondemand", prefill_chunk=128, eos_id=None, device=dev)
        kw.update(engine_kw)
        eng = ServingEngine(roll, cfg, prec, **kw)
        for i, p in enumerate(trace):
            eng.submit(p, max_new=ENGINE_MAX_NEW, rid=i,
                       frames=None if frames is None else frames[i])
        return eng

    def cut(eng):
        full = eng.budget_tokens
        while eng.stats["steps"] < SHRINK_AT:
            eng.step()
        eng.budget_tokens = int(full * SHRINK_FRAC)
        return eng.run(max_steps=4000)
    roomy, tight = engine(), engine()
    build.reset_launch_counts()
    # --- the serving engine: roomy, then under a budget cut ------------------
    rep_roomy, roomy_ms = _sync_ms(lambda: roomy.run(max_steps=4000))
    rep_tight, tight_ms = _sync_ms(cut, tight)
    launches = _path_launches(f"{tag} engine", need,
                              None if cfg.is_encdec else _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    if cfg.is_encdec:       # one-shot prefills: one per request and run
        check_forward_launches(launches, f"{tag} engine", cfg, 2 * len(trace),
                               rep_roomy.steps + rep_tight.steps)
    check_engine_report(roomy, rep_roomy, len(trace), f"{tag} roomy")
    check_engine_report(tight, rep_tight, len(trace), f"{tag} under the cut")
    check(rep_roomy.preemptions == 0 and rep_tight.swap_ins >= 1,
          f"{tag}: the budget cut forced no swap ({rep_tight.preemptions} preemptions, "
          f"{rep_tight.swap_ins} swap-ins)")
    want = {r.rid: r.generated for r in rep_roomy.completed}
    got = {r.rid: r.generated for r in rep_tight.completed}
    check(got == want, f"{tag}: preempted completions differ from the roomy run's")
    stats.update(engine_launches=launches, engine_roomy_s=roomy_ms / 1e3,
                 engine_tight_s=tight_ms / 1e3,
                 engine_tokens_per_s=rep_roomy.emitted_tokens / (roomy_ms / 1e3),
                 engine_preemptions=rep_tight.preemptions, engine_swap_ins=rep_tight.swap_ins,
                 engine_wasted_tokens=rep_tight.wasted_tokens,
                 engine_state_swap_tokens=tight.state_swap_tokens,
                 engine_state_blocks=tight.state_blocks,
                 engine_kernel_config=tight.kernels.name)
    log(f"{tag} engine: roomy and cut runs bit-equal over {len(trace)} requests; the cut "
        f"preempted {rep_tight.preemptions} (swap-ins {rep_tight.swap_ins}, wasted "
        f"{rep_tight.wasted_tokens} tokens, {tight.state_blocks} state blocks a request)")
    return rep_roomy


def chunked_state_check(model, roll, prec, dev, prompt, tag):
    """A chunked prefill (C 128, a ragged last chunk) against the one-shot
    prefill of the same prompt on an attention-free model (no KV, so no
    scale calibration to match), run twice.  Free-running: the first SSM
    layer's state within 1e-3 of its largest entry (its input rows are
    bit-equal, kernel 3's rows being independent of M; only the SSD's
    batched products change shape) and next-token logits within
    CHUNK_LOGIT_ATOL.  Deeper layers and the free-running logits are
    logged, not held: a last-bit difference that moves an activation
    across an fp8 rounding boundary (kernel 1) grows layer by layer
    through random weights.  Teacher-forced: every layer of the chunked
    run takes the one-shot run's input rows (the residual stream) for its
    chunk, so no difference passes from layer to layer; every layer's
    state, carried from chunk to chunk through the cache, is held within
    1e-3 of its largest entry, and the next-token logits within
    CHUNK_LOGIT_ATOL."""
    import numpy as np
    import torch
    from repro_torch.data import tasks
    from repro_torch.models import blocks
    n = len(prompt)
    fwd = blocks.apply_slot_full
    inputs = []             # the one-shot run's layer inputs, in layer order
    at = {"call": 0}

    def recording(x, *args, **kw):
        inputs.append(x.detach().clone())
        return fwd(x, *args, **kw)

    def forcing(x, *args, **kw):
        full = inputs[at["call"] % len(inputs)]
        at["call"] += 1
        x = x.clone()
        x[:, :at["c"]] = full[:, at["start"]:at["start"] + at["c"]]
        return fwd(x, *args, **kw)

    def chunked_prefill(mixer):
        cache = model.init_cache(1, n + 1, prec, page_size=16)
        for start in range(0, n, 128):
            at.update(start=start, c=min(128, n - start))
            chunk = np.full((1, 128), tasks.PAD, np.int32)
            chunk[0, :at["c"]] = prompt[start:start + at["c"]]
            with mock.patch.object(blocks, "apply_slot_full", mixer):
                logits, cache = model.prefill_chunk(roll, torch.from_numpy(chunk), [start],
                                                    [at["c"]], cache, prec)
        return logits, cache

    def state_errs(a_cache, b_cache):
        """Per SSM layer, in (repeat, slot) order: the larger of h's and
        the conv tail's largest gap over their largest entry."""
        errs = []
        for r in range(model.repeats):
            for name, sd in a_cache["slots"].items():
                if "ssm" in sd:
                    a, b = sd["ssm"].layer(r), b_cache["slots"][name]["ssm"].layer(r)
                    errs.append(max(
                        ((x.float() - y.float()).abs().max()
                         / x.float().abs().max().clamp_min(1e-30)).item()
                        for x, y in ((a.h, b.h), (a.conv, b.conv))))
        return errs
    one = model.init_cache(1, n + 1, prec, page_size=16)
    with mock.patch.object(blocks, "apply_slot_full", recording):
        l1, one = model.prefill(roll, {"tokens": torch.from_numpy(prompt[None]).to(dev),
                                       "lengths": torch.tensor([n], dtype=torch.int32)},
                                one, prec)
    l2, chunked = chunked_prefill(fwd)
    free = state_errs(one, chunked)
    del chunked
    l3, chunked = chunked_prefill(forcing)
    forced = state_errs(one, chunked)
    del chunked, inputs[:]
    torch.cuda.synchronize()
    err, forced_err = (l1 - l2).abs().max().item(), (l1 - l3).abs().max().item()
    log(f"{tag}: chunked (C 128) vs one-shot prefill of {n} tokens, SSM state over its "
        f"largest entry: free-running, the first layer {free[0]:.2e} (tol 1e-3), the median "
        f"layer {sorted(free)[len(free) // 2]:.2e}, the worst {max(free):.2e}, next-token "
        f"logits {err:.4f}; teacher-forced, the worst of {len(forced)} layers "
        f"{max(forced):.2e} (layer {forced.index(max(forced))}, tol 1e-3), next-token logits "
        f"{forced_err:.4f} (tol {CHUNK_LOGIT_ATOL})")
    log(f"{tag}: per-layer state gaps, free-running " + json.dumps([f"{e:.2e}" for e in free])
        + ", teacher-forced " + json.dumps([f"{e:.2e}" for e in forced]))
    check(free[0] <= 1e-3 and max(forced) <= 1e-3 and forced_err <= CHUNK_LOGIT_ATOL,
          f"{tag}: chunked prefill differs from the one-shot prefill")
    return {"chunked_state_first_layer_err": free[0],
            "chunked_state_worst_layer_err": max(free), "chunked_logit_err": err,
            "chunked_forced_state_worst_layer_err": max(forced),
            "chunked_forced_logit_err": forced_err}


def hold_linears(roll, gen, tag, ms=SSM_GEMM_MS):
    """Kernels 1 and 3 at every distinct 2-D linear of `roll`'s blocks
    (each (K, N) of a stacked (R, K, N) leaf once, on layer 0's weight)
    and each M in `ms`: kernel 1 on a bf16 activation of width K
    bit-equal to its plain version (`hold_quant_act`), and kernel 3
    through `ops.fp8_matmul` (its (M, N) view of a padded output
    included) within one bf16 rounding of the plain version on the same
    quantized activation.  Returns {"slot/module/leaf": the largest
    |kernel - plain| of kernel 3}."""
    import torch
    from repro_torch.core.precision import E4M3, ScaleFormat
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.kernels import ops
    errs, seen, acts = {}, set(), set()
    for slot, mods in roll["blocks"].items():
        for mod, leaves in mods.items():
            for name, stack in leaves.items():
                if not isinstance(stack, QuantizedTensor) or stack.data.dim() != 3:
                    continue
                _, k, n = stack.data.shape
                if (k, n) in seen:
                    continue
                seen.add((k, n))
                w, worst = stack.layer(0), 0.0
                for m in ms:
                    x = torch.randn((m, k), generator=gen, device=w.data.device)
                    x = x.to(torch.bfloat16)
                    if (m, k) not in acts:
                        acts.add((m, k))
                        hold_quant_act(x, E4M3, ScaleFormat.FP32)
                    xq = ops.quantize_activation(x)
                    y = ops.fp8_matmul(xq, w)
                    with mock.patch.object(ops, "_route", lambda t, kernel, plain: plain):
                        yp = ops.fp8_matmul(xq, w).float()
                    torch.cuda.synchronize()
                    err = (y.float() - yp).abs().max().item()
                    scale = yp.abs().max().item()
                    check(tuple(y.shape) == (m, n) and bool(torch.isfinite(y).all())
                          and torch.allclose(y.float(), yp, rtol=2 ** -7, atol=1e-5 * scale),
                          f"{tag}: kernel 3 at {slot}/{mod}/{name} (M {m}, K {k}, N {n}) "
                          "disagrees with its plain version")
                    log(f"{tag} fp8_gemm at {mod}/{name} (M {m}, K {k}, N {n}, stored N "
                        f"{-(-n // 128) * 128}) through ops.fp8_matmul: max|kernel-plain| "
                        f"{err:.3e} (max|plain| {scale:.3f}); output contiguous: "
                        f"{y.is_contiguous()}")
                    worst = max(worst, err)
                errs[f"{slot}/{mod}/{name}"] = worst
    return errs


def ssm_gemm_rows(dev, gen, roll, extra):
    """Kernels 1 and 3 held at mamba2's projections (`hold_linears`):
    w_in (K 1536, N 6448, stored at 6528) and w_out (3072 -> 1536); then
    kernel 3 at each, at M in SSM_GEMM_MS, timed on cold weights (the 48
    layers rotated) beside its byte bound (the real N, not the padding)."""
    errs = hold_linears(roll, gen, "mamba2")
    rows = {}
    for name in ("w_in", "w_out"):
        stack = roll["blocks"]["s0"]["ssm"][name]
        _, k, n = stack.data.shape
        for m in SSM_GEMM_MS:
            row = gemm_row(stack, m, gen)
            row["max_abs_err"] = errs[f"s0/ssm/{name}"]
            extra.append(dict(kernel="fp8_gemm", shape=[m, k, n], weight=f"mamba2 {name}",
                              **row))
            rows[f"{name}_m{m}"] = {key: row[key] for key in ("ms", "device_ms", "bound_ms",
                                                              "plain_ms")}
    return rows


def ssm_steps(dev, cfg, roll, prec, stats):
    """mamba2's `launch.steps` path: a B 8 prefill of 512-1024 tokens and
    BREADTH_STEPS serve steps, a LONG_PROMPT-token prefill and its serve
    steps, then the LONG_500K cell's serve steps on the O(1) state (the
    cell's cache, built as `cache_specs` shapes it, holds no KV: its state
    is the long prompt's, its lengths 524284).  Kernel 1 : kernel 3 at 1 : 1,
    no attention kernel."""
    import numpy as np
    import torch
    from repro_torch.configs import LONG_500K, ShapeConfig
    from repro_torch.data import tasks
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    spec = steps.cache_specs(cfg, LONG_500K, prec)
    check(all("ssm" in sd and "kv" not in sd for sd in spec["slots"].values()),
          f"{cfg.name}: the LONG_500K cache holds KV")
    shape = ShapeConfig("ssm_steps", CONTIG_SHAPE[1], 8, "prefill")
    cprompts, clengths = make_prompts(np.random.default_rng(SEED + 7), b=8, lo=512, hi=1024)
    tokens = np.zeros((8, shape.seq_len), np.int32)
    tokens[:, :cprompts.shape[1]] = cprompts
    batch = {"tokens": torch.from_numpy(tokens).to(dev), "lengths": torch.from_numpy(clengths)}
    prefill_step = steps.make_prefill_step(cfg, shape, prec, device=dev)
    serve_step = steps.make_serve_step(cfg, prec, device=dev)
    long_shape = ShapeConfig("ssm_long_prompt", LONG_PROMPT, 1, "prefill")
    long_prompt = tasks.random_prompt(SEED + 9, LONG_PROMPT)[None]
    long_batch = {"tokens": torch.from_numpy(long_prompt).to(dev),
                  "lengths": torch.tensor([LONG_PROMPT], dtype=torch.int32)}
    long_prefill = steps.make_prefill_step(cfg, long_shape, prec, device=dev)
    build.reset_launch_counts()
    # --- launch.steps: prefill + serve steps, 16K, LONG_500K -----------------
    (logits, cache), prefill_ms = _sync_ms(prefill_step, roll, batch)
    step_ms = []
    for _ in range(BREADTH_STEPS):
        (logits, cache), ms = _sync_ms(serve_step, roll, logits.argmax(-1), cache)
        step_ms.append(ms)
    (llog, lcache), long_ms = _sync_ms(long_prefill, roll, long_batch)
    long_step_ms = []
    for _ in range(BREADTH_STEPS):
        (llog, lcache), ms = _sync_ms(serve_step, roll, llog.argmax(-1), lcache)
        long_step_ms.append(ms)
    cell = Transformer(cfg, dev).init_cache(LONG_500K.global_batch, LONG_500K.seq_len, prec)
    for name, sd in cell["slots"].items():
        sd["ssm"].copy_(lcache["slots"][name]["ssm"])
    cell["lengths"] = torch.full((1,), LONG_500K.seq_len - 4, dtype=torch.int32, device=dev)
    cell["max_length"] = LONG_500K.seq_len - 4
    cell_ms = []
    for _ in range(4):
        (llog, cell), ms = _sync_ms(serve_step, roll, llog.argmax(-1), cell)
        cell_ms.append(ms)
    launches = _path_launches(f"{cfg.name} launch.steps", ("quant_act", "fp8_gemm"),
                              _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    # one serve step of each batch profiled (outside the counted run)
    for tag, (toks, c) in (("b8", (logits.argmax(-1), cache)), ("b1", (llog.argmax(-1), cell))):
        _, busy_ms, n_kernels, _ = _profile(lambda: serve_step(roll, toks, c))
        stats[f"serve_step_{tag}_busy_ms"], stats[f"serve_step_{tag}_kernels"] = \
            busy_ms, n_kernels
    check(launches["decode"] == 0 and launches["paged_decode"] == 0,
          f"{cfg.name}: an attention kernel launched")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(llog).all()),
          f"{cfg.name}: serve-step logits not finite")
    state_gb = sum(st.h.numel() * 4 + st.conv.numel() * 2
                   for st in (sd["ssm"] for sd in cell["slots"].values())) / 1e9
    del cache, lcache, cell
    stats.update(steps_launches=launches, steps_prefill_ms=prefill_ms, serve_step_ms=step_ms,
                 long_prefill_ms=long_ms, long_serve_step_ms=long_step_ms,
                 long_500k_serve_step_ms=cell_ms, long_500k_cache_gb=state_gb)
    log(f"{cfg.name} launch.steps: prefill (B 8, S {shape.seq_len}) {prefill_ms:.1f} ms, serve "
        f"steps {[round(x, 1) for x in step_ms]} ms; {LONG_PROMPT}-token prefill {long_ms:.1f} "
        f"ms, serve steps {[round(x, 1) for x in long_step_ms]}; LONG_500K serve steps "
        f"{[round(x, 1) for x in cell_ms]} ms on a {state_gb * 1e3:.1f} MB state; a serve step "
        f"profiled: B 8 {stats['serve_step_b8_busy_ms']:.2f} ms busy "
        f"({stats['serve_step_b8_kernels']} kernels), B 1 {stats['serve_step_b1_busy_ms']:.2f} "
        f"ms busy ({stats['serve_step_b1_kernels']} kernels)")


def ssm_path(dev, gen, extra):
    """13a: mamba2-780m at full width and depth under `PrecisionConfig()`
    (its kernel config resolves to "off": no KV, no attention kernel):
    the sync, greedy and GRPO `generate` and greedy under BF16_ROLLOUT,
    decode-step logits through the kernels against the plain versions, a
    chunked prefill against the one-shot one, the engine roomy and under a
    budget cut, `launch.steps` (1K, 16K, LONG_500K), kernel 3 at w_in and
    w_out, then TRAIN_STEPS `RLTrainer` steps with f32 moments."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.precision import BF16_ROLLOUT, PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.models import Transformer
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.optim import AdamWConfig, state_bytes
    from repro_torch.rl import RLConfig, RLTrainer, SamplerConfig, generate
    from repro_torch.rl import sync_policy_weights
    from repro_torch.rl.trainer import stats_to_host
    from repro_torch.serving import request_state_bytes
    cfg = get_config(SSM_SERVE)
    prec = PrecisionConfig()
    stats = {"state_bytes_per_request": request_state_bytes(cfg, prec)}
    fresh_peak(cfg.name, stats)
    model = Transformer(cfg, dev)
    params, init_ms = _sync_ms(model.init_params, SEED)
    build.reset_launch_counts()
    roll, sync_stats = sync_policy_weights(params, prec)
    check(build.LAUNCHES["quant_weight"] == _sync_leaves(cfg),
          f"{cfg.name}: kernel 2 launched {build.LAUNCHES['quant_weight']} times")
    stats.update(init_ms=init_ms, sync_ms=sync_stats["sync_ms"])
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, d_inner {cfg.d_inner}, "
        f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, "
        f"{cfg.param_count() / 1e9:.3f}B params; {stats['state_bytes_per_request'] / 1e6:.2f} "
        "MB of SSM state a request")

    prompts, lengths = make_prompts(np.random.default_rng(SEED))
    sampler = torch.Generator(device=dev).manual_seed(SEED)
    build.reset_launch_counts()
    # --- the SSM rollout path: greedy and GRPO generate ----------------------
    greedy, g_ms = _sync_ms(lambda: generate(
        roll, prompts, lengths, None, cfg, prec, SamplerConfig(max_new_tokens=32,
                                                               temperature=0.0),
        page_size=16, device=dev))
    group, grp_ms = _sync_ms(lambda: generate(
        roll, prompts, lengths, sampler, cfg, prec, SamplerConfig(max_new_tokens=32),
        page_size=16, num_samples_per_prompt=4, shared_prefix_blocks=int(lengths.min()) // 16,
        device=dev))
    launches = _path_launches(f"{cfg.name} rollout path", ("quant_act", "fp8_gemm"),
                              _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    forwards = 1 + _decode_steps(greedy) + 1 + _decode_steps(group)
    check(launches["fp8_gemm"] == 2 * cfg.n_layers * forwards,
          f"{cfg.name}: kernel 3 launched {launches['fp8_gemm']} times, not twice a layer "
          f"in each of {forwards} forwards")
    check_trajectory(greedy, 8, 32, cfg.vocab_size, f"{cfg.name} greedy")
    check_trajectory(group, 32, 32, cfg.vocab_size, f"{cfg.name} group")
    bf16, b_ms = _sync_ms(lambda: generate(
        params, prompts, lengths, None, cfg, BF16_ROLLOUT,
        SamplerConfig(max_new_tokens=32, temperature=0.0), page_size=16, device=dev))
    check_trajectory(bf16, 8, 32, cfg.vocab_size, f"{cfg.name} BF16_ROLLOUT")
    same = float((bf16.response_tokens == greedy.response_tokens).float().mean())
    stats.update(rollout_launches=launches, greedy_generate_s=g_ms / 1e3,
                 group_generate_s=grp_ms / 1e3, bf16_generate_s=b_ms / 1e3,
                 greedy_tokens_per_s=float(greedy.response_mask.sum()) / (g_ms / 1e3),
                 group_tokens_per_s=float(group.response_mask.sum()) / (grp_ms / 1e3),
                 bf16_tokens_per_s=float(bf16.response_mask.sum()) / (b_ms / 1e3),
                 fp8_bf16_greedy_token_agreement=same)
    del greedy, group, bf16
    stats["decode_logit_max_abs_err"] = decode_logits_check(model, roll, prec, prompts,
                                                            lengths, dev)
    stats.update(profile_decode_step(model, roll, prec, prompts, lengths, dev, "ssm_"))
    stats.update(chunked_state_check(model, roll, prec, dev, engine_trace(n=1, lo=600)[0],
                                     cfg.name))
    state_engine_runs(roll, cfg, prec, dev, engine_trace(n=16), 8, SSM_ENGINE_BLOCK, stats,
                      cfg.name, ("quant_act", "fp8_gemm"))
    ssm_steps(dev, cfg, roll, prec, stats)
    stats["gemm"] = ssm_gemm_rows(dev, gen, roll, extra)
    del roll

    rl = RLConfig(precision=prec, prompt_batch=8, n_per_prompt=4, max_prompt_len=12,
                  max_new_tokens=32, temperature=1.0,
                  optimizer=AdamWConfig(lr=3e-4, b2=0.98, grad_clip=1.0))
    trainer = RLTrainer(cfg, rl, params=params, device=dev)
    stats["opt_state_gb"] = state_bytes(trainer.opt_state) / 1e9
    build.reset_launch_counts()
    # --- the SSM trainer path: TRAIN_STEPS train steps -----------------------
    rows = [trainer.train_step() for _ in range(TRAIN_STEPS)]
    launches = _path_launches(f"{cfg.name} trainer path",
                              ("quant_act", "quant_weight", "fp8_gemm"), _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["quant_weight"] == _sync_leaves(cfg) * TRAIN_STEPS,
          f"{cfg.name} trainer: kernel 2 launched {launches['quant_weight']} times")
    keys = ("step", "loss", "grad_norm", "mismatch_kl", "corr_weight_ess", "sync_ms",
            "rollout_s", "score_backward_ms", "optimizer_ms", "step_s")
    for m in rows:
        _finite_metrics(m, f"{cfg.name} train step {m['step']}")
        log(f"{cfg.name} train step: " + json.dumps({key: m[key] for key in keys}))
    stats.update(train_launches=launches, train_steps=[{key: m[key] for key in keys}
                                                       for m in rows])
    # FP8 against BF16 rollout, the same prompts scored by the policy
    stats["rollouts"] = score_rollouts(trainer, {"fp8": prec, "bf16": BF16_ROLLOUT}, dev)
    log(f"{cfg.name}, same prompts, FP8 (W8A8) vs BF16 rollout scored by the bf16 policy: "
        + json.dumps(stats["rollouts"]))
    # one update with nonzero advantages (random weights tie every reward
    # at 0): the backward through the SSD reaches every leaf
    batch = dict(trainer.last_update_batch)
    adv = np.repeat(np.random.default_rng(SEED).normal(size=rl.prompt_batch), rl.n_per_prompt)
    batch["advantages"] = torch.tensor(adv, dtype=torch.float32, device=dev)
    batch["mask"] = batch["response_mask"]
    _, opt_state, upd = trainer.update_fn(trainer.params, trainer.opt_state, batch, {})
    upd = stats_to_host(upd)
    _finite_metrics(upd, f"{cfg.name} nonzero-advantage update")
    no_grad = [k for k, m in flatten_tree(opt_state.m) if not bool(m.any())]
    check(upd["grad_norm"] > 0 and not no_grad,
          f"{cfg.name}: grad_norm {upd['grad_norm']}, no gradient reached {no_grad}")
    stats["update"] = {k: upd[k] for k in ("loss", "grad_norm", "clip_scale")}
    log(f"{cfg.name} nonzero-advantage update: " + json.dumps(stats["update"]))
    del trainer, params, opt_state
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"{cfg.name} peak {stats['peak_gb']:.1f} GB")
    log(f"SSM {cfg.name}: " + json.dumps(stats))
    return stats


def hybrid_path(dev, gen, extra):
    """13b: one full-width period of jamba-1.5-large-398b (8 of its 72
    layers, every width kept) under `PrecisionConfig()`: the leafwise sync
    (kernel 2 once per quantized leaf), greedy `generate`, decode-step
    logits through the kernels against the plain versions (each layer of
    the plain step fed the kernel step's input to it), the engine roomy and under a
    budget cut (2 slots: a decode group of 2 rows never fills an expert's
    capacity of 2, so no drop depends on which rows share a step), a
    `launch.steps` prefill and serve steps, the expert-batched kernel 3 at
    E 16 bit-equal per expert to the 2-D kernel, kernels 1 and 3 at every
    2-D linear's widths, kernels 4-6 at its heads.  Kernel 1 : kernel 3 =
    32 : 38 a period."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.rl import SamplerConfig, generate
    from repro_torch.serving import request_state_bytes
    full = get_config(HYBRID)
    cfg = dataclasses.replace(full, n_layers=full.attn_period)
    prec = PrecisionConfig()
    gemms = ("fp8_gemm", "fp8_gemm_batched")
    stats = {"state_bytes_per_request": request_state_bytes(cfg, prec)}
    fresh_peak(cfg.name, stats)
    model = Transformer(cfg, dev)
    build.reset_launch_counts()
    roll = leafwise_sync(model, prec, stats)
    check(build.LAUNCHES["quant_weight"] == _sync_leaves(cfg),
          f"{cfg.name}: kernel 2 launched {build.LAUNCHES['quant_weight']} times for "
          f"{_sync_leaves(cfg)} leaves")
    log(f"{cfg.name}: one period ({cfg.n_layers} of {full.n_layers} layers, the only cut), "
        f"{cfg.param_count() / 1e9:.2f}B params drawn and synced leaf by leaf: "
        + json.dumps(stats))

    prompts, lengths = make_prompts(np.random.default_rng(SEED))
    build.reset_launch_counts()
    # --- the hybrid rollout path: greedy generate ----------------------------
    greedy, g_ms = _sync_ms(lambda: generate(
        roll, prompts, lengths, None, cfg, prec, SamplerConfig(max_new_tokens=32,
                                                               temperature=0.0),
        page_size=16, device=dev))
    launches = _path_launches(f"{cfg.name} rollout path",
                              ("quant_act", *gemms, "paged_decode"), _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    check(launches["paged_decode"] == n_attn * _decode_steps(greedy),
          f"{cfg.name}: kernel 4 launched {launches['paged_decode']} times")
    check_trajectory(greedy, 8, 32, cfg.vocab_size, f"{cfg.name} greedy")
    stats.update(rollout_launches=launches, greedy_generate_s=g_ms / 1e3,
                 greedy_tokens_per_s=float(greedy.response_mask.sum()) / (g_ms / 1e3))
    del greedy
    stats["decode_logit_max_abs_err"] = forced_decode_logits_check(model, roll, prec, prompts,
                                                                   lengths, dev)
    state_engine_runs(roll, cfg, prec, dev, engine_trace(n=4), 2, ENGINE_BLOCK_SIZE, stats,
                      cfg.name, ("quant_act", *gemms, "paged_decode", "paged_prefill"))

    shape = ShapeConfig("hybrid_steps", CONTIG_SHAPE[1], 8, "prefill")
    cprompts, clengths = make_prompts(np.random.default_rng(SEED + 7), b=8, lo=512, hi=1024)
    tokens = np.zeros((8, shape.seq_len), np.int32)
    tokens[:, :cprompts.shape[1]] = cprompts
    batch = {"tokens": torch.from_numpy(tokens).to(dev), "lengths": torch.from_numpy(clengths)}
    prefill_step = steps.make_prefill_step(cfg, shape, prec, device=dev)
    serve_step = steps.make_serve_step(cfg, prec, device=dev)
    build.reset_launch_counts()
    # --- launch.steps: prefill, then BREADTH_STEPS serve steps --------------
    (logits, cache), prefill_ms = _sync_ms(prefill_step, roll, batch)
    step_ms = []
    for _ in range(BREADTH_STEPS):
        (logits, cache), ms = _sync_ms(serve_step, roll, logits.argmax(-1), cache)
        step_ms.append(ms)
    launches = _path_launches(f"{cfg.name} launch.steps", ("quant_act", *gemms, "decode"),
                              _quant_ratio(cfg))
    # ----------------------------------------------------------------------
    check(launches["decode"] == n_attn * BREADTH_STEPS,
          f"{cfg.name}: kernel 6 launched {launches['decode']} times")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: serve-step logits not finite")
    del cache
    stats.update(steps_launches=launches, steps_prefill_ms=prefill_ms, serve_step_ms=step_ms)

    rows = {}
    for name in ("fc1", "fc2"):
        stack = roll["blocks"]["s1"]["moe"][name]
        row = moe_gemm_row(stack, 8, gen)
        _, e, k, n = stack.data.shape
        extra.append(dict(kernel="fp8_gemm_batched", shape=[e, 8, k, n],
                          weight=f"jamba {name}", **row))
        rows[f"{name}_m8"] = {key: row[key] for key in ("ms", "device_ms", "bound_ms")}
    stats["batched_gemm"] = rows
    stats["linear_errs"] = hold_linears(roll, gen, cfg.name)
    stats["kernel_errs"] = hold_attention_kernels(dev, gen, cfg)
    del roll, model
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"{cfg.name} peak {stats['peak_gb']:.1f} GB")
    log(f"hybrid {cfg.name}: " + json.dumps(stats))
    return stats


def ssm_hybrid_path(dev, gen, extra):
    """Phase 13: 13a then 13b."""
    return {"ssm": ssm_path(dev, gen, extra), "hybrid": hybrid_path(dev, gen, extra)}


# ---------------------------------------------------------------------------
# phase 14: enc-dec and VLM at full width and depth
# ---------------------------------------------------------------------------

def encdec_frames(b, pad, d, lo, hi, seed):
    """`b` requests' frames (`tasks.random_frames`, lo-hi of them, seeded
    lengths) zero-padded to `pad`: (frames (b, pad, d) f32 numpy, their
    lengths)."""
    import numpy as np
    from repro_torch.data import tasks
    lengths = np.random.default_rng(seed).integers(lo, hi + 1, size=b).astype(np.int32)
    frames = np.zeros((b, pad, d), np.float32)
    for i, n in enumerate(lengths):
        frames[i, :n] = tasks.random_frames(seed + 1 + i, int(n), d)
    return frames, lengths


def _frames_in(frames, lengths, dev):
    import torch
    return {"frames": torch.from_numpy(frames).to(dev, torch.bfloat16),
            "src_lengths": torch.from_numpy(lengths).to(dev)}


def encdec_attention_rows(dev, gen, cfg, traj, extra):
    """Kernels 4 and 6 timed at the model's heads: kernel 4 at the greedy
    run's final context lengths (B 8, page size 16), kernel 6 at B 8 over
    a cache of 1057 positions — each beside its plain version, the SDPA
    yardstick and its byte bound (phase 6's rows)."""
    import torch
    from repro_torch.kernels import fp8_kv_attention as fa
    kvh, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    lengths = (traj.prompt_lengths + traj.response_lengths).to(torch.int32)
    q, kq, vq, ks, vs, tables, lengths, _ = decode_case(
        dev, gen, b=8, kvh=kvh, g=g, d=dh, bs=16, max_len=int(lengths.max()), lengths=lengths)
    kf, vf = fa._live_kv(kq, vq, ks, vs, tables, lengths)
    row = timed_row(
        lambda: fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths),
        lambda: fa.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lengths),
        library=sdpa_decode_yardstick(q, kf, vf, lengths))
    del kf, vf
    ctx = int(lengths.sum())
    nbytes = 2 * ctx * kvh * dh + 2 * 2 * 8 * kvh * g * dh + tables.numel() * 4 + 8 * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * ctx * kvh * g * dh, BF16_TC_FLOPS)
    extra.append(dict(kernel="paged_decode", model=cfg.name, shape=[8, kvh, g, dh],
                      context=ctx, **row))
    rows = {"paged_decode": row}
    args = contiguous_case(dev, gen, 8, CONTIG_SHAPE[1] + 1,
                           [1057, 1, 0, 300, 512, 999, 64, 700], kvh, g, dh)
    row = decode_row(args)
    extra.append(dict(kernel="decode", model=cfg.name, shape=[8, kvh, g, dh],
                      s_max=CONTIG_SHAPE[1] + 1, context=int(args[-1].sum()), **row))
    rows["decode"] = row
    for name, row in rows.items():
        log(f"{cfg.name} {name} (KVH {kvh}, G {g}, D {dh}): device {row['device_ms']:.4f} ms, "
            f"ms {row['ms']:.4f}, bound {row['bound_ms']:.5f} ({row['bound_by']}), plain "
            f"{row['plain_ms']:.3f}, library {row['library_ms']}")
    return {name: {k: row[k] for k in ("ms", "device_ms", "bound_ms", "plain_ms",
                                       "library_ms")} for name, row in rows.items()}


def encdec_path(dev, gen, extra):
    """14a: seamless-m4t-medium at full width and depth (12 + 12 layers,
    d 1024, 16 heads of 64, vocab 256206) under `PrecisionConfig()`: the
    sync (kernel 2 over the decoder's, the cross attention's and the
    encoder's leaves and w_patch), greedy and GRPO `generate` over 8
    prompts with 256-1024 frames each (padded to ENCDEC_SRC, masked by
    `src_lengths`) and greedy under BF16_ROLLOUT, decode-step logits
    through the kernels against the plain versions, the engine (8 slots,
    16 requests with frames, `max_src_len` ENCDEC_SRC) roomy and under a
    budget cut (bit-equal, the victims' cross KV swapped out and back;
    two requests with one prompt and other frames decode otherwise),
    `launch.serve.run --arch seamless-m4t-medium`, `launch.steps` (a B 8
    prefill over S 1056 with frames of S, CONTIG_STEPS serve steps
    through kernel 6; LONG_500K not run), kernels 4-6 at (G 1, D 64)."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.precision import BF16_ROLLOUT, PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.rl import SamplerConfig, generate, sync_policy_weights
    from repro_torch.serving import request_state_bytes
    cfg = get_config(ENCDEC)
    prec = PrecisionConfig()
    stats = {"cross_kv_bytes_per_request": request_state_bytes(cfg, prec, src_len=ENCDEC_SRC)}
    fresh_peak(cfg.name, stats)
    model = Transformer(cfg, dev)
    params, init_ms = _sync_ms(model.init_params, SEED)
    build.reset_launch_counts()
    roll, sync_stats = sync_policy_weights(params, prec)
    check(build.LAUNCHES["quant_weight"] == _sync_leaves(cfg),
          f"{cfg.name}: kernel 2 launched {build.LAUNCHES['quant_weight']} times")
    stats.update(init_ms=init_ms, sync_ms=sync_stats["sync_ms"])
    log(f"{cfg.name}: {cfg.n_enc_layers} + {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.d_head}; cross KV {stats['cross_kv_bytes_per_request'] / 1e6:.2f}"
        f" MB a request at {ENCDEC_SRC} frames")

    prompts, lengths = make_prompts(np.random.default_rng(SEED))
    frames, src_lengths = encdec_frames(8, ENCDEC_SRC, cfg.d_model, *ENCDEC_FRAMES, SEED + 50)
    src = _frames_in(frames, src_lengths, dev)
    sampler = torch.Generator(device=dev).manual_seed(SEED)
    greedy_cfg = SamplerConfig(max_new_tokens=32, temperature=0.0)
    build.reset_launch_counts()
    # --- the enc-dec rollout path: greedy and GRPO generate -------------------
    greedy, g_ms = _sync_ms(lambda: generate(roll, prompts, lengths, None, cfg, prec, greedy_cfg,
                                             page_size=16, extra_inputs=src, device=dev))
    group, grp_ms = _sync_ms(lambda: generate(
        roll, prompts, lengths, sampler, cfg, prec, SamplerConfig(max_new_tokens=32),
        page_size=16, num_samples_per_prompt=4, shared_prefix_blocks=int(lengths.min()) // 16,
        extra_inputs=src, device=dev))
    launches = _path_launches(f"{cfg.name} rollout path",
                              ("quant_act", "fp8_gemm", "paged_decode"), None)
    # ----------------------------------------------------------------------
    decodes = _decode_steps(greedy) + _decode_steps(group)
    check_forward_launches(launches, f"{cfg.name} rollout path", cfg, 2, decodes)
    check(launches["paged_decode"] == cfg.n_layers * decodes,
          f"{cfg.name}: kernel 4 launched {launches['paged_decode']} times")
    check_trajectory(greedy, 8, 32, cfg.vocab_size, f"{cfg.name} greedy")
    check_trajectory(group, 32, 32, cfg.vocab_size, f"{cfg.name} group")
    bf16, b_ms = _sync_ms(lambda: generate(params, prompts, lengths, None, cfg, BF16_ROLLOUT,
                                           greedy_cfg, page_size=16, extra_inputs=src,
                                           device=dev))
    check_trajectory(bf16, 8, 32, cfg.vocab_size, f"{cfg.name} BF16_ROLLOUT")
    stats.update(rollout_launches=launches, greedy_generate_s=g_ms / 1e3,
                 group_generate_s=grp_ms / 1e3, bf16_generate_s=b_ms / 1e3,
                 greedy_tokens_per_s=float(greedy.response_mask.sum()) / (g_ms / 1e3),
                 group_tokens_per_s=float(group.response_mask.sum()) / (grp_ms / 1e3),
                 fp8_bf16_greedy_token_agreement=float(
                     (bf16.response_tokens == greedy.response_tokens).float().mean()))
    del params, group, bf16
    stats["decode_logit_max_abs_err"] = decode_logits_check(model, roll, prec, prompts,
                                                            lengths, dev, extra=src)
    stats.update(profile_decode_step(model, roll, prec, prompts, lengths, dev, "encdec_",
                                     extra=src))

    trace = engine_trace(n=16)
    trace[15] = trace[14]               # one prompt, other frames
    eframes, elens = encdec_frames(16, ENCDEC_SRC, cfg.d_model, *ENCDEC_FRAMES, SEED + 70)
    req_frames = [eframes[i, :n] for i, n in enumerate(elens)]
    rep = state_engine_runs(roll, cfg, prec, dev, trace, 8, ENGINE_BLOCK_SIZE, stats, cfg.name,
                            ("quant_act", "fp8_gemm", "paged_decode"), frames=req_frames,
                            prefill_chunk=None, prompt_pad=max(len(p) for p in trace),
                            max_src_len=ENCDEC_SRC)
    done = {r.rid: r.generated for r in rep.completed}
    check(done[14] != done[15], f"{cfg.name}: one prompt with other frames decoded the same")
    out, serve_ms = _sync_ms(launch_serve.run, ["--arch", ENCDEC, "--precision", "default",
                                                "--requests", "8", "--max-new", "16",
                                                "--slots", "4", "--src-pad", "256"])
    check(out["completed"] == 8 and not out["stalled"],
          f"{cfg.name}: launch.serve completed {out['completed']}")
    stats["launch_serve"] = {k: out[k] for k in ("completed", "steps", "emitted_tokens",
                                                 "state_bytes_per_request", "serve_wall_s")}
    log(f"{cfg.name} launch.serve.run: " + json.dumps(stats["launch_serve"]))

    shape = ShapeConfig("encdec_steps", CONTIG_SHAPE[1], 8, "prefill")
    cprompts, clengths = make_prompts(np.random.default_rng(SEED + 7), b=8, lo=512, hi=1024)
    tokens = np.zeros((8, shape.seq_len), np.int32)
    tokens[:, :cprompts.shape[1]] = cprompts
    sframes, slens = encdec_frames(8, shape.seq_len, cfg.d_model, ENCDEC_FRAMES[0], shape.seq_len,
                                   SEED + 90)
    batch = {"tokens": torch.from_numpy(tokens).to(dev), "lengths": torch.from_numpy(clengths),
             **_frames_in(sframes, slens, dev)}
    prefill_step = steps.make_prefill_step(cfg, shape, prec, device=dev)
    serve_step = steps.make_serve_step(cfg, prec, device=dev)
    build.reset_launch_counts()
    # --- launch.steps: prefill over frames of S, then CONTIG_STEPS serve steps
    (logits, cache), prefill_ms = _sync_ms(prefill_step, roll, batch)
    step_ms = []
    for _ in range(CONTIG_STEPS):
        (logits, cache), ms = _sync_ms(serve_step, roll, logits.argmax(-1), cache)
        step_ms.append(ms)
    launches = _path_launches(f"{cfg.name} launch.steps", ("quant_act", "fp8_gemm", "decode"),
                              None)
    # ----------------------------------------------------------------------
    check_forward_launches(launches, f"{cfg.name} launch.steps", cfg, 1, CONTIG_STEPS)
    check(launches["decode"] == cfg.n_layers * CONTIG_STEPS,
          f"{cfg.name}: kernel 6 launched {launches['decode']} times")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: serve-step logits not finite")
    cross_gb = sum(sd["cross"].k.numel() * 2 for sd in cache["slots"].values()) / 1e9
    del cache
    stats.update(steps_launches=launches, steps_prefill_ms=prefill_ms, serve_step_ms=step_ms,
                 steps_cross_cache_gb=cross_gb)
    log(f"{cfg.name} launch.steps: prefill (B 8, S {shape.seq_len}, frames of S) "
        f"{prefill_ms:.1f} ms, serve steps {[round(x, 1) for x in step_ms[:4]]}... ms (median "
        f"{sorted(step_ms)[len(step_ms) // 2]:.1f}); cross caches {cross_gb:.3f} GB.  LONG_500K "
        "not run: the reference sizes the cross cache and the encoder's full attention at S "
        "(S^2 = 2.7e11 scores a head, a 12.9 GB fp8 cross cache), as cache_specs shows")
    stats["kernel_errs"] = hold_attention_kernels(dev, gen, cfg)
    stats["attention_rows"] = encdec_attention_rows(dev, gen, cfg, greedy, extra)
    del roll
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"{cfg.name} peak {stats['peak_gb']:.1f} GB")
    log(f"enc-dec {cfg.name}: " + json.dumps(stats))
    return stats


def patch_gemm_rows(dev, gen, roll, extra):
    """Kernel 3 at pixtral's w_patch (K 5120, N 5120) over a prefill's
    VLM_PATCH_M patch rows — one weight, operations-bound — and at its wg
    (5120 -> 14336) at M 8, the 40 layers rotated (cold in L2, bytes-
    bound), each beside its plain version and its bound; w_patch's output
    held within one bf16 rounding of plain."""
    import torch
    from repro_torch.kernels import fp8_gemm as fg
    from repro_torch.kernels import fp8_quant as fq
    from repro_torch.kernels import ops
    w = roll["frontend"]["w_patch"]
    k, n = w.data.shape
    m = VLM_PATCH_M
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    a, a_s = fq.quantize_activation_kernel(x)
    wk = ops._gemm_weight(w.data)
    y = fg.fp8_gemm(a, wk, a_s, w.scales)
    yp = fg.fp8_gemm_ref(a, wk, a_s, w.scales).float()
    torch.cuda.synchronize()
    err = (y.float() - yp).abs().max().item()
    check(torch.allclose(y.float(), yp, rtol=2 ** -7, atol=1e-5 * yp.abs().max().item()),
          "pixtral: kernel 3 at w_patch disagrees with its plain version")
    del y, yp
    row = timed_row(lambda: fg.fp8_gemm(a, wk, a_s, w.scales),
                    lambda: fg.fp8_gemm_ref(a, wk, a_s, w.scales), plain_reps=3, plain_warmup=1)
    nbytes = m * k + k * n + m * (k // 128) * 4 + (k // 128) * (n // 128) * 4 + m * n * 2
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * m * n * k, FP8_TC_FLOPS)
    row["max_abs_err"] = err
    extra.append(dict(kernel="fp8_gemm", shape=[m, k, n], weight="pixtral w_patch", **row))
    log(f"pixtral fp8_gemm w_patch M {m} K {k} N {n}: device {row['device_ms']:.4f} ms, ms "
        f"{row['ms']:.4f} (bound {row['bound_ms']:.4f}, {row['bound_by']}), plain "
        f"{row['plain_ms']:.3f}, max|kernel-plain| {err:.3e}")
    rows = {"w_patch": row}
    stack = roll["blocks"]["s0"]["mlp"]["wg"]
    row = gemm_row(stack, 8, gen)
    extra.append(dict(kernel="fp8_gemm", shape=[8, *stack.data.shape[1:]],
                      weight="pixtral wg", **row))
    rows["wg"] = row
    return {name: {key: r[key] for key in ("ms", "device_ms", "bound_ms", "bound_by",
                                             "plain_ms")} for name, r in rows.items()}


def vlm_path(dev, gen, extra):
    """14b: pixtral-12b at full width and depth (40 layers, d 5120, 32/8
    heads of 128, d_ff 14336, vocab 131072, 1024 patches) under
    `PrecisionConfig()`: the sync (8 leaves), greedy `generate` over 8
    prompts of 64-128 text tokens after 1024 patches at page size 16 (the
    block table sized for the prefix: no write past it), decode-step
    logits through the kernels against the plain versions (each layer's
    input forced to the kernel step's; the free-running gap logged), the
    prefill's
    last logits against `forward_train`'s at that position (the
    reference's causal prefill over the patches: logged, not held),
    `launch.steps` (a B 8 prefill over S 2048, 1024 of them patches, and
    VLM_STEPS serve steps through kernel 6), kernel 3 at w_patch and wg
    timed; the peak under 80 GB."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import Transformer, forward_train
    from repro_torch.rl import SamplerConfig, generate, sync_policy_weights
    cfg = get_config(VLM)
    prec = PrecisionConfig()
    stats = {}
    fresh_peak(cfg.name, stats)
    model = Transformer(cfg, dev)
    params, init_ms = _sync_ms(model.init_params, SEED)
    build.reset_launch_counts()
    roll, sync_stats = sync_policy_weights(params, prec)
    check(build.LAUNCHES["quant_weight"] == _sync_leaves(cfg),
          f"{cfg.name}: kernel 2 launched {build.LAUNCHES['quant_weight']} times")
    stats.update(init_ms=init_ms, sync_ms=sync_stats["sync_ms"],
                 sync_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.param_count() / 1e9:.2f}B "
        f"decoder params + w_patch; sync {stats['sync_ms']:.1f} ms, peak so far "
        f"{stats['sync_peak_gb']:.2f} GB")

    prompts, lengths = make_prompts(np.random.default_rng(SEED))
    p = cfg.frontend_len
    patches = torch.randn((8, p, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    caches = []
    real_init = Transformer.init_cache

    def spy(self, *args, **kw):
        caches.append(real_init(self, *args, **kw))
        return caches[-1]
    build.reset_launch_counts()
    # --- the VLM rollout path: greedy generate after the patches -------------
    with mock.patch.object(Transformer, "init_cache", spy):
        greedy, g_ms = _sync_ms(lambda: generate(
            roll, prompts, lengths, None, cfg, prec,
            SamplerConfig(max_new_tokens=32, temperature=0.0), page_size=VLM_PAGE,
            extra_inputs={"patches": patches}, device=dev))
    launches = _path_launches(f"{cfg.name} rollout path",
                              ("quant_act", "fp8_gemm", "paged_decode"), None)
    # ----------------------------------------------------------------------
    decodes = _decode_steps(greedy)
    check_forward_launches(launches, f"{cfg.name} rollout path", cfg, 1, decodes)
    check(launches["paged_decode"] == cfg.n_layers * decodes,
          f"{cfg.name}: kernel 4 launched {launches['paged_decode']} times")
    check_trajectory(greedy, 8, 32, cfg.vocab_size, f"{cfg.name} greedy")
    table = caches[0]["block_tables"].shape[1] * VLM_PAGE
    last = p + int(lengths.max()) + decodes          # one past the last position written
    text_only = -(-(prompts.shape[1] + 33) // VLM_PAGE) * VLM_PAGE
    check(last <= table, f"{cfg.name}: a write at {last - 1} falls past a table of {table}")
    stats.update(rollout_launches=launches, greedy_generate_s=g_ms / 1e3,
                 greedy_tokens_per_s=float(greedy.response_mask.sum()) / (g_ms / 1e3),
                 table_positions=table, last_position_written=last - 1,
                 text_only_table_positions=text_only)
    log(f"{cfg.name} generate: table of {table} positions, last write at {last - 1} (a table "
        f"counting only the text would hold {text_only})")
    del greedy, caches
    # held teacher-forced, as 13b: free-running, the kernels' last-bit
    # differences compound over 40 layers and 1024 + 128 positions of
    # context (0.64 on the H100 against the 0.5 band); logged beside it
    stats["decode_logit_max_abs_err"] = forced_decode_logits_check(
        model, roll, prec, prompts, lengths, dev, extra={"patches": patches})
    stats.update(profile_decode_step(model, roll, prec, prompts, lengths, dev, "vlm_",
                                     extra={"patches": patches}))
    # the reference's train-inference split over the patches (kept)
    n = int(lengths[:2].min())
    two = {"tokens": torch.from_numpy(prompts[:2, :n]).to(dev), "patches": patches[:2]}
    with torch.no_grad():
        last_logits, _ = model.prefill(roll, dict(two, lengths=torch.tensor([n, n])),
                                       model.init_cache(2, p + n + 1, prec), prec)
        full, aux = forward_train(roll, two, cfg, prec)
        gap = (last_logits - full[:, -1]).abs().max().item()
        scale = full[:, -1].abs().max().item()
    del full
    stats["prefill_vs_forward_train_gap"] = gap
    log(f"{cfg.name}: prefill (causal over the patches) vs forward_train (prefix-LM) at the "
        f"last prompt position: max abs gap {gap:.4f} on logits of max magnitude {scale:.3f} "
        "(the reference's semantics; logged, not held)")

    shape = ShapeConfig("vlm_steps", VLM_STEPS_S, 8, "prefill")
    specs = steps.input_specs(cfg, shape)
    t = specs["tokens"].shape[1]
    cprompts, clengths = make_prompts(np.random.default_rng(SEED + 7), b=8, lo=512,
                                      hi=t - VLM_STEPS)
    tokens = np.zeros((8, t), np.int32)
    tokens[:, :cprompts.shape[1]] = cprompts
    spatches = torch.randn(tuple(specs["patches"].shape), generator=gen,
                           device=dev).to(torch.bfloat16)
    batch = {"tokens": torch.from_numpy(tokens).to(dev), "lengths": torch.from_numpy(clengths),
             "patches": spatches}
    prefill_step = steps.make_prefill_step(cfg, shape, prec, device=dev)
    serve_step = steps.make_serve_step(cfg, prec, device=dev)
    build.reset_launch_counts()
    # --- launch.steps: 1024 patches + text, then VLM_STEPS serve steps ------
    (logits, cache), prefill_ms = _sync_ms(prefill_step, roll, batch)
    step_ms = []
    for _ in range(VLM_STEPS):
        (logits, cache), ms = _sync_ms(serve_step, roll, logits.argmax(-1), cache)
        step_ms.append(ms)
    launches = _path_launches(f"{cfg.name} launch.steps", ("quant_act", "fp8_gemm", "decode"),
                              None)
    # ----------------------------------------------------------------------
    check_forward_launches(launches, f"{cfg.name} launch.steps", cfg, 1, VLM_STEPS)
    check(launches["decode"] == cfg.n_layers * VLM_STEPS,
          f"{cfg.name}: kernel 6 launched {launches['decode']} times")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: serve-step logits not finite")
    del cache, spatches, batch
    stats.update(steps_launches=launches, steps_prefill_ms=prefill_ms, serve_step_ms=step_ms)
    log(f"{cfg.name} launch.steps: prefill (B 8, S {VLM_STEPS_S}, {specs['patches'].shape[1]} "
        f"patches) {prefill_ms:.1f} ms, serve steps {[round(x, 1) for x in step_ms]} ms")
    stats["gemm"] = patch_gemm_rows(dev, gen, roll, extra)
    del roll
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_gb"] * 1e9 < CARD_BYTES, f"{cfg.name} peak {stats['peak_gb']:.1f} GB")
    log(f"VLM {cfg.name}: " + json.dumps(stats))
    return stats


def encdec_vlm_path(dev, gen, extra):
    """Phase 14: 14a then 14b."""
    return {"encdec": encdec_path(dev, gen, extra), "vlm": vlm_path(dev, gen, extra)}


# ---------------------------------------------------------------------------
# phase 15: the distributed runtime, DIST_RANKS ranks on cuda:0 over gloo
# ---------------------------------------------------------------------------

def long_row_quant(dev, gen, extra):
    """Kernel 1 on the one (1, n) f32 row `compressed_psum` hands it — each
    gradient leaf flattened, padded to 128 and widened: bit-equal to its
    plain version at every DIST_ROWS n (one of them odd), and timed at
    the two leaves' n beside the byte bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fp8_quant as fq
    from repro_torch.kernels import ops
    for n in DIST_ROWS:
        x = F.pad(torch.randn((1, n), generator=gen, device=dev) * 1e-3, (0, (-n) % 128))
        qt = ops.quantize_activation(x)
        q, s = qt.data, qt.scales
        qr, sr = fq.quantize_activation_ref(x)
        check(torch.equal(q.view(torch.uint8), qr.view(torch.uint8)) and torch.equal(s, sr),
              f"kernel 1 on a (1, {n}) f32 row differs from its plain version")
        if n % 128:
            continue
        row = timed_row(lambda: fq.quantize_activation_kernel(x),
                        lambda: fq.quantize_activation_ref(x), reps=10, plain_reps=3)
        row["bound_ms"], row["bound_by"] = bound(n * 4 + n + n // 128 * 4, 6 * n, F32_FLOPS)
        extra.append(dict(kernel="quant_act", shape=[1, n], input="float32", **row))
        log(f"15: kernel 1 at (1, {n}) f32 bit-equal to plain; device {row['device_ms']:.4f} "
            f"ms (bound {row['bound_ms']:.4f}, {row['bound_by']}), ms {row['ms']:.4f}, "
            f"plain {row['plain_ms']:.3f}")
        del x, qt, q, s, qr, sr


def _dist_grad(r, shape, dtype, dev):
    """Rank r's seeded gradient of a leaf."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 1000 + r)
    return (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(dtype)


def _plain_psum(xs):
    """One process: each contribution flattened, padded, widened and
    quantized by kernel 1's plain version, then dequantized and summed in
    rank order in f32 (what `compressed_psum` computes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fp8_quant as fq
    n = xs[0].numel()
    total = None
    for x in xs:
        q, s = fq.quantize_activation_ref(F.pad(x.reshape(1, -1), (0, (-n) % 128)).float())
        term = q.float() * torch.repeat_interleave(s, 128, dim=-1)
        total = term if total is None else total + term
    return total.reshape(-1)[:n].reshape(xs[0].shape).to(xs[0].dtype)


def _digest(t) -> str:
    """A short hash of a tensor's bytes."""
    import hashlib

    import torch
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def dist_compress(rank, world, dev):
    """15a: `compressed_psum` of each rank's seeded gradient of qwen3-8b's
    wq and wg leaves, bf16 and f32: kernel 1 once a call, the result's
    digest, ms per call; rank 0 also holds it bit-equal to `_plain_psum`
    of the four contributions and within 0.03 of the exact sum."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import comm_bytes, compressed_psum
    from repro_torch.kernels import build
    out = []
    for leaf, shape in DIST_GRAD_LEAVES:
        for dtype in (torch.bfloat16, torch.float32):
            x = _dist_grad(rank, shape, dtype, dev)
            compressed_psum(x)                       # warm
            torch.cuda.synchronize()
            dist.barrier()
            n0 = build.LAUNCHES["quant_act"]
            y = compressed_psum(x)
            launches = build.LAUNCHES["quant_act"] - n0
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(DIST_SUM_REPS):
                compressed_psum(x)
            torch.cuda.synchronize()
            rec = dict(leaf=leaf, dtype=str(dtype).split(".")[-1], launches=launches,
                       ms=(time.perf_counter() - t0) / DIST_SUM_REPS * 1e3, digest=_digest(y))
            if rank == 0:
                xs = [x] + [_dist_grad(r, shape, dtype, dev) for r in range(1, world)]
                rec["bit_equal_plain"] = bool(torch.equal(_plain_psum(xs).view(torch.uint8),
                                                          y.view(torch.uint8)))
                exact = torch.stack([t.float() for t in xs]).sum(0)
                rec["rel_err"] = float((y.float() - exact).abs().mean() / exact.abs().mean())
                n = x.numel()
                n_pad = n + (-n) % 128
                rec["gathered_bytes"] = (world - 1) * (n_pad + 4 * n_pad // 128)
                rec["comm_bytes"] = comm_bytes(n, world, True)
                del xs, exact
            out.append(rec)
            del x, y
    return out


def _local_bytes(tree) -> int:
    """Bytes of a tree's tensors that this rank holds (a DTensor's local
    shard)."""
    from repro_torch.core.fp8_params import tree_leaves
    return sum((t.to_local() if hasattr(t, "to_local") else t).nbytes
               for t in tree_leaves(tree))


def dist_train(rank, world, dev):
    """15b: llama3.2-3b at full width, DIST_TRAIN_LAYERS of its layers, f32
    params and moments, on a (2, 2) data x model mesh with ZeRO-3: the
    first of DIST_STEPS steps runs as `make_train_step` runs it
    (`make_loss_and_grads`, then `adamw.update`) with its collectives
    counted (CommDebugMode) and its loss and gradients held against the
    same in this process alone (every rank runs it and compares its own
    shards); the later steps are `make_train_step`'s; the resident bytes,
    the losses and walls."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.core.fp8_params import tree_fill, tree_leaves
    from repro_torch.distributed.sharding import ShardingRules, distribute
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(DIST_TRAIN), n_layers=DIST_TRAIN_LAYERS)
    params = Transformer(cfg, dev, dtype=torch.float32).init_params(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, DIST_TRAIN_BT, generator=gen,
                                     device=dev)}
    full_bytes = 3 * _local_bytes(params)          # params + f32 m and v
    loss1, grads1 = steps.make_loss_and_grads(cfg, device=dev)(params, batch)
    mesh = init_device_mesh("cuda", (2, world // 2), mesh_dim_names=("data", "model"))
    rules = ShardingRules(mesh, zero3=True)
    specs = rules.params(params)
    dparams = distribute(params, specs, mesh)
    want = distribute(grads1, specs, mesh)          # this rank's shards of them
    del params, grads1
    opt = adamw.AdamWConfig(lr=1e-4)
    state = adamw.init(dparams, opt)
    resident = _local_bytes(dparams) + _local_bytes({"m": state.m, "v": state.v})
    loss_and_grads = steps.make_loss_and_grads(cfg, rules=rules)
    step = steps.make_train_step(cfg, opt_cfg=opt, rules=rules)
    comm = CommDebugMode()
    losses, walls = [], []
    for i in range(DIST_STEPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        if i == 0:
            with comm:
                loss, grads = loss_and_grads(dparams, batch)
                # reduced to the params' layouts (what `update` does first)
                grads = tree_fill(dparams, [
                    g.redistribute(p.device_mesh, p.placements)
                    for p, g in zip(tree_leaves(dparams), tree_leaves(grads))])
                dparams, state, _ = adamw.update(dparams, grads, state, opt)
        else:
            dparams, state, loss = step(dparams, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if i == 0:
            grad_err = max(float((g.to_local() - w.to_local()).abs().max())
                           / (float(w.to_local().abs().max()) or 1.0)
                           for g, w in zip(tree_leaves(grads), tree_leaves(want)))
            del grads, want
    return dict(loss_one_process=float(loss1), loss_sharded=losses[0], grad_err=grad_err,
                resident_bytes=resident, one_process_bytes=full_bytes,
                comms={str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()},
                losses=losses, walls=walls)


def dist_fp8_moments(rank, world, dev):
    """15b's fp8 step: one AdamW update with fp8 moments of llama3.2-3b's
    f32 params (DIST_TRAIN_LAYERS layers, seeded gradients) sharded on the
    (2, 2) mesh and in this process: every rank holds each moment's local
    payload and scale bytes equal to the same slice of the one-process
    moment's, and its param shards equal."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core.fp8_params import tree_leaves
    from repro_torch.distributed.sharding import ShardingRules, distribute, local_shard
    from repro_torch.models import Transformer
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(DIST_TRAIN), n_layers=DIST_TRAIN_LAYERS)
    params = Transformer(cfg, dev, dtype=torch.float32).init_params(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return torch.randn(t.shape, generator=gen, device=dev) * 1e-3
    grads = draw(params)
    opt = adamw.AdamWConfig(lr=1e-4, fp8_moments=True)
    mesh = init_device_mesh("cuda", (2, world // 2), mesh_dim_names=("data", "model"))
    rules = ShardingRules(mesh, zero3=True)
    specs = rules.params(params)
    dparams, dgrads = distribute(params, specs, mesh), distribute(grads, specs, mesh)
    state = adamw.init(dparams, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dparams, state, _ = adamw.update(dparams, dgrads, state, opt)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    del dgrads
    state1 = adamw.init(params, opt)       # the one-process update, in place
    one, state1, _ = adamw.update(params, grads, state1, opt)
    del grads
    bad, leaves = [], 0
    for name in ("m", "v"):
        for q1, q2 in zip(tree_leaves(getattr(state1, name)), tree_leaves(getattr(state, name))):
            leaves += 1
            for a, b in ((q1.data, q2.data), (q1.scales, q2.scales)):
                if not torch.equal(local_shard(a, b).contiguous().view(torch.uint8),
                                   b.to_local().contiguous().view(torch.uint8)):
                    bad.append(name)
    params_equal = all(torch.equal(local_shard(a, b), b.to_local())
                       for a, b in zip(tree_leaves(one), tree_leaves(dparams)))
    aligned = sum(adamw._moment_layout(p)[3] for p in tree_leaves(dparams))
    return dict(moment_leaves=leaves, mismatched=bad, params_equal=params_equal,
                aligned_leaves=aligned, update_s=sharded_s)


def dist_serve(rank, world, dev):
    """15d: llama3.2-3b at full width, DIST_SERVE_LAYERS of its layers,
    `PrecisionConfig()` (W8A8 linears, FP8 KV): the sharded
    `make_prefill_step` and DIST_SERVE_STEPS `make_serve_step` calls on a
    (2, 2) mesh with ZeRO-3, fed the one-process run's greedy tokens,
    against the same steps in this process: each step's largest logit
    gap and decisive-argmax agreement, the kernel launches of the sharded
    path alone (counts zeroed just before it), the walls."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import fp8_params
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.distributed.sharding import ShardingRules, distribute
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    cfg = dataclasses.replace(get_config(DIST_SERVE), n_layers=DIST_SERVE_LAYERS)
    prec = PrecisionConfig()
    roll = fp8_params.quantize_params(Transformer(cfg, dev).init_params(SEED), prec)
    b, t = DIST_SERVE_BT
    shape = ShapeConfig("15d", t, b, "prefill")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev),
             "lengths": torch.randint(t // 2, t - DIST_SERVE_STEPS, (b,), generator=gen,
                                      device=dev, dtype=torch.int32)}
    logits, cache = steps.make_prefill_step(cfg, shape, prec, device=dev)(roll, batch)
    serve = steps.make_serve_step(cfg, prec, device=dev)
    one, toks = [logits], []
    for _ in range(DIST_SERVE_STEPS):
        toks.append(logits.argmax(-1))
        logits, cache = serve(roll, toks[-1], cache)
        one.append(logits)
    del cache
    mesh = init_device_mesh("cuda", (2, world // 2), mesh_dim_names=("data", "model"))
    rules = ShardingRules(mesh, zero3=True)
    droll = distribute(roll, rules.params(roll), mesh)
    prefill2 = steps.make_prefill_step(cfg, shape, prec, rules=rules)
    serve2 = steps.make_serve_step(cfg, prec, rules=rules)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    walls, gaps, agree = [], [], []
    t0 = time.perf_counter()
    logits2, cache2 = prefill2(droll, batch)
    outs = [logits2]
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    for tok in toks:
        t0 = time.perf_counter()
        logits2, cache2 = serve2(droll, tok, cache2)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        outs.append(logits2)
    launches = dict(build.LAUNCHES)
    for a, b2 in zip(one, outs):
        full = b2.full_tensor()
        gaps.append(float((full - a).abs().max()))
        decisive = _top2_gap(a) > DECISIVE_GAP
        agree.append(bool((full.argmax(-1) == a.argmax(-1))[decisive].all()))
    finite = all(bool(torch.isfinite(o.to_local()).all()) for o in outs)
    return dict(gaps=gaps, agree=agree, launches=launches, walls=walls, finite=finite,
                local_cache_shape=list(cache2["slots"]["s0"]["kv"].k.to_local().shape))


def dist_pipeline(rank, world, dev):
    """15c: `pipeline_apply` over `world` stages, each one full-width
    qwen3-8b decoder layer (bf16, the training layer body), on
    DIST_PIPE_M microbatches of (1, DIST_PIPE_T, d); rank 0 holds it
    bit-equal to the layers run in sequence in this process."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core.fp8_params import tree_leaves
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply, shard_stages
    from repro_torch.models import Transformer
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models.transformer import _layer, _train_mask
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=world)
    stack = {}
    for path, leaf in Transformer(cfg, dev).iter_params(SEED):
        if path[0] == "blocks":
            stack.setdefault(path[2], {})[path[3]] = leaf
        del leaf
    spec = blocks_mod.layer_pattern(cfg)[0]
    t = DIST_PIPE_T
    positions = torch.arange(t, device=dev)[None, :]
    mask = _train_mask(t, None, dev)

    def stage_fn(p, h):
        return blocks_mod.apply_slot_full(h, p, spec, cfg, None, positions=positions,
                                          mask=mask)[0]

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    xs = torch.randn((DIST_PIPE_M, 1, t, cfg.d_model), generator=gen,
                     device=dev).to(torch.bfloat16)
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("stage",))
    piped = pipeline_apply(stage_fn, mesh)
    mine = shard_stages(stack, mesh)                # this rank's stage only
    with torch.no_grad():
        piped(mine, xs)                             # warm
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = piped(mine, xs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = dict(wall_s=wall, bubble=bubble_fraction(world, DIST_PIPE_M), digest=_digest(out),
                   local_stage_dims=sorted({t.to_local().shape[0] for t in tree_leaves(mine)}))
        if rank == 0:
            seq = []
            for m in range(DIST_PIPE_M):
                h = xs[m]
                for s in range(world):
                    h = stage_fn(_layer(stack, s), h)
                seq.append(h)
            rec["bit_equal_sequential"] = bool(torch.equal(out, torch.stack(seq)))
            rec["finite"] = bool(torch.isfinite(out.float()).all())
    return rec


def _dist_rank(rank, world, store_path, out_q):
    """One rank of phase 15 (a spawned process): join the gloo group
    through a FileStore on cuda:0, run 15a-15c, report."""
    import datetime
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        from repro_torch.distributed import host_collectives
        if host_collectives.needs_host(dev):
            host_collectives.install()
        from repro_torch.kernels import build
        build.library()
        res = {"rank": rank}
        for name, fn in (("15a", dist_compress), ("15b", dist_train),
                         ("15b8", dist_fp8_moments), ("15c", dist_pipeline),
                         ("15d", dist_serve)):
            t0 = time.perf_counter()
            res[name] = fn(rank, world, dev)
            res[name + "_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            dist.barrier()
        res["host_copied"] = dict(host_collectives.HOST_COPIED)
        res["host_bytes"] = dict(host_collectives.HOST_BYTES)
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out_q.put((rank, True, res))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def distributed_path(dev, gen, extra):
    """Phase 15: kernel 1 on long f32 rows, then DIST_RANKS spawned ranks
    on cuda:0 joined by gloo (collectives through the host: one card runs
    several ranks only over gloo) run 15a-15c; their reports are held
    here."""
    import gc
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile

    import torch
    t_phase = time.perf_counter()
    long_row_quant(dev, gen, extra)
    # the ranks are other processes: hand them the blocks this process's
    # allocator still caches from the earlier phases
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_dist_rank, args=(r, DIST_RANKS, f"{tmp}/store", out_q))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    reports, errors = {}, []
    try:
        deadline = time.perf_counter() + DIST_TIMEOUT_S
        while len(reports) + len(errors) < DIST_RANKS:
            try:
                rank, ok, res = out_q.get(timeout=max(1.0, deadline - time.perf_counter()))
            except queue.Empty:
                break
            if ok:
                reports[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not errors, "phase 15 ranks failed\n" + "\n".join(errors))
    check(len(reports) == DIST_RANKS,
          f"phase 15: {DIST_RANKS - len(reports)} ranks sent nothing in {DIST_TIMEOUT_S} s")
    r0 = reports[0]
    # 15a
    for i, rec in enumerate(r0["15a"]):
        tag = f"15a {rec['leaf']} {rec['dtype']}"
        digests = {reports[r]["15a"][i]["digest"] for r in reports}
        check(len(digests) == 1, f"{tag}: the sum differs between ranks")
        check(rec["bit_equal_plain"], f"{tag}: not bit-equal to the plain one-process sum")
        check(rec["rel_err"] < 0.03, f"{tag}: mean relative error {rec['rel_err']}")
        check(all(reports[r]["15a"][i]["launches"] == 1 for r in reports),
              f"{tag}: kernel 1 launches per call per rank "
              f"{[reports[r]['15a'][i]['launches'] for r in sorted(reports)]}")
        log(f"{tag}: equal on {DIST_RANKS} ranks, bit-equal to the plain sum, rel err "
            f"{rec['rel_err']:.4f}, kernel 1 once a call a rank, ms per call "
            f"{[round(reports[r]['15a'][i]['ms'], 2) for r in sorted(reports)]}, gathered "
            f"{rec['gathered_bytes']} B a rank (comm_bytes {rec['comm_bytes']})")
    # 15b
    b = r0["15b"]
    rel = abs(b["loss_sharded"] - b["loss_one_process"]) / abs(b["loss_one_process"])
    check(rel <= 1e-5, f"15b: sharded loss {b['loss_sharded']} vs one process "
                       f"{b['loss_one_process']}")
    err = max(reports[r]["15b"]["grad_err"] for r in reports)
    check(err <= 1e-4, f"15b: sharded gradients {err} of max|g| from the one-process step")
    share = max(reports[r]["15b"]["resident_bytes"] for r in reports) / b["one_process_bytes"]
    check(share <= 0.3, f"15b: a rank holds {share:.3f} of the one-process param + moment bytes")
    comms = set(b["comms"])
    check("all_gather_into_tensor" in comms and comms & {"all_reduce", "reduce_scatter_tensor"},
          f"15b: collectives {b['comms']}")
    check(all(reports[r]["15b"]["losses"] == b["losses"] for r in reports)
          and all(v == v and abs(v) < 1e4 for v in b["losses"]),
          f"15b: losses {[reports[r]['15b']['losses'] for r in sorted(reports)]}")
    log(f"15b {DIST_TRAIN} x{DIST_TRAIN_LAYERS} layers, (2, 2) mesh, ZeRO-3, B x T "
        f"{DIST_TRAIN_BT}: loss {b['loss_sharded']:.6f} (one process "
        f"{b['loss_one_process']:.6f}, rel {rel:.2e}), grads within {err:.2e} of max|g|, "
        f"resident {share:.3f} of one process's bytes, collectives {b['comms']}, "
        f"losses {b['losses']}, walls (s) {[round(w, 2) for w in b['walls']]}")
    # 15b's fp8 step
    f = r0["15b8"]
    check(all(not reports[r]["15b8"]["mismatched"] and reports[r]["15b8"]["params_equal"]
              for r in reports),
          "15b fp8 step: sharded moments or params differ from one process's "
          + json.dumps({r: reports[r]["15b8"]["mismatched"] for r in reports}))
    log(f"15b fp8 step: {f['moment_leaves']} moment leaves' payloads and scales bit-equal to "
        f"one process's on {DIST_RANKS} ranks, params equal; {f['aligned_leaves']} leaves "
        f"with aligned blocks; update {f['update_s']:.2f} s")
    # 15c
    c = r0["15c"]
    check(c["bit_equal_sequential"] and c["finite"],
          "15c: the pipeline differs from the layers in sequence")
    check(len({reports[r]["15c"]["digest"] for r in reports}) == 1,
          "15c: the stages hold different outputs")
    check(all(reports[r]["15c"]["local_stage_dims"] == [1] for r in reports),
          "15c: a rank holds more than its own stage's params")
    log(f"15c {DIST_RANKS} stages of qwen3-8b layers, M {DIST_PIPE_M} x (1, {DIST_PIPE_T}, "
        f"d), each rank holding its own stage's slice: bit-equal to the sequence, wall "
        f"{c['wall_s']:.3f} s, bubble_fraction {c['bubble']:.4f}")
    # 15d
    d = r0["15d"]
    layers = DIST_SERVE_LAYERS
    n_steps = 1 + DIST_SERVE_STEPS
    want = {"quant_act": 4 * layers * n_steps, "fp8_gemm": 7 * layers * n_steps,
            "decode": layers * DIST_SERVE_STEPS}
    for r in sorted(reports):
        got = {k: reports[r]["15d"]["launches"].get(k, 0) for k in want}
        check(got == want, f"15d rank {r}: launches {got}, want {want}")
        check(max(reports[r]["15d"]["gaps"]) <= LOGIT_ATOL and all(reports[r]["15d"]["agree"])
              and reports[r]["15d"]["finite"],
              f"15d rank {r}: logits {reports[r]['15d']['gaps']} (tol {LOGIT_ATOL}), decisive "
              f"argmax {reports[r]['15d']['agree']}")
    log(f"15d {DIST_SERVE} x{layers} layers, (2, 2) mesh, ZeRO-3, PrecisionConfig(), B x T "
        f"{DIST_SERVE_BT}: prefill + {DIST_SERVE_STEPS} serve steps, logit gaps to one "
        f"process {[round(g, 4) for g in d['gaps']]} (tol {LOGIT_ATOL}), decisive argmax "
        f"equal {d['agree']}, launches a rank {want} on each of {DIST_RANKS} ranks, local "
        f"cache layer {d['local_cache_shape']}, walls (s) "
        f"{[round(w, 3) for w in d['walls']]}")
    log("15: host-copied collectives " + json.dumps(r0["host_copied"]) + ", their operand "
        "bytes on rank 0 " + json.dumps(r0["host_bytes"]) + ", rank peaks (GB) "
        + json.dumps([round(reports[r]["peak_gb"], 2) for r in sorted(reports)])
        + ", seconds " + json.dumps({k: round(r0[k], 1) for k in
                                    ("15a_s", "15b_s", "15b8_s", "15c_s", "15d_s")}))
    wall = time.perf_counter() - t_phase
    log(f"phase 15: {wall:.1f} s")
    check(wall <= DIST_PHASE_S, f"phase 15 took {wall:.1f} s (budget {DIST_PHASE_S} s)")
    return {"compress": r0["15a"], "train": b, "fp8_step": f, "pipeline": c, "serve": d,
            "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 16: the roofline count against the card, one dry-run cell
# ---------------------------------------------------------------------------

def roofline_path():
    """Phase 16: `roofline.analysis.count_step` of the 7a and 7c serve
    steps (counted in phase 7, each beside the step the profiler times,
    which runs uncounted): each step's roofline bound (`step_time_s` at
    the H100's peaks) must not exceed the profiled step's device-busy
    time, else the count is wrong; then one dry-run
    cell (`launch.dryrun`, a fake process group of 256 ranks, meta
    DTensors) in a subprocess on this machine's torch, its status ok."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.roofline.analysis import analyze
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-8b")
    out = {}
    for tag in ("7a", "7c"):
        rec = ROOFLINE_COUNTS[tag]
        shape = ShapeConfig(rec["shape"][0], rec["shape"][1], rec["shape"][2], "decode")
        terms = analyze(rec["costs"], cfg, shape, "decode", 1)
        bound_ms = terms.step_time_s * 1e3
        ratio = bound_ms / rec["busy_ms"]
        k = rec["costs"]["kernels"]
        log(f"16 {tag} serve step: roofline bound {bound_ms:.3f} ms ({terms.dominant}; "
            f"compute {terms.compute_s * 1e3:.3f}, memory {terms.memory_s * 1e3:.3f} ms: "
            f"{rec['costs']['flops']:.4g} FLOPs, {rec['costs']['bytes']:.4g} bytes, of which "
            f"kernels {json.dumps(k)}), device busy {rec['busy_ms']:.3f} ms, bound / busy "
            f"{ratio:.3f}")
        check(bound_ms <= rec["busy_ms"], f"16 {tag}: the roofline bound {bound_ms:.3f} ms "
              f"exceeds the measured device-busy {rec['busy_ms']:.3f} ms: the count is wrong")
        out[tag] = dict(bound_ms=bound_ms, busy_ms=rec["busy_ms"], ratio=ratio,
                        dominant=terms.dominant, flops=rec["costs"]["flops"],
                        bytes=rec["costs"]["bytes"])
    arch, shape_name, mesh = DRYRUN_CELL
    out_dir = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                           "--shape", shape_name, "--mesh", mesh, "--out", str(out_dir)],
                          capture_output=True, text=True, env=env, timeout=DRYRUN_TIMEOUT_S)
    path = out_dir / f"{arch}__{shape_name}__{mesh}__fp8.json"
    check(proc.returncode == 0 and path.exists(),
          f"16: the dry-run cell failed (rc {proc.returncode}): {proc.stderr[-3000:]}")
    record = json.loads(path.read_text())
    check(record["status"] == "ok", f"16: dry-run status {record['status']}")
    roof = record["roofline"]
    log(f"16 dry run {arch} {shape_name} {mesh} (fake group of {record['n_devices']}): status "
        f"{record['status']} in {time.perf_counter() - t0:.1f} s; memory "
        + json.dumps({k: v for k, v in record["memory"].items() if k.endswith("bytes")
                      or k == "peak_bytes_est"})
        + f"; roofline compute {roof['compute_s']:.4e} s, memory {roof['memory_s']:.4e} s, "
        f"collective {roof['collective_s']:.4e} s, dominant {roof['dominant']}")
    out["dryrun"] = dict(status=record["status"], memory=record["memory"], roofline=roof)
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6: times at the main paths' shapes
# ---------------------------------------------------------------------------

def sdpa_decode_yardstick(q, kf, vf, lengths):
    """`F.scaled_dot_product_attention(..., enable_gqa=True)` over K/V
    dequantized beforehand into bf16 (B, KVH, S, D), with the length mask:
    the dequant (and a pool's gather) is not timed."""
    import torch
    import torch.nn.functional as F
    b, kvh, g, d = q.shape
    qb = q.reshape(b, kvh * g, 1, d)
    kb = kf.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
    vb = vf.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(kb.shape[2], device=q.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, enable_gqa=True)


def decode_row(args, reps=20, plain_reps=5):
    """Kernel 6's phase-6 row at one shape: its time, its plain version's,
    the SDPA yardstick's and the bound (the live K/V bytes read once)."""
    import torch
    from repro_torch.kernels import fp8_kv_attention as fa
    q, k, v, ks, vs, lengths = args
    b, kvh, g, d = q.shape
    kf = k.float() * ks
    vf = (v.float() * vs).to(torch.bfloat16)
    kf = kf.to(torch.bfloat16)
    row = timed_row(lambda: fa.fp8_decode_attention(*args),
                    lambda: fa.fp8_decode_attention_ref(*args),
                    library=sdpa_decode_yardstick(q, kf, vf, lengths), reps=reps,
                    plain_reps=plain_reps, plain_warmup=1)
    del kf, vf
    ctx = int(lengths.long().clamp(max=k.shape[1]).sum())
    nbytes = 2 * ctx * kvh * d * k.element_size() + 2 * 2 * q.numel() + 4 * b
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * ctx * kvh * g * d, BF16_TC_FLOPS)
    row["library"] = ("scaled_dot_product_attention(enable_gqa=True) on a pre-dequantized "
                      "bf16 copy, length mask (dequant excluded)")
    return row


def gemm_row(stack, m, gen, reps=20):
    """Kernel 3's phase-6 row for a (L, K, N) weight stack at M rows, its
    plain version's, and the bound.  Each call reads the next layer's
    weight, as a step does, so no call finds its weight in the 50 MB L2.
    Beside them, marked as another function: `torch._scaled_mm` with
    per-tensor fp8 scales on the same bytes, and cuBLAS's bf16 GEMM on a
    bf16 stack of the same shape (both rotating the same way)."""
    import itertools

    import torch
    from repro_torch.kernels import fp8_gemm as fg
    from repro_torch.kernels import fp8_quant as fq
    from repro_torch.kernels import ops
    layers, k, n = stack.data.shape
    dev = stack.data.device
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    a, a_s = fq.quantize_activation_kernel(x)
    # the padded (K_pad, N_pad) view of the sync's storage, as
    # `ops.fp8_matmul` hands it over (the same view where N % 128 == 0)
    ws = itertools.cycle([(ops._gemm_weight(w.data), w.scales)
                          for w in (stack.layer(r) for r in range(layers))])

    def kernel():
        w, w_s = next(ws)
        return fg.fp8_gemm(a, w, a_s, w_s)

    def plain():
        w, w_s = next(ws)
        return fg.fp8_gemm_ref(a, w, a_s, w_s)
    row = timed_row(kernel, plain, reps=reps, plain_reps=3, plain_warmup=1)
    nbytes = m * k + k * n + m * (k // 128) * 4 + (k // 128) * -(-n // 128) * 4 + m * n * 2
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * m * n * k, FP8_TC_FLOPS)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def scaled_mm():
        return torch._scaled_mm(a, next(ws)[0], one, one, out_dtype=torch.bfloat16)
    try:
        scaled_mm()
        row["scaled_mm_device_ms"] = device_time_ms(scaled_mm, reps=reps)
    except RuntimeError as exc:          # this layout or build unsupported
        row["scaled_mm_device_ms"] = None
        log(f"torch._scaled_mm refused M {m} K {k} N {n}: {str(exc)[:160]}")
    wb = torch.empty((layers, k, n), dtype=torch.bfloat16, device=dev)
    wb.normal_(generator=gen)
    bs = itertools.cycle(range(layers))
    row["bf16_mm_device_ms"] = device_time_ms(lambda: torch.mm(x, wb[next(bs)]), reps=reps)
    del wb
    row["another_function"] = ("torch._scaled_mm, per-tensor scales, same fp8 bytes; "
                               "torch.mm bf16 (cuBLAS) on a bf16 stack")
    log(f"fp8_gemm M {m} K {k} N {n}: device {row['device_ms']:.4f} ms (bound "
        f"{row['bound_ms']:.4f}, {row['bound_by']}), ms {row['ms']:.4f}, plain "
        f"{row['plain_ms']:.3f}; another function: _scaled_mm per-tensor "
        f"{row['scaled_mm_device_ms']}, bf16 mm {row['bf16_mm_device_ms']:.4f}")
    return row


def host_us(fn, reps=50, batches=9, warmup=20):
    """Host microseconds per call of `fn`, enqueue alone: the host clock
    around `reps` calls that do not wait for the card, the median of
    `batches` such runs (the host's clock varies run to run)."""
    import statistics

    import torch
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def quant_row(m, k, gen, dev, reps=20):
    """Kernel 1's phase-6 row at a (M, K) bf16 activation: its times, its
    plain version's, the bound, and `host_us`, the host time of one call
    of `ops.quantize_activation` (the wrapper the linears call)."""
    import torch
    from repro_torch.kernels import fp8_quant as fq
    from repro_torch.kernels import ops
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    row = timed_row(lambda: fq.quantize_activation_kernel(x),
                    lambda: fq.quantize_activation_ref(x), reps=reps,
                    plain_reps=3 if m > 1024 else 20)
    row["bound_ms"], row["bound_by"] = bound(m * k * 3 + m * k // 128 * 4, 6 * m * k, F32_FLOPS)
    row["host_us"] = host_us(lambda: ops.quantize_activation(x))
    log(f"quant_act ({m}, {k}): device {row['device_ms']:.4f} ms (bound {row['bound_ms']:.4f}, "
        f"{row['bound_by']}), ms {row['ms']:.4f}, plain {row['plain_ms']:.3f}, host "
        f"{row['host_us']:.1f} us a wrapper call")
    return row


def pair_row(stack, m, gen, reps=20):
    """Kernel 1 then kernel 3 on its output, as a linear calls them, at M
    rows of a (L, K, N) weight stack, each pair on the next layer's weight
    (cold in L2): `device_ms` (queued behind the spin) and `ms`, each
    kernel alone in the same rotation (kernel 3 back to back, where one
    GEMM may overlap the next, and `fp8_gemm_apart_device_ms`, each GEMM
    behind a one-element torch kernel, whose own time is
    `spacer_device_ms`), the bound of the pair's function
    x -> y (x, W and w_s read once, y written once; the fp8 activation
    between the two is not counted), and `host_us`, the host time of one
    `ops.quantize_activation` + `ops.fp8_matmul` (a W8A8 linear)."""
    import itertools

    import torch
    from repro_torch.kernels import fp8_gemm as fg
    from repro_torch.kernels import fp8_quant as fq
    from repro_torch.kernels import ops
    layers, k, n = stack.data.shape
    x = torch.randn((m, k), generator=gen, device=stack.data.device).to(torch.bfloat16)
    ws = itertools.cycle([stack.layer(r) for r in range(layers)])
    a, a_s = fq.quantize_activation_kernel(x)

    def pair():
        w = next(ws)
        q, q_s = fq.quantize_activation_kernel(x)
        return fg.fp8_gemm(q, w.data, q_s, w.scales)

    def gemm():
        w = next(ws)
        return fg.fp8_gemm(a, w.data, a_s, w.scales)
    tiny = torch.zeros(1, device=x.device)

    def gemm_apart():              # a torch kernel between two GEMMs: no overlap
        tiny.add_(1)
        return gemm()
    row = dict(ms=cuda_time_ms(pair, reps=reps), device_ms=device_time_ms(pair, reps=reps),
               quant_act_device_ms=device_time_ms(lambda: fq.quantize_activation_kernel(x),
                                                  reps=reps),
               fp8_gemm_device_ms=device_time_ms(gemm, reps=reps),
               fp8_gemm_apart_device_ms=device_time_ms(gemm_apart, reps=reps),
               spacer_device_ms=device_time_ms(lambda: tiny.add_(1), reps=reps),
               host_us=host_us(lambda: ops.fp8_matmul(ops.quantize_activation(x), next(ws))))
    nbytes = m * k * 2 + k * n + (k // 128) * (n // 128) * 4 + m * n * 2
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * m * n * k, FP8_TC_FLOPS)
    log(f"quant_act + fp8_gemm M {m} K {k} N {n}: device {row['device_ms']:.4f} ms (alone "
        f"{row['quant_act_device_ms']:.4f} + {row['fp8_gemm_device_ms']:.4f}, kernel 3 behind "
        f"a spacer {row['fp8_gemm_apart_device_ms']:.4f} - {row['spacer_device_ms']:.4f}; bound "
        f"{row['bound_ms']:.4f}, {row['bound_by']}), ms {row['ms']:.4f}, host "
        f"{row['host_us']:.1f} us a linear")
    return row


def sync_quant_ms(shapes, gen, reps=3):
    """Kernel 2's device time over a weight sync's stacked leaves, each a
    seeded bf16 (L, K, N) weight of `shapes` quantized by
    `ops.quantize_weight` as the sync calls it (in this tree, into the
    K-major storage kernel 3 streams)."""
    import torch
    from repro_torch.kernels import ops
    total = 0.0
    for shape in shapes:
        w = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        w.normal_(generator=gen)
        total += device_time_ms(lambda: ops.quantize_weight(w), reps=reps, warmup=1)
        del w
    return total


def time_kernels(dev, gen, results, cfg, roll, traj, contig_lengths, extra):
    import torch
    from repro_torch.core.precision import E4M3
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.kernels import fp8_kv_attention as fa
    from repro_torch.kernels import fp8_quant as fq
    d, f = cfg.d_model, cfg.d_ff

    # quant_act at the decode shape (8, d_model) and the prefill shapes
    for m in QUANT_ACT_MS:
        row = quant_row(m, d, gen, dev)
        extra.append(dict(kernel="quant_act", shape=[m, d], **row))
        if m == 8:
            results["quant_act"].update(row)

    # quant_weight on the largest stacked leaf the sync quantizes (its
    # K-major store moves the bytes of a row-major one)
    w = torch.empty((cfg.n_layers, d, f), dtype=torch.bfloat16, device=dev)
    w.normal_(generator=gen)
    row = timed_row(lambda: fq.quantize_weight_kernel(w), lambda: fq.quantize_weight_ref(w),
                    reps=3, plain_reps=3, plain_warmup=1)
    row["bound_ms"], row["bound_by"] = bound(w.numel() * 3 + w.numel() // 16384 * 4,
                                             6 * w.numel(), F32_FLOPS)
    del w
    extra.append(dict(kernel="quant_weight", shape=[cfg.n_layers, d, f], **row))
    results["quant_weight"].update(row)

    # fp8_gemm on the real rollout weights, each call on the next layer's
    # (cold in L2), at the four (K, N) and the paths' M
    for (block, name), (k, n) in GEMM_SHAPES.items():
        stack = roll["blocks"]["s0"][block][name]
        for m in GEMM_MS:
            row = gemm_row(stack, m, gen)
            extra.append(dict(kernel="fp8_gemm", shape=[m, k, n], weight=name, **row))
            if (m, name) == (8, "wg"):
                results["fp8_gemm"].update(row)
    # kernel 1 + kernel 3 as a linear calls them, at M 8 and the four (K, N)
    for (block, name), (k, n) in GEMM_SHAPES.items():
        row = pair_row(roll["blocks"]["s0"][block][name], PAIR_M, gen)
        extra.append(dict(kernel="quant_act+fp8_gemm", shape=[PAIR_M, k, n], weight=name,
                          **row))
    leaves = [qt.data.shape for leaf in roll["blocks"]["s0"].values()
              for qt in leaf.values() if isinstance(qt, QuantizedTensor)]
    log(f"weight sync: kernel 2 over the rollout's {len(leaves)} quantized leaves "
        f"{sync_quant_ms(leaves, gen):.3f} ms of device time (K-major store)")

    # paged decode at the greedy run's final context lengths
    lengths = (traj.prompt_lengths + traj.response_lengths).to(torch.int32)
    q, kq, vq, ks, vs, tables, lengths, _ = decode_case(
        dev, gen, b=8, kvh=cfg.n_kv_heads, g=cfg.n_heads // cfg.n_kv_heads,
        d=cfg.d_head, bs=16, max_len=int(lengths.max()), lengths=lengths)
    kf, vf = fa._live_kv(kq, vq, ks, vs, tables, lengths)    # gathered, `_deq`-ed
    row = timed_row(
        lambda: fa.fp8_paged_decode_attention(q, kq, vq, ks, vs, tables, lengths),
        lambda: fa.fp8_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lengths),
        library=sdpa_decode_yardstick(q, kf, vf, lengths))
    del kf, vf
    ctx = int(lengths.sum())
    kvh, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    nbytes = 2 * ctx * kvh * dh + 2 * 2 * 8 * kvh * g * dh + tables.numel() * 4 + 8 * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * ctx * kvh * g * dh, BF16_TC_FLOPS)
    extra.append(dict(kernel="paged_decode", shape=[8, kvh, g, dh], context=ctx,
                      library="scaled_dot_product_attention(enable_gqa=True) on a "
                      "pre-gathered, pre-dequantized bf16 copy, length mask (gather "
                      "excluded)", **row))
    results["paged_decode"].update(row)

    # contiguous decode (kernel 6) at 7a's final lengths (S 1057), and at
    # DECODE_32K's cache (S 32768, all live) at batch 8; LONG_500K's row
    # was taken in phase 7c on the real cache
    geo = fa.decode_geometry(dh, g, E4M3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"kernel 6 body (e4m3, D {dh}, G {g}): ring of {geo['stages']} stages, tiles of "
        f"{geo['tile_keys']} keys, {geo['warps']} warps per block, {geo['smem_bytes']} bytes "
        f"of dynamic shared memory per block, registers held to {geo['register_blocks']} "
        f"blocks per SM; (n_split, span) at S 1057 / 32768 / 524288: "
        + ", ".join(str(fa.decode_splits(s_len, sms)) for s_len in (1057, 32768, 524288)))
    for b, s_len, lens in ((8, CONTIG_SHAPE[1] + 1, contig_lengths), (8, 32768, [32768] * 8)):
        args = contiguous_case(dev, gen, b, s_len, lens, kvh, g, dh)
        hold_decode(args, f"decode B={b} S={s_len} lengths {args[-1].tolist()}", results)
        row = decode_row(args)
        extra.append(dict(kernel="decode", shape=[b, kvh, g, dh], s_max=s_len,
                          context=int(args[-1].sum()), **row))
        if s_len == CONTIG_SHAPE[1] + 1:
            results["decode"].update(row)
        del args

    # chunked prefill at the engine's chunk (C 128, 640 tokens of context),
    # at the speculative verify chunk (C 5), at the engine's first chunk
    # (128 tokens) and at a 4096-token context
    log(f"paged attention body: kernel 5 {fa.PREFILL_ROWS_PER_BLOCK} chunk rows per block, "
        f"kernel 4 one (slot, kv-head) per block; key tiles of {fa.paged_key_tile(dh)} "
        f"positions at D {dh}")
    for c, start, length in ((128, 512, 640), (5, 295, 300), (128, 0, 128), (128, 3968, 4096)):
        q, kq, vq, ks, vs, tables, st, ln, _ = prefill_case(
            dev, gen, [start], [length], c, kvh=kvh, g=g, d=dh,
            w=max(-(-ENGINE_MAX_SEQ // KV_BLOCK), -(-length // KV_BLOCK)))
        args = (q, kq, vq, ks, vs, tables, st, ln)
        lib = sdpa_yardstick(*args)
        row = timed_row(lambda: fa.fp8_paged_prefill_attention(*args),
                        lambda: fa.fp8_paged_prefill_attention_ref(*args), library=lib)
        keys = sum(p + 1 for p in range(start, min(start + c, length)))   # causal
        live = -(-min(start + c, length) // KV_BLOCK) * KV_BLOCK
        nbytes = 2 * live * kvh * dh + 2 * 2 * c * kvh * g * dh + tables.numel() * 4 + 8
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * keys * kvh * g * dh,
                                                 BF16_TC_FLOPS)
        extra.append(dict(kernel="paged_prefill", shape=[1, c, kvh, g, dh], start=start,
                          lengths=length, library="scaled_dot_product_attention on a "
                          "pre-gathered, pre-dequantized bf16 copy (gather excluded)", **row))
        if (c, start) == (128, 512):
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
    compare_fleet_block(dev, gen, results)
    torch.cuda.synchronize()
    compare_contiguous_decode(dev, gen, results)
    torch.cuda.synchronize()

    cfg = get_config("qwen3-8b")
    model, roll, traj = main_path(dev, results, cfg)
    torch.cuda.synchronize()
    engine_path(dev, results, cfg, roll)
    torch.cuda.synchronize()
    extra = []
    contig_lengths = contiguous_path(dev, gen, results, cfg, roll, extra)
    torch.cuda.synchronize()
    time_kernels(dev, gen, results, cfg, roll, traj, contig_lengths, extra)
    log("kernel_timings " + json.dumps(extra))
    del model, roll, traj
    train_stats = train_path(dev, cfg)
    fleet = fleet_path(dev, cfg)
    keys = ("sync_ms", "rollout_s", "score_backward_ms", "optimizer_ms", "step_s")
    log("phase 8 (generate) against 9a (fleet), per step: " + json.dumps(
        {"generate": [{k: r[k] for k in keys} for r in train_stats["train_steps"]],
         "fleet": [{k: r[k] for k in keys + ("push_ms",)} for r in fleet["trainer"]["steps"]],
         "peak_gb": [train_stats["train_peak_gb"], fleet["trainer"]["peak_gb"]]}))
    full_fp8 = full_fp8_path(dev, cfg)
    tr = full_fp8["trainer"]
    log("phase 8 (PrecisionConfig()) against 10a (FULL_FP8_ROLLOUT), per step: " + json.dumps(
        {"phase8": [{k: r[k] for k in keys} for r in train_stats["train_steps"]],
         "full_fp8": [{k: r[k] for k in keys} for r in tr["steps"]],
         "peak_gb": [train_stats["train_peak_gb"], tr["peak_gb"], tr["e2e_peak_gb"],
                     full_fp8["fleet"]["peak_gb"]],
         "mismatch": {name: {k: tr[f"{name}_rollout"][k] for k in (
             "mismatch_kl", "corr_weight_ess", "rollout_s")}
             for name in ("full_fp8", "fp8", "bf16")},
         "phase8_mismatch": {name: train_stats[f"{name}_rollout"]["mismatch_kl"]
                             for name in ("fp8", "bf16")}}))
    breadth = breadth_path(dev, gen)
    log("phase 11 peaks (GB): " + json.dumps({k: v["peak_gb"] for k, v in breadth.items()}))
    moe_extra = []
    moe = moe_path(dev, gen, results, moe_extra)
    log("kernel_timings_moe " + json.dumps(moe_extra))
    log("phase 12 peaks (GB): " + json.dumps({k: v["peak_gb"] for k, v in moe.items()}))
    ssm_extra = []
    ssm_hybrid = ssm_hybrid_path(dev, gen, ssm_extra)
    log("kernel_timings_ssm " + json.dumps(ssm_extra))
    log("phase 13 peaks (GB): " + json.dumps({k: v["peak_gb"] for k, v in ssm_hybrid.items()}))
    encdec_extra = []
    encdec_vlm = encdec_vlm_path(dev, gen, encdec_extra)
    log("kernel_timings_encdec_vlm " + json.dumps(encdec_extra))
    log("phase 14 peaks (GB): " + json.dumps({k: v["peak_gb"] for k, v in encdec_vlm.items()}))
    dist_extra = []
    distributed_path(dev, gen, dist_extra)
    log("kernel_timings_distributed " + json.dumps(dist_extra))
    roofline_path()
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"wall {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    print(json.dumps({"kernels": [{k: results[n][k] for k in keys} for n in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
