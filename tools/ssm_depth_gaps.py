#!/usr/bin/env python3
"""How far a randomly initialised Mamba2 stack carries a last-bit
difference, in the JAX reference and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/ssm_depth_gaps.py

For a reduced mamba2-780m (d_model 256, state 64, heads of 64, vocab 512;
random weights from seed 0) at 4, 16 and 48 layers, it prints one JSON
line per depth:

* `fp8_vs_bf16_ref`, `fp8_vs_bf16_port`: the largest logit gap between
  a W8A8 (`PrecisionConfig()`) and a `BF16_ROLLOUT` prefill of the same
  4 x 64 tokens, in the reference and in the port;
* `port_vs_ref_fp8`: the largest logit gap between the port's and the
  reference's W8A8 prefill;
* `decode_vs_teacher_ref` and `kl_decode_vs_teacher_ref`: the
  reference's bf16 prefill of 32 tokens plus 7 decode steps against its
  teacher-forced `forward_train` on the same 39 tokens (largest logit gap,
  and the mean KL of the teacher-forced distribution from the decoded);
* `chunk_state_ref`, `chunk_state_port` and `chunk_logits_ref`,
  `chunk_logits_port`: a W8A8 paged prefill of one 200-token prompt in
  chunks of 128 (a ragged last chunk) against the one-shot prefill of it:
  per SSM layer, the larger of h's and the conv tail's largest gap over
  their largest entry, and the next-token logits' largest gap.

The numbers read the model's sensitivity, not a kernel's: every path
here is plain (XLA on the CPU, the port's plain versions).  Imports the
reference, so it runs where JAX does, never on the card.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import torch

from repro import configs as rc
from repro.core import precision as jp
from repro.models import transformer as rt
from repro.models.blocks import n_repeats
from repro.rl import sync_policy_weights as jsync
from repro_torch import bridge
from repro_torch import configs as tc
from repro_torch.core import precision as tp
from repro_torch.models import Transformer
from repro_torch.rl import sync_policy_weights as tsync

WIDTHS = dict(d_model=256, ssm_state=64, ssm_head_dim=64, vocab_size=512)
DEPTHS = (4, 16, 48)


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _state_gaps(one, chunked, repeats):
    """Per SSM layer, in (repeat, slot) order: max(|h - h'|) / max|h| and
    the same of the conv tail, the larger of the two."""
    gaps = []
    for r in range(repeats):
        for name, sd in one["slots"].items():
            if "ssm" in sd:
                pairs = zip((sd["ssm"].h, sd["ssm"].conv),
                            (chunked["slots"][name]["ssm"].h, chunked["slots"][name]["ssm"].conv))
                gaps.append(max(float(np.abs(_f32(a[r]) - _f32(b[r])).max()
                                      / max(np.abs(_f32(a[r])).max(), 1e-30))
                                for a, b in pairs))
    return gaps


def chunk_gaps(jcfg, tcfg, params) -> dict:
    """Chunked (C 128) against one-shot W8A8 prefill, reference and port."""
    n, c = 200, 128
    prompt = np.random.default_rng(1).integers(3, WIDTHS["vocab_size"], (1, n)).astype(np.int32)
    jprec, tprec = jp.PrecisionConfig(), tp.PrecisionConfig()
    jroll, _ = jsync(params, jprec)
    one_logits, one = jax.jit(lambda p, t, l, k: rt.prefill(
        p, {"tokens": t, "lengths": l}, k, jcfg, jprec))(
        jroll, prompt, np.array([n], np.int32), rt.init_cache(jcfg, 1, n + 1, jprec, page_size=16))
    chunk_fn = jax.jit(lambda p, t, s, m, k: rt.prefill_chunk(p, t, s, m, k, jcfg, jprec))
    cache = rt.init_cache(jcfg, 1, n + 1, jprec, page_size=16)
    for start in range(0, n, c):
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :min(c, n - start)] = prompt[0, start:start + c]
        logits, cache = chunk_fn(jroll, chunk, np.array([start], np.int32),
                                 np.array([min(c, n - start)], np.int32), cache)
    repeats = n_repeats(jcfg)
    out = dict(chunk_state_ref=_state_gaps(one, cache, repeats),
               chunk_logits_ref=float(np.abs(np.asarray(one_logits) - np.asarray(logits)).max()))
    troll, _ = tsync(bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), tprec)
    model = Transformer(tcfg, "cpu")
    one_logits, one = model.prefill(troll, {"tokens": torch.from_numpy(prompt),
                                            "lengths": torch.tensor([n], dtype=torch.int32)},
                                    model.init_cache(1, n + 1, tprec, page_size=16), tprec)
    cache = model.init_cache(1, n + 1, tprec, page_size=16)
    for start in range(0, n, c):
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :min(c, n - start)] = prompt[0, start:start + c]
        logits, cache = model.prefill_chunk(troll, torch.from_numpy(chunk), [start],
                                            [min(c, n - start)], cache, tprec)
    out.update(chunk_state_port=_state_gaps(one, cache, model.repeats),
               chunk_logits_port=float((one_logits - logits).abs().max()))
    return out


def depth_row(layers: int) -> dict:
    jcfg = rc.get_config("mamba2-780m").reduced(n_layers=layers, **WIDTHS)
    tcfg = tc.get_config("mamba2-780m").reduced(n_layers=layers, **WIDTHS)
    params = jax.jit(rt.init_params, static_argnums=0)(jcfg, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(3, WIDTHS["vocab_size"], (4, 64)).astype(np.int32)
    lengths = np.full(4, 64, np.int32)
    prefill = {}
    for name, jprec, tprec in (("fp8", jp.PrecisionConfig(), tp.PrecisionConfig()),
                               ("bf16", jp.BF16_ROLLOUT, tp.BF16_ROLLOUT)):
        jroll, _ = jsync(params, jprec)
        ref, _ = jax.jit(lambda p, t, l, c, jprec=jprec: rt.prefill(
            p, {"tokens": t, "lengths": l}, c, jcfg, jprec))(
            jroll, tokens, lengths, rt.init_cache(jcfg, 4, 65, jprec))
        troll, _ = tsync(bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                         tprec)
        model = Transformer(tcfg, "cpu")
        port, _ = model.prefill(troll, {"tokens": torch.from_numpy(tokens),
                                        "lengths": torch.from_numpy(lengths)},
                                model.init_cache(4, 65, tprec), tprec)
        prefill[name] = np.asarray(ref), port.numpy()

    prec = jp.BF16_ROLLOUT
    logits, cache = jax.jit(lambda p, t, l, c: rt.prefill(
        p, {"tokens": t, "lengths": l}, c, jcfg, prec))(
        params, tokens[:, :32], np.full(4, 32, np.int32), rt.init_cache(jcfg, 4, 41, prec))
    step = jax.jit(lambda p, t, c: rt.decode_step(p, t, c, jcfg, prec)[:2])
    decoded = [np.asarray(logits)]
    for i in range(32, 39):
        logits, cache = step(params, tokens[:, i], cache)
        decoded.append(np.asarray(logits))
    teacher, _ = jax.jit(lambda p, t: rt.forward_train(p, {"tokens": t}, jcfg))(
        params, tokens[:, :39])
    decoded, teacher = np.stack(decoded, 1), np.asarray(teacher)[:, 31:39]
    lp_dec, lp_tf = _log_softmax(decoded), _log_softmax(teacher)
    return dict(
        layers=layers,
        fp8_vs_bf16_ref=float(np.abs(prefill["fp8"][0] - prefill["bf16"][0]).max()),
        fp8_vs_bf16_port=float(np.abs(prefill["fp8"][1] - prefill["bf16"][1]).max()),
        port_vs_ref_fp8=float(np.abs(prefill["fp8"][1] - prefill["fp8"][0]).max()),
        decode_vs_teacher_ref=float(np.abs(decoded - teacher).max()),
        kl_decode_vs_teacher_ref=float((np.exp(lp_tf) * (lp_tf - lp_dec)).sum(-1).mean()),
        max_abs_logit=float(np.abs(prefill["bf16"][0]).max()),
        **chunk_gaps(jcfg, tcfg, params))


def main():
    torch.set_num_threads(4)
    for layers in DEPTHS:
        print(json.dumps(depth_row(layers)), flush=True)


if __name__ == "__main__":
    main()
