"""Kernel routing configuration for the serving hot path (port of
`repro.kernels.config`, same spellings).

One small frozen config decides which attention hot paths run through the
CUDA kernels instead of the table-gather paths.  It is threaded as a
single object from `ServingEngine(kernel_config=...)` into
`Transformer.prefill_chunk` / `Transformer.decode_step`, so "which
mechanism serves this step" is decided in exactly one place.

Accepted spellings (string shorthands map onto the dataclass):

    "off"      — table gather + plain attention everywhere (the
                 reference's debugging baseline)
    "decode"   — fp8_paged_decode_attention (kernel 4) for the fused decode
    "prefill"  — fp8_paged_prefill_attention (kernel 5) for chunks
    "all"      — both (the production configuration)

On the CPU the kernel wrappers run their plain versions; on the card they
launch the CUDA kernels.  The numerics contract is the repo-wide one:
allclose + argmax agreement with the gather paths, never token equality
across mechanisms.

`KernelConfig.resolve(spec, precision)` is the one place that turns a
caller's choice into a config, with None as the port's default.  The
port's default is "all", where the reference's is "off" — except under
`precision.quantize_attention` ("Full FP8"), where it is "off" as in the
reference: the reference's kernel branches skip the QDQ of q, k, v and P,
its defaults take the jnp branch, and so every reference rollout under
FULL_FP8_ROLLOUT quantizes its attention.  An explicit choice ("all",
"decode", `use_kernel=True`) keeps the reference's kernel semantics and
skips the QDQ.  The precision config alone decides, never a failure.
On an attention-free model (mamba2) the attention kernels have nothing
to serve: the default resolves to "off", and an explicit kernel request
raises, as the reference's engine asserts.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    prefill: bool = False   # chunked-prefill attention through the kernel
    decode: bool = False    # fused decode attention through the kernel

    @classmethod
    def parse(cls, spec) -> "KernelConfig":
        """Accept a KernelConfig or one of the string shorthands."""
        if isinstance(spec, KernelConfig):
            return spec
        table = {
            "off": cls(),
            "decode": cls(decode=True),
            "prefill": cls(prefill=True),
            "all": cls(prefill=True, decode=True),
        }
        if spec not in table:
            raise ValueError(
                f"unknown kernel_config {spec!r}; expected a KernelConfig "
                f"or one of {sorted(table)}")
        return table[spec]

    @classmethod
    def resolve(cls, spec, precision, attention_free: bool = False) -> "KernelConfig":
        """The caller's `spec` (a KernelConfig or a shorthand), or with
        None the port's default for `precision`: every kernel, or none
        under `quantize_attention` (the reference's default branch, which
        quantizes the attention math) or on an `attention_free` model,
        where an explicit kernel request raises a `ValueError`."""
        if spec is None:
            if precision.quantize_attention or attention_free:
                return cls()
            return cls(prefill=True, decode=True)
        config = cls.parse(spec)
        if attention_free and config.any:
            raise ValueError(
                f"kernel_config {config.name!r}: attention kernels have nothing "
                "to serve on an attention-free model; leave it unset or 'off'")
        return config

    @property
    def name(self) -> str:
        """The shorthand this config is spelled by."""
        return {(False, False): "off", (False, True): "decode",
                (True, False): "prefill", (True, True): "all"}[(self.prefill, self.decode)]

    @property
    def any(self) -> bool:
        return self.prefill or self.decode
