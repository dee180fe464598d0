"""Roofline analysis of one step of the port (port of
`repro.roofline.analysis`).

Three terms per (arch x shape x mesh), all in seconds per step:

    compute    = FLOPs_per_device      / PEAK_FLOPS
    memory     = bytes_per_device      / HBM_BW
    collective = coll_bytes_per_device / ICI_BW

The reference reads FLOPs and bytes from XLA's `cost_analysis()` of the
compiled SPMD module and parses collective bytes out of its HLO.  The
port has no compiled artifact, so `count_step` runs the step once under a
dispatch mode and counts what this rank executes:

  * FLOPs of each aten op by `torch.utils.flop_counter`'s per-op formulas
    (`flop_registry`, the table `FlopCounterMode` uses), on the local
    shards a DTensor op runs on;
  * bytes of each aten op: its tensor operands read and its results
    written (views move nothing; an in-place op's written operand counts
    once, `index_put_` its values only);
  * each `kernels.ops` wrapper reports its own kernel's FLOPs and bytes
    from its shapes (the formulas of `chip_smoke.py`'s phase-6 bounds) and
    the aten ops it runs inside itself are not counted again.  On the card
    the kernels are ctypes launches no dispatch mode sees; on the CPU
    their plain versions run; on "meta" neither does.  The same work
    counts the same whichever computes it;
  * collectives: `CommDebugMode` counts them, and the functional
    collectives' result bytes (what a rank receives, as the reference
    sums result bytes) are summed per kind: `collective_bytes`.

The constants are the H100 SXM5's (NVIDIA H100 Tensor Core GPU
datasheet): dense BF16 tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4's
900 GB/s total per GPU, 450e9 B/s in each direction.  FP8 work is held
to the BF16 peak, as the reference holds every FLOP to one peak.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict

# H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet)
PEAK_FLOPS = 989.4e12      # dense bf16 FLOP/s per GPU
HBM_BW = 3.35e12           # HBM3 bytes/s per GPU
ICI_BW = 450e9             # NVLink 4 bytes/s per direction per GPU

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# `torch.ops._c10d_functional` op -> the reference's collective kind
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "wait_tensor", "_wrap_tensor_autograd", "detach", "lift_fresh", "set_",
             "resize_")


def _tensors(tree, out=None):
    """The tensors in nested tuples, lists and dicts (an op's arguments or
    results)."""
    import torch
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _bytes(t) -> int:
    """Bytes of `t`'s elements, at most its storage's (an expanded view
    reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def collective_bytes(comm_counts: dict, result_bytes: dict) -> Dict[str, int]:
    """The reference's dict: result bytes per collective kind, and under
    "_counts" the calls per kind, from a `CommDebugMode`'s
    `get_comm_counts()` and the functional collectives' result bytes
    `count_step` summed per op name."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for op, n in comm_counts.items():
        kind = _FUNCOL_KIND.get(str(op).split(".")[-1])
        if kind is not None:
            counts[kind] += int(n)
    for name, b in result_bytes.items():
        kind = _FUNCOL_KIND.get(name)
        if kind is not None:
            out[kind] += int(b)
    out["_counts"] = counts
    return out


class _Counter:
    """The dispatch mode's tallies (also `kernels.ops.COST_COUNTERS`'
    entry: `kernel` and `hidden`)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.hidden = 0
        self.coll_bytes = collections.Counter()
        self.kernels = {}
        self.live = {}          # storage id -> (weak ref, bytes)
        self.live_bytes = 0
        self.peak_bytes = 0

    def allocated(self, ins, outs):
        """Track the storages `outs` that no input shares (fresh
        allocations) until they are freed; keep the peak of their bytes."""
        from torch.multiprocessing.reductions import StorageWeakRef

        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.live_bytes -= n
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in seen or st._cdata in self.live:
                continue
            self.live[st._cdata] = (StorageWeakRef(st), st.nbytes())
            self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def kernel(self, name, flops, nbytes):
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)


def _mode(counter):
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _CountMode(TorchDispatchMode):
        """Counts this rank's aten ops.  A DTensor op is handed back
        (NotImplemented) so that DTensor runs it, and its local ops and
        collectives come through here; DTensor's shape inference on fake
        tensors is not counted."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            ins = _tensors((args, kwargs))
            if any(isinstance(t, FakeTensor) for t in ins + _tensors(out)):
                return out
            counter.allocated(ins, _tensors(out))
            if counter.hidden:
                return out
            name = func.__name__.split(".")[0]
            if func.namespace == "_c10d_functional":
                if name in _FUNCOL_KIND:
                    counter.coll_bytes[name] += sum(_bytes(t) for t in _tensors(out))
                return out
            packet = func.overloadpacket
            if packet in flop_registry:
                # `mm.dtype` / `bmm.dtype`: the formula takes the operands only
                fargs = args[:2] if func._overloadname == "dtype" else args
                counter.flops += int(flop_registry[packet](*fargs, **kwargs, out_val=out))
            if func.is_view or name in _NO_BYTES:
                return out
            written = [a for i, a in enumerate(func._schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write]
            if name == "index_put_":
                counter.bytes += 2 * _bytes(args[2]) + sum(_bytes(t) for t in _tensors(args[1]))
                return out
            outs = _tensors(out)
            if written:     # in-place / out=: the written operand counts once
                w_names = {a.name for a in written}
                read = [t for a, v in zip(func._schema.arguments, args)
                        if a.name not in w_names for t in _tensors(v)]
                read += [t for k, v in kwargs.items() if k not in w_names
                         for t in _tensors(v)]
                counter.bytes += sum(_bytes(t) for t in read + outs)
                return out
            counter.bytes += sum(_bytes(t) for t in ins + outs)
            return out

    return _CountMode()


def count_step(fn, *args, **kwargs):
    """Run `fn(*args, **kwargs)` once, counting this rank's work ->
    (result, costs), costs = {"flops", "bytes", "coll" (bytes per kind),
    "coll_counts" (calls per kind), "kernels" ({name: calls, flops,
    bytes} of the `kernels.ops` wrappers, included in flops and bytes),
    "peak_live_bytes" (the most bytes of storage the step had allocated
    and not yet freed at once), "end_live_bytes" (what it still holds at
    its end: its new outputs)}.  Nothing is timed: on the card the lengths
    a kernel reads are fetched to the host to size its work."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.kernels import ops

    counter = _Counter()
    comm = CommDebugMode()
    ops.COST_COUNTERS.append(counter)
    try:
        with comm, _mode(counter):
            out = fn(*args, **kwargs)
    finally:
        ops.COST_COUNTERS.remove(counter)
    counter.allocated([], [])
    coll = collective_bytes(comm.get_comm_counts(), counter.coll_bytes)
    counts = coll.pop("_counts")
    return out, {"flops": float(counter.flops), "bytes": float(counter.bytes),
                 "coll": {k: float(v) for k, v in coll.items()}, "coll_counts": counts,
                 "kernels": counter.kernels, "peak_live_bytes": counter.peak_bytes,
                 "end_live_bytes": counter.live_bytes}


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict
    model_flops: float            # 6*N(_active)*D tokens-based estimate
    n_devices: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time bound: the largest of the three terms
        (perfect overlap; their sum is the no-overlap bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): recompute and dispatch
        waste."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline bound."""
        capacity = self.step_time_s * PEAK_FLOPS * self.n_devices
        return self.model_flops / capacity if capacity else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "n_devices": self.n_devices,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu": self.mfu,
        }


def model_flops_for_cell(cfg, shape, step_kind: str) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed per step.

    train: forward + backward = 6*N per token over B*S tokens.
    prefill: forward only = 2*N per token over B*S tokens.
    decode: forward only = 2*N per token over B tokens (attention over the
    KV cache is outside the 6ND convention).
    """
    n = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    if step_kind == "train":
        return 6.0 * n * b * s
    if step_kind == "prefill":
        return 2.0 * n * b * s
    return 2.0 * n * b


def analyze(costs: dict, cfg, shape, step_kind: str, n_devices: int) -> RooflineTerms:
    """`RooflineTerms` of one step from `count_step`'s costs (the
    reference's `analyze`, which reads a compiled artifact)."""
    return RooflineTerms(
        flops_per_device=costs["flops"],
        bytes_per_device=costs["bytes"],
        coll_bytes_per_device=float(sum(costs["coll"].values())),
        coll_breakdown={"bytes": costs["coll"], "counts": costs["coll_counts"]},
        model_flops=model_flops_for_cell(cfg, shape, step_kind),
        n_devices=n_devices,
    )
