"""Fault-tolerant checkpointing: atomic, resumable (port of
`repro.checkpoint.checkpointer`).

  * every checkpoint is a directory `step_<N>/` holding one `.npz` of the
    flattened tree's tensors and a JSON manifest (leaf paths, dtypes,
    shapes, and the caller's `extra`: data cursor, step);
  * writes are atomic: write to `step_<N>.tmp/`, fsync, rename — a crash
    mid-write never corrupts the latest checkpoint;
  * `restore(like)` rebuilds the tree with `like`'s structure from the
    manifest, as CPU tensors; the caller copies them onto its device;
  * retention keeps the newest `keep` checkpoints.

The reference writes its manifest with msgpack; the port writes JSON
(no msgpack dependency).  Trees are nested dicts, tuples and NamedTuples
(`AdamWState`, `QuantizedTensor`, whose `block` is structure, not data)
of tensors.  bf16 and fp8 tensors are stored as raw bytes (`packed`:
"u8") and viewed back on restore.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor

_STEP_RE = re.compile(r"^step_(\d+)$")
_NUMPY_NATIVE = (torch.float32, torch.float64, torch.float16, torch.int8,
                 torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)


def _items(tree):
    """(key, child) pairs of a container node; None for a tensor leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, QuantizedTensor):
        return [("data", tree.data), ("scales", tree.scales)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def flatten_tree(tree, prefix=""):
    """[(path, tensor)] of a tree of dicts, tuples and NamedTuples, in the
    containers' own order; paths join keys with "/"."""
    items = _items(tree)
    if items is None:
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree).__name__}, "
                            "not a tensor")
        return [(prefix, tree)]
    out = []
    for k, child in items:
        out.extend(flatten_tree(child, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(like, leaves):
    """`like`'s structure with its tensors taken in order from `leaves`."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, QuantizedTensor):
        return QuantizedTensor(next(leaves), next(leaves), like.block)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.removeprefix("torch."))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write -----------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        """Atomic save.  `tree`: a tree of tensors; `extra`: a small
        JSON-able dict (data cursor, step...)."""
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        arrays, meta_leaves = {}, []
        for i, (path, t) in enumerate(flatten_tree(tree)):
            t = t.detach().cpu().contiguous()
            packed = None if t.dtype in _NUMPY_NATIVE else "u8"
            meta_leaves.append({"path": path, "dtype": str(t.dtype),
                                "shape": list(t.shape), "packed": packed})
            arrays[f"leaf_{i}"] = (t.reshape(-1).view(torch.uint8) if packed else t).numpy()
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"step": step, "leaves": meta_leaves, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    # -- read ------------------------------------------------------------
    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, dict, int]:
        """Rebuild the tree with `like`'s structure.  Returns (tree of CPU
        tensors, extra, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like_leaves = flatten_tree(like)
        metas = manifest["leaves"]
        if len(metas) != len(like_leaves):
            raise ValueError(f"checkpoint has {len(metas)} leaves, "
                             f"expected {len(like_leaves)}")
        leaves = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, (meta, (like_path, ref)) in enumerate(zip(metas, like_leaves)):
                if meta["path"] != like_path or tuple(meta["shape"]) != tuple(ref.shape):
                    raise ValueError(f"checkpoint leaf {meta['path']} {meta['shape']} "
                                     f"does not fit {like_path} {tuple(ref.shape)}")
                t = torch.from_numpy(data[f"leaf_{i}"])
                if meta["packed"] == "u8":
                    t = t.view(_dtype(meta["dtype"]))
                leaves.append(t.reshape(meta["shape"]))
        return _unflatten(like, iter(leaves)), manifest["extra"], step

    # -- retention ---------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        # clean stale tmp dirs (crashed writes)
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
