"""Fault-tolerant checkpointing: atomic, versioned, resumable.

The JAX package's ``runtime/checkpoint.py`` in PyTorch, on the same
on-disk format, so a checkpoint written by either package is restored by
the other: the state's leaves as ``leaf_{i:05d}`` arrays of one npz, in
``jax.tree.flatten``'s order (dict keys sorted), bf16 stored as a uint16
view, beside a ``meta`` JSON with the step, the tree's structure and the
stored dtypes; written ``tmp -> fsync -> rename`` through the port's
``ArtifactStore``, whose version pointer names the newest complete
checkpoint.  ``restore`` puts every leaf on the device and dtype of the
template's leaf.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.cluster.store import ArtifactStore
from repro_torch.models.common import sorted_leaves, sorted_unflatten


def _to_np(t: torch.Tensor) -> np.ndarray:
    """npz-safe array: bf16 stored as a uint16 view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_np(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)  # stored as a raw view
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def _treedef(tree: Any) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` prints it."""
    def walk(t: Any) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        return "*"

    return f"PyTreeDef({walk(tree)})"


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.store = ArtifactStore(directory)
        self.keep = keep

    def save(self, step: int, state: Any) -> None:
        arrays = {f"leaf_{i:05d}": _to_np(x) for i, x in enumerate(sorted_leaves(state))}
        self.store.put_arrays(step, "state", arrays)
        self.store.put_json(step, "meta", {
            "step": step,
            "treedef": _treedef(state),
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        })
        self.store.publish(step)
        self._gc()

    def latest_step(self) -> int:
        return self.store.current_version()

    def restore(self, like: Any, step: int | None = None) -> tuple[int, Any]:
        """Restore into the structure of ``like`` (shape/dtype/device template)."""
        step = self.latest_step() if step is None else step
        if step < 0:
            raise FileNotFoundError("no checkpoint found")
        arrays = self.store.get_arrays(step, "state")
        leaves = sorted_leaves(like)
        if len(arrays) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(arrays)} leaves, template has {len(leaves)}")
        restored = [_from_np(arrays[f"leaf_{i:05d}"], l) for i, l in enumerate(leaves)]
        return step, sorted_unflatten(like, restored)

    def _gc(self) -> None:
        vdirs = sorted(
            (d for d in self.store.root.iterdir() if re.match(r"v\d{6}", d.name)),
            key=lambda d: d.name,
        )
        for d in vdirs[: -self.keep]:
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
