"""Checkpoint manager with two-phase atomic commit (the port of
``repro/checkpoint/manager.py``), in the JAX package's on-disk format, so
either package resumes from the other's checkpoints.

Layout per step::

    <dir>/step_000000123.tmp/        (write phase)
        arrays.npz                   one entry leaf_{i} per flattened leaf
        MANIFEST.json                {"step", "leaves": [{"key", "path",
                                      "shape", "dtype", "crc32"}]}
    <dir>/step_000000123/            (rename = commit point)

The state is a pytree of dicts, tuples and lists with tensor (or numpy)
leaves, flattened in JAX's order: dict keys sorted, sequences in order,
``None`` holding no leaf.  ``path`` is written as ``jax.tree_util.keystr``
writes it (``[0]['blocks']['attn']['wq']``) and ``dtype`` is the logical
dtype; bfloat16 is stored as its ``uint16`` view.  ``latest_step()`` scans
committed directories only, so a crash mid-write is never resumed from (the
``.tmp`` directory is removed on the next save); a checkpoint whose crc32,
leaf count or leaf shapes do not match is skipped for the previous one.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def tree_flatten_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_flatten_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, t in enumerate(tree)
                for pair in tree_flatten_with_path(t, f"{path}[{i}]")]
    return [(path, tree)]


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(tree_unflatten(t, leaves) for t in like)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The array written for a leaf, and its logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.astype(np.dtype(dtype), copy=False))
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------ save ------------------------------

    def save(self, step: int, state: Any) -> str:
        tag = f"step_{step:09d}"
        tmp = os.path.join(self.dir, tag + ".tmp")
        final = os.path.join(self.dir, tag)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        arrays = {}
        manifest = {"step": step, "leaves": []}
        for i, (path, leaf) in enumerate(tree_flatten_with_path(state)):
            key = f"leaf_{i}"
            arr, logical_dtype = _to_numpy(leaf)
            arrays[key] = arr
            manifest["leaves"].append(
                {
                    "key": key,
                    "path": path,
                    "shape": list(arr.shape),
                    "dtype": logical_dtype,
                    "crc32": zlib.crc32(np.ascontiguousarray(arr)),
                }
            )
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # commit point
        self._gc()
        return final

    # ----------------------------- restore ----------------------------

    def _steps(self) -> List[int]:
        return sorted(
            {
                int(n.split("_")[1])
                for n in os.listdir(self.dir)
                if n.startswith("step_") and not n.endswith(".tmp")
                and n.split("_")[1].isdigit()
            }
        )

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None) -> tuple:
        """Restore into the structure of ``state_like``: ``(state, step)``,
        each tensor on the device of ``state_like``'s leaf (the CPU for a
        numpy leaf).

        Tries checkpoints newest-first; unusable ones (bad checksum, missing
        leaf, changed structure or shape) are skipped."""
        candidates = [step] if step is not None else self._steps()[::-1]
        for s in candidates:
            try:
                return self._restore_one(state_like, s), s
            except Exception as e:  # noqa: BLE001 - any unreadable checkpoint is skipped
                print(f"[ckpt] step {s} unusable ({e}); trying older")
        raise FileNotFoundError(f"no usable checkpoint in {self.dir}")

    def _restore_one(self, state_like, step):
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        flat = tree_flatten_with_path(state_like)
        if len(manifest["leaves"]) != len(flat):
            raise ValueError("tree structure changed")
        out = []
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for leaf_info, (path, like) in zip(manifest["leaves"], flat):
                arr = data[leaf_info["key"]]
                crc = zlib.crc32(np.ascontiguousarray(arr))
                if crc != leaf_info["crc32"]:
                    raise IOError(f"checksum mismatch on {leaf_info['path']}")
                if tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(f"{leaf_info['path']}: shape {tuple(arr.shape)} != "
                                     f"{tuple(like.shape)} of {path}")
                device = like.device if isinstance(like, torch.Tensor) else "cpu"
                out.append(_to_tensor(arr, leaf_info["dtype"], device))
        return tree_unflatten(state_like, iter(out))

    def _gc(self):
        steps = self._steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)
        for n in os.listdir(self.dir):
            if n.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, n), ignore_errors=True)
