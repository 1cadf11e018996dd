"""Checkpoint store: atomic, gathered, in the JAX package's layout.

Counterpart of `repro.checkpoint.store`.  Layout:

    <dir>/step_<k>/
        manifest.json     tree structure, shapes, dtypes, meta
        arr_<i>.npy       one file per leaf

A checkpoint is written to `step_<k>.tmp` and renamed into place, so a
crash never leaves a half checkpoint visible.  Leaves are host arrays (a
tensor is copied off its device) taken in the order JAX's tree utilities
flatten a tree of dicts, lists and tuples (dict keys sorted), and the
manifest's "treedef" is JAX's string of that structure, so a checkpoint
written here is byte for byte the JAX package's (manifest and every
`.npy`), and either package restores the other's.  `restore_checkpoint`
returns host numpy arrays.

Gathered mode only.  Sharded files, restoring onto shardings, the async
writer and the JAX package's bf16/f8 leaves belong to the training path
and raise NotImplementedError until it is ported.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

from ..core.types import to_numpy

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer"]

_SLICE = "ROADMAP.md §1, slice 7b (the training path)"
# dtypes numpy cannot round-trip through .npy, which the JAX package stores
# as raw integer views
_EXOTIC = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _flatten(tree) -> tuple[list, str]:
    """(leaves, structure) in JAX's tree-flattening order and string format:
    dict keys sorted, lists and tuples in order, None a node without
    leaves, anything else a leaf `*`."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        inner = ", ".join(f"{k!r}: {p[1]}" for k, p in zip(keys, parts))
        return [x for p in parts for x in p[0]], "{" + inner + "}"
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        inner = ", ".join(p[1] for p in parts)
        if isinstance(tree, list):
            inner = "[" + inner + "]"
        else:
            inner = "(" + inner + ("," if len(parts) == 1 else "") + ")"
        return [x for p in parts for x in p[0]], inner
    if tree is None:
        return [], "None"
    return [tree], "*"


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from the iterator
    `leaves`."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def save_checkpoint(path, tree, *, step: int, sharded: bool = False,
                    extra_meta: dict | None = None) -> Path:
    """Write `tree` atomically to <path>/step_<step> (gathered mode)."""
    if sharded:
        raise NotImplementedError(f"sharded checkpoints are not ported yet ({_SLICE})")
    path = Path(path)
    final = path / f"step_{step}"
    tmp = path / f"step_{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, structure = _flatten(tree)
    manifest = {"step": step, "treedef": f"PyTreeDef({structure})",
                "num_leaves": len(leaves), "sharded": sharded, "leaves": [],
                "meta": extra_meta or {}}
    for i, leaf in enumerate(leaves):
        arr = to_numpy(leaf)
        fn = f"arr_{i}.npy"
        np.save(tmp / fn, arr)
        manifest["leaves"].append({"index": i, "dtype": arr.dtype.name,
                                   "shape": list(arr.shape), "file": fn})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(path) -> int | None:
    """The highest complete step under `path`, or None."""
    path = Path(path)
    if not path.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in path.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(path, tree_like, *, step: int | None = None, shardings=None):
    """Restore into the structure of `tree_like` (the latest step by
    default): (the tree of host numpy arrays, the manifest)."""
    if shardings is not None:
        raise NotImplementedError(f"restoring onto shardings is not ported yet ({_SLICE})")
    path = Path(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = path / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves_like, _ = _flatten(tree_like)
    if len(leaves_like) != manifest["num_leaves"]:
        raise AssertionError("tree structure changed")
    out = []
    for entry in manifest["leaves"]:
        if "file" not in entry:
            raise NotImplementedError(f"sharded checkpoints are not ported yet ({_SLICE})")
        if entry["dtype"] in _EXOTIC:
            raise NotImplementedError(f"{entry['dtype']} leaves are not ported yet ({_SLICE})")
        out.append(np.load(d / entry["file"]))
    return _unflatten(tree_like, iter(out)), manifest


class AsyncCheckpointer:
    """The JAX package's background-thread writer: part of the training
    path, not ported yet."""

    def __init__(self, path):
        raise NotImplementedError(f"AsyncCheckpointer is not ported yet ({_SLICE})")
