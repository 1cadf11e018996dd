"""Checkpoint store: atomic, gathered, async, in the JAX package's layout.

Counterpart of `repro.checkpoint.store`.  Layout:

    <dir>/step_<k>/
        manifest.json     tree structure, shapes, dtypes, meta
        arr_<i>.npy       one file per leaf

A checkpoint is written to `step_<k>.tmp` and renamed into place, so a
crash never leaves a half checkpoint visible.  Leaves are host arrays (a
tensor is copied off its device) taken in the order JAX's tree utilities
flatten a tree of dicts, lists, tuples and named tuples (dict keys sorted),
and the manifest's "treedef" is JAX's string of that structure, so a
checkpoint written here is byte for byte the JAX package's (manifest and
every `.npy`), and either package restores the other's.  A bfloat16 leaf is
stored as the JAX package stores it, as its raw uint16 bits with manifest
dtype "bfloat16" (numpy has no bfloat16; the port needs no `ml_dtypes`).

`restore_checkpoint` returns host numpy arrays, and for a bfloat16 leaf a
CPU `torch.bfloat16` tensor.  It also reassembles a manifest's per-shard
"files" entries.  `AsyncCheckpointer` copies a tree to the host
synchronously and writes it on a thread.

Sharded mode.  `save_checkpoint(..., sharded=True)` writes a DTensor split
over several ranks as the JAX package writes an array of several shards:
one file a shard, `arr_<i>.shard<replica>_<starts>.npy` (the replica id
counts the ranks holding the same block, the starts are the block's first
index in each dim), listed under "files" with each block's [start, stop)
per dim.  Every rank of the default process group calls it: each writes
its own blocks, and rank 0 writes the manifest and renames the directory
into place once all have written.  A tensor on one device, or a DTensor
not split, is written gathered.  `restore_checkpoint(..., shardings=...)`
places each leaf onto a mesh, which may differ from the one that saved:
`shardings` has `tree_like`'s structure, with a (DeviceMesh, placements)
pair at each leaf to place (None: a host array).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer"]

# dtypes numpy cannot round-trip through .npy, which the JAX package stores
# as raw integer views; the port reads and writes bfloat16 (torch has it)
_EXOTIC = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _flatten(tree) -> tuple[list, str]:
    """(leaves, structure) in JAX's tree-flattening order and string format:
    dict keys sorted, lists, tuples and named tuples in order, None a node
    without leaves, anything else a leaf `*`."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        inner = ", ".join(f"{k!r}: {p[1]}" for k, p in zip(keys, parts))
        return [x for p in parts for x in p[0]], "{" + inner + "}"
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        inner = ", ".join(p[1] for p in parts)
        if hasattr(tree, "_fields"):
            inner = f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
        elif isinstance(tree, list):
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
        vals = [_unflatten(v, leaves) for v in like]
        return type(like)(*vals) if hasattr(like, "_fields") else type(like)(vals)
    if like is None:
        return None
    return next(leaves)


def _to_disk(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of the leaf as written to disk, the manifest's dtype
    name): a bfloat16 tensor as its uint16 bits.  Always a copy, so a later
    change to the leaf does not reach an asynchronous write."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", copy=True)
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.array(leaf, copy=True)
    if arr.dtype.name in _EXOTIC:
        raise TypeError(f"a {arr.dtype.name} array: pass it as a tensor")
    return arr, arr.dtype.name


def _from_disk(arr: np.ndarray, dtype_name: str):
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if dtype_name in _EXOTIC:
        raise NotImplementedError(f"{dtype_name} leaves are not ported (no model of the port "
                                  "keeps fp8 state)")
    return arr


def _write(path, host: list, structure: str, *, step: int, sharded: bool,
           extra_meta: dict | None) -> Path:
    """Write the (array, dtype name) leaves `host` atomically to
    <path>/step_<step>."""
    path = Path(path)
    final = path / f"step_{step}"
    tmp = path / f"step_{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "treedef": f"PyTreeDef({structure})",
                "num_leaves": len(host), "sharded": sharded, "leaves": [],
                "meta": extra_meta or {}}
    for i, (arr, dt) in enumerate(host):
        fn = f"arr_{i}.npy"
        np.save(tmp / fn, arr)
        manifest["leaves"].append({"index": i, "dtype": dt, "shape": list(arr.shape),
                                   "file": fn})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _blocks(t: DTensor) -> tuple[list, int]:
    """([start, stop) per dim) of this rank's block of `t`, and its replica
    id: the rank's index, row-major, over the mesh dims that do not split
    `t` (0 when every dim splits it)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    bounds = [[0, n] for n in t.shape]
    replica, stride = 0, 1
    for i in reversed(range(mesh.ndim)):
        pl = t.placements[i]
        if not pl.is_shard():
            replica += coord[i] * stride
            stride *= mesh.size(i)
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            lo, hi = bounds[pl.dim]
            step = (hi - lo) // mesh.size(i)
            bounds[pl.dim] = [lo + coord[i] * step, lo + (coord[i] + 1) * step]
    return bounds, replica


def _split(leaf) -> bool:
    return isinstance(leaf, DTensor) and any(p.is_shard() for p in leaf.placements)


def _save_sharded(path, leaves: list, structure: str, *, step: int,
                  extra_meta: dict | None) -> Path:
    """Every rank writes its blocks of the split DTensors among `leaves`
    into <path>/step_<step>.tmp; rank 0 writes the rest and the manifest,
    then renames the directory into place."""
    path = Path(path)
    final, tmp = path / f"step_{step}", path / f"step_{step}.tmp"
    rank = dist.get_rank()
    if rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    dist.barrier()
    mine = []
    for i, leaf in enumerate(leaves):
        if not _split(leaf):
            continue
        bounds, replica = _blocks(leaf)
        fn = f"arr_{i}.shard{replica}_{'_'.join(str(lo) for lo, _ in bounds)}.npy"
        data, dt = _to_disk(leaf.to_local())
        np.save(tmp / fn, data)
        mine.append((i, {"file": fn, "index": bounds}, dt))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    full = [None if _split(x) else _to_disk(x) for x in leaves]   # collective for DTensors
    if rank == 0:
        manifest = {"step": step, "treedef": f"PyTreeDef({structure})",
                    "num_leaves": len(leaves), "sharded": True, "leaves": [],
                    "meta": extra_meta or {}}
        files: dict = {}
        for per_rank in every:
            for i, f, dt in per_rank:
                files.setdefault(i, ({}, dt))[0].setdefault(f["file"], f)
        for i, leaf in enumerate(leaves):
            entry = {"index": i, "dtype": None, "shape": list(leaf.shape)}   # JAX's key order
            if i in files:
                entry["dtype"] = files[i][1]
                entry["files"] = list(files[i][0].values())
            else:
                arr, entry["dtype"] = full[i]
                entry["file"] = f"arr_{i}.npy"
                np.save(tmp / entry["file"], arr)
            manifest["leaves"].append(entry)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    dist.barrier()
    return final


def save_checkpoint(path, tree, *, step: int, sharded: bool = False,
                    extra_meta: dict | None = None) -> Path:
    """Write `tree` atomically to <path>/step_<step>.  With `sharded` and a
    DTensor split over ranks in `tree`, every rank of the default process
    group must call it: each writes its own blocks (sharded mode, above).
    Otherwise every leaf is written gathered, as the JAX package does for
    an array with one shard."""
    leaves, structure = _flatten(tree)
    if sharded and any(_split(x) for x in leaves):
        return _save_sharded(path, leaves, structure, step=step, extra_meta=extra_meta)
    return _write(path, [_to_disk(x) for x in leaves], structure, step=step, sharded=sharded,
                  extra_meta=extra_meta)


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
    default): (the tree of host numpy arrays, bfloat16 leaves as CPU
    `torch.bfloat16` tensors, the manifest).  A leaf saved as per-shard
    "files" is reassembled from them.  With `shardings` (`tree_like`'s
    structure, a (DeviceMesh, placements) pair or None at each leaf), a
    leaf with a pair is placed on its mesh as a DTensor, each rank keeping
    its block: onto any mesh, the one that saved or another."""
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
        if "file" in entry:
            arr = np.load(d / entry["file"])
        else:
            arr = None
            for f in entry["files"]:
                part = np.load(d / f["file"])
                if arr is None:
                    arr = np.zeros(entry["shape"], part.dtype)
                arr[tuple(slice(a, b) for a, b in f["index"])] = part
        out.append(_from_disk(arr, entry["dtype"]))
    if shardings is not None:
        out = [x if sh is None else _place(x, *sh)
               for x, sh in zip(out, _along(tree_like, shardings))]
    return _unflatten(tree_like, iter(out)), manifest


def _along(like, shardings) -> list:
    """The entries of `shardings` at the leaves of `like`, in `_flatten`'s
    order (a (mesh, placements) pair or None is one entry)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _along(like[k], shardings[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, shardings) for x in _along(a, b)]
    return [] if like is None else [shardings]


def _place(arr, mesh, placements) -> DTensor:
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    return distribute_tensor(t.to(mesh.device_type), mesh, placements, src_data_rank=None)


class AsyncCheckpointer:
    """Snapshot to host synchronously, write on a background thread.  `save`
    waits for the previous write first; `wait` joins the writer and raises
    the error a write met (again on every later `wait`, as the JAX package
    does)."""

    def __init__(self, path):
        self.path = Path(path)
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error:
            raise self.last_error

    def save(self, tree, *, step: int, sharded: bool = False,
             extra_meta: dict | None = None) -> None:
        self.wait()
        leaves, structure = _flatten(tree)
        host = [_to_disk(x) for x in leaves]       # the snapshot: host copies

        def write():
            try:
                _write(self.path, host, structure, step=step, sharded=sharded,
                       extra_meta=extra_meta)
            except Exception as e:      # handed to the trainer by `wait`
                self.last_error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
