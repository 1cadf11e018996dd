"""Carry forest state between the JAX package and the port.

This system has no weights: a forest's state is its element fields.  The
JAX package's `repro.core.forest.Forest` holds them as host numpy arrays
(uint64 keys, int32 for the rest); the port's `Forest` holds them as tensors
on a device (int64 keys).  `forest_from_reference` and
`forest_to_reference` convert a dict of those fields — d, num_trees, rank,
num_ranks, anchor, level, stype, tree, keys, and cmesh — in either
direction, so a forest built by one package can be carried into the other
and go on there.  A coarse mesh is a dict of numpy tables under the JAX
package's `Cmesh` field names (`CMESH_FIELDS`): `cmesh_to_reference` gives
it (build the JAX `Cmesh` with `Cmesh(**tables)`), and `cmesh_from_reference`
takes it, or the JAX `Cmesh` itself.
A ghost layer is a dict of element fields — anchor, level, stype, tree,
owner — host numpy in the JAX package, tensors here;
`ghost_from_reference` and `ghost_to_reference` carry it across.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.cmesh import CMESH_FIELDS, Cmesh
from .core.errors import not_ported
from .core.forest import Forest, resolve_device
from .core.keys import from_u64, to_u64
from .core.types import ECLASS_SIMPLEX, to_numpy

__all__ = ["FIELDS", "GHOST_FIELDS", "CMESH_FIELDS", "forest_from_reference",
           "forest_to_reference", "ghost_from_reference", "ghost_to_reference",
           "cmesh_from_reference", "cmesh_to_reference"]

FIELDS = ("d", "num_trees", "rank", "num_ranks", "anchor", "level", "stype", "tree", "keys",
          "cmesh")
GHOST_FIELDS = ("anchor", "level", "stype", "tree", "owner")


def forest_from_reference(arrays: dict, device=None) -> Forest:
    """A port `Forest` on `device` (the card by default) from the JAX
    forest's fields, its coarse mesh (`cmesh`, a table dict or the JAX
    `Cmesh`; absent or None for isolated trees) included.  Forests of
    another element class than simplices are not ported yet and raise
    NotImplementedError."""
    cm = arrays.get("cmesh")
    if arrays.get("eclass", ECLASS_SIMPLEX) != ECLASS_SIMPLEX:
        raise not_ported("a forest of hex trees", "hex")
    dev = resolve_device(device)
    n = len(arrays["level"])
    d = int(arrays["d"])

    def col(name, shape):
        a = np.asarray(arrays[name])
        if a.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {a.shape}")
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    return Forest(
        d, int(arrays["num_trees"]), int(arrays["rank"]), int(arrays["num_ranks"]),
        col("anchor", (n, d)), col("level", (n,)), col("stype", (n,)), col("tree", (n,)),
        from_u64(np.asarray(arrays["keys"], np.uint64).reshape(n), dev),
        None if cm is None else cmesh_from_reference(cm),
    )


def forest_to_reference(f: Forest) -> dict:
    """The port forest's fields as the JAX forest holds them: host numpy
    arrays, uint64 keys, int32 for the rest; `cmesh` as a table dict
    (`cmesh_to_reference`) or None."""
    return {
        "d": f.d, "num_trees": f.num_trees, "rank": f.rank, "num_ranks": f.num_ranks,
        "anchor": to_numpy(f.anchor).astype(np.int32),
        "level": to_numpy(f.level).astype(np.int32),
        "stype": to_numpy(f.stype).astype(np.int32),
        "tree": to_numpy(f.tree).astype(np.int32),
        "keys": to_u64(f.keys),
        "cmesh": None if f.cmesh is None else cmesh_to_reference(f.cmesh),
    }


def cmesh_from_reference(cm) -> Cmesh:
    """A port `Cmesh` from the JAX package's coarse mesh: a dict of its
    tables under `CMESH_FIELDS`, or the JAX `Cmesh` itself.  Every table is
    copied with the reference's dtype; the construction-time proofs do not
    run again (the tables are the reference's own)."""
    if not isinstance(cm, dict):
        cm = {k: getattr(cm, k) for k in CMESH_FIELDS}
    d, K = int(cm["d"]), int(cm["num_trees"])
    want = {"face_tree": ((K, d + 1), np.int32), "face_face": ((K, d + 1), np.int32),
            "face_M": ((K, d + 1, d, d), np.int32), "face_c": ((K, d + 1, d), np.int64),
            "face_typemap": ((K, d + 1, math.factorial(d)), np.int32),
            "face_facemap": ((K, d + 1, math.factorial(d), d + 1), np.int32),
            "tree_embed_M": ((K, d, d), np.int32), "tree_embed_o": ((K, d), np.int64),
            "tree_eclass": ((K,), np.int32)}
    tables = {}
    for name, (shape, dtype) in want.items():
        a = np.asarray(cm[name])
        if a.shape != shape:
            raise ValueError(f"cmesh {name}: expected shape {shape}, got {a.shape}")
        tables[name] = a.astype(dtype)
    return Cmesh(d=d, num_trees=K, **tables)


def cmesh_to_reference(cm: Cmesh) -> dict:
    """The port's coarse mesh as a dict of the JAX `Cmesh`'s fields (copies
    of the host numpy tables, the reference's dtypes)."""
    return {k: (getattr(cm, k) if k in ("d", "num_trees") else np.array(getattr(cm, k)))
            for k in CMESH_FIELDS}


def ghost_from_reference(ghost: dict, device=None) -> dict:
    """A ghost layer of the JAX package (`ghost` output: host int32 arrays)
    as the port's: int32 tensors on `device` (the card by default)."""
    dev = resolve_device(device)
    n = len(ghost["level"])
    anchor = np.asarray(ghost["anchor"])
    d = anchor.shape[1] if anchor.ndim == 2 else -1
    out = {}
    for name in GHOST_FIELDS:
        a = np.asarray(ghost[name])
        want = (n, d) if name == "anchor" else (n,)
        if a.shape != want:
            raise ValueError(f"{name}: expected shape {want}, got {a.shape}")
        out[name] = torch.from_numpy(a.astype(np.int32)).to(dev)
    return out


def ghost_to_reference(ghost: dict) -> dict:
    """The port's ghost layer as the JAX package holds it: host int32
    arrays."""
    return {name: to_numpy(ghost[name]).astype(np.int32) for name in GHOST_FIELDS}
