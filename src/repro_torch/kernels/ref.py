"""Plain PyTorch versions of the CUDA kernels, delegating to `core.ops`.

Same signatures and outputs as the wrappers in `kernels.ops`; they run on the
tensors' own device.  The wrappers call them for CPU tensors, the tests hold
them against the JAX package, and `chip_smoke.py` holds the kernels against
them on the card.  `call_counts` counts calls per function.
"""

from __future__ import annotations

import torch

from ..core.keys import span_mask
from ..core.ops import get_ops
from ..core.placement import owner_rank
from ..core.tables import MAXLEVEL
from ..core.types import Simplex

__all__ = ["morton_key", "decode", "parent", "children", "face_sweep", "eval_route",
           "inside_root", "call_counts", "reset_call_counts"]

call_counts: dict[str, int] = {"morton_key": 0, "decode": 0, "parent": 0, "children": 0,
                               "face_sweep": 0, "eval_route": 0, "inside_root": 0}


def reset_call_counts() -> None:
    for k in call_counts:
        call_counts[k] = 0


def morton_key(anchor: torch.Tensor, stype: torch.Tensor) -> torch.Tensor:
    """(n, d) anchor, (n,) type -> (n,) int64 level-padded keys.  The level
    plays no role in the padded key (the T_0-chain digits below an element's
    level are zero), so the key is evaluated at MAXLEVEL."""
    call_counts["morton_key"] += 1
    o = get_ops(anchor.shape[-1])
    level = torch.full_like(stype, o.L)
    return o.morton_key(Simplex(anchor, level, stype))


def decode(d: int, key: torch.Tensor, level: torch.Tensor):
    """(n,) int64 keys and int32 levels -> (anchor (n, d), type (n,))."""
    call_counts["decode"] += 1
    s = get_ops(d).decode_key(key, level)
    return s.anchor, s.stype


def parent(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """-> (parent anchor, parent level, parent type, local index)."""
    call_counts["parent"] += 1
    o = get_ops(anchor.shape[-1])
    s = Simplex(anchor, level, stype)
    p = o.parent(s)
    return p.anchor, p.level, p.stype, o.local_index(s)


def children(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """-> all 2^d children in SFC order: anchor (n, 2^d, d), level and type
    (n, 2^d)."""
    call_counts["children"] += 1
    kids = get_ops(anchor.shape[-1]).children_tm(Simplex(anchor, level, stype))
    return kids.anchor, kids.level, kids.stype


def face_sweep(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """For every face f of every element, composed per face from
    `SimplexOps` as the JAX package's `face_sweep_ref` is: the same-level
    neighbor (Algorithm 4.6), whether it lies inside the root, and its key.
    Face-major outputs: neighbor anchor (nf, n, d) int32, type and dual face
    (nf, n) int32, inside (nf, n) bool, key (nf, n) int64.  Keys and types
    of neighbors outside the root are computed all the same."""
    call_counts["face_sweep"] += 1
    o = get_ops(anchor.shape[-1])
    s = Simplex(anchor, level, stype)
    cols = [[] for _ in range(5)]
    for f in range(o.nf):
        nb, dual = o.face_neighbor(s, f)
        for col, x in zip(cols, (nb.anchor, nb.stype, dual, o.is_inside_root(nb),
                                 o.morton_key(nb))):
            col.append(x)
    return tuple(torch.stack(col) for col in cols)


def eval_route(d: int, tgt: torch.Tensor, key: torch.Tensor, level: torch.Tensor,
               marker_tree: torch.Tensor, marker_key: torch.Tensor):
    """Over the (face, element) pairs of a face-major (nf, n) sweep: the end
    key of each neighbor's interval, key | (2^(d(L - level)) - 1) (keys are
    span aligned; the exponent is clamped to [0, 63]), and the first and
    last owner rank of the interval against the P partition markers.
    Returns (end key int64, first int32, last int32), each (nf, n)."""
    call_counts["eval_route"] += 1
    kend = key | span_mask(d, MAXLEVEL[d], level)[None, :]
    return (kend, owner_rank(tgt, key, marker_tree, marker_key),
            owner_rank(tgt, kend, marker_tree, marker_key))


def inside_root(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor) -> torch.Tensor:
    """Section 4.4: (n,) bool, does each element lie inside the root simplex."""
    call_counts["inside_root"] += 1
    return get_ops(anchor.shape[-1]).is_inside_root(Simplex(anchor, level, stype))
