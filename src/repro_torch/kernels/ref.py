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
from ..core.tables import MAXLEVEL
from ..core.types import Simplex

__all__ = ["morton_key", "decode", "parent", "children", "face_sweep", "eval_route",
           "inside_root", "tree_transform", "owner_rank", "successor", "face_neighbor",
           "call_counts", "reset_call_counts"]

call_counts: dict[str, int] = {"morton_key": 0, "decode": 0, "parent": 0, "children": 0,
                               "face_sweep": 0, "eval_route": 0, "inside_root": 0,
                               "tree_transform": 0, "owner_rank": 0, "successor": 0,
                               "face_neighbor": 0}


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
    return (kend, _owner_count(tgt, key, marker_tree, marker_key),
            _owner_count(tgt, kend, marker_tree, marker_key))


def _owner_count(tree: torch.Tensor, key: torch.Tensor, marker_tree: torch.Tensor,
                 marker_key: torch.Tensor) -> torch.Tensor:
    """The marker compare-and-count of the JAX package's `owner_rank_lex`
    (`repro.core.batch`), shared by `owner_rank` and `eval_route` as the
    Pallas kernels share `_owner_count_expr`: the number of the P markers
    lex-<= each (tree, key), less one, clamped to 0.  int32, the shape of
    `tree`.  The (query, marker) comparison matrix is built a slice of
    queries at a time, so memory stays bounded at any P."""
    t, k = tree.reshape(-1, 1), key.reshape(-1, 1)
    step = max(1, _PAIRS_PER_SLICE // max(marker_tree.shape[0], 1))
    out = torch.empty(t.shape[0], dtype=torch.int32, device=tree.device)
    for a in range(0, t.shape[0], step):
        ts, ks = t[a:a + step], k[a:a + step]
        le = (marker_tree < ts) | ((marker_tree == ts) & (marker_key <= ks))
        out[a:a + step] = le.sum(dim=1, dtype=torch.int32)
    return (out - 1).clamp(min=0).reshape(tree.shape)


_PAIRS_PER_SLICE = 1 << 27   # query-marker comparisons held at once


def owner_rank(tree: torch.Tensor, key: torch.Tensor, marker_tree: torch.Tensor,
               marker_key: torch.Tensor) -> torch.Tensor:
    """The rank whose partition range [marker_r, marker_{r+1}) holds each
    lex (tree, key): the number of the P lex-sorted markers lex-<= it, less
    one, clamped to 0 (keys before the first marker go to rank 0).  (n,)
    int32."""
    call_counts["owner_rank"] += 1
    return _owner_count(tree, key, marker_tree, marker_key)


def successor(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """Algorithm 4.10 at each element's own level, wrapping within the
    level (`ElementOps.successor`): (anchor (n, d), type)."""
    call_counts["successor"] += 1
    s = get_ops(anchor.shape[-1]).successor(Simplex(anchor, level, stype))
    return s.anchor, s.stype


def face_neighbor(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
                  face: torch.Tensor):
    """Algorithm 4.6 across one face per element, face[i] of element i:
    the same-level neighbor's (anchor (n, d), type) and the dual face, all
    int32.  The neighbor may lie outside the root."""
    call_counts["face_neighbor"] += 1
    nb, dual = get_ops(anchor.shape[-1]).face_neighbor(Simplex(anchor, level, stype), face)
    return nb.anchor, nb.stype, dual


def inside_root(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor) -> torch.Tensor:
    """Section 4.4: (n,) bool, does each element lie inside the root simplex."""
    call_counts["inside_root"] += 1
    return get_ops(anchor.shape[-1]).is_inside_root(Simplex(anchor, level, stype))


def tree_transform(conn: torch.Tensor, anchor: torch.Tensor, level: torch.Tensor,
                   stype: torch.Tensor, dual: torch.Tensor, table: torch.Tensor):
    """Each element (n,) across its own connection: row conn[i] of the
    packed connection table (`core.cmesh.pack_connection`) gives the
    gluing's (M, c, typemap), applied by `SimplexOps.tree_transform`, the
    face map that renumbers the dual face, and the neighbor tree.  Returns
    (anchor (n, d), type, dual face, tree), int32."""
    call_counts["tree_transform"] += 1
    n, d = anchor.shape
    o = get_ops(d)
    nt, nf = o.nt, o.nf
    row = table[conn.long()].long()
    code = row[:, :d]
    sign = 1 - 2 * ((code >> 2) & 1)
    M = torch.zeros((n, d, d), dtype=torch.int64, device=anchor.device)
    M.scatter_(2, (code & 3)[:, :, None], sign[:, :, None])
    s2 = o.tree_transform(Simplex(anchor, level, stype), M, row[:, d:2 * d],
                          row[:, 2 * d:2 * d + nt])
    facemap = row[:, 2 * d + nt:2 * d + nt + nt * nf].reshape(n, nt, nf)
    b = stype.long()
    dual2 = facemap[torch.arange(n, device=anchor.device), b, dual.long()]
    return s2.anchor, s2.stype, dual2.to(torch.int32), row[:, -1].to(torch.int32)
