"""Forest-of-trees AMR on the tetrahedral SFC (paper Section 5): New, Adapt,
Partition, Balance, Ghost and validate, on PyTorch tensors.

The counterpart of the JAX package's `repro.core.forest`: New (Alg. 5.1) ->
Adapt (refine / coarsen by callback, optionally recursive) -> Partition
(weighted SFC repartition with element migration) -> Balance (2:1 across
faces, the message-based ripple) -> Ghost (the face-ghost layer) ->
validate (the forest invariants).  A forest is a coarse mesh of K roots
("trees"), each adaptively refined, with leaves totally ordered by (tree,
SFC index) and split across P ranks by contiguous SFC ranges.  A tree is a
simplex (the paper's tetrahedral Morton curve) or a hex (quads and
hexahedra on the plain Morton curve), as its coarse mesh says
(`Cmesh.tree_eclass`; without one every tree is a simplex).

SPMD style as in the reference: every function computes the view of the
ranks resident in this process (`comm.local_ranks` — all P under `SimComm`)
and cross-rank data moves through `core.comm`.  A forest's element fields
live as tensors on its device (keys int64, everything else int32), and the
element math goes through `core.batch` — CUDA kernels on the card, their
plain versions on the CPU.  What travels between ranks (weight totals,
packed wire triples and quads, marker tables) and the float64 partition
prefix sums stay host numpy, so the byte counts and the rank boundaries
equal the reference's.  Balance and Ghost keep the reference's protocol
and collectives; their per-element and per-query host loops are tensor code
on the forest's device (lex binary searches, range maxima, batched plane
tests), with only compacted rows crossing to the host.

A forest over a coarse mesh (`Forest.cmesh`, `core.cmesh`) follows face
neighbors across glued tree faces: `face_sweep_layer` carries every
crossing of a layer into the neighbor tree's frame with one
`tree_transform` launch, and Balance, Ghost and validate read the fixed-up
layer as they read a cmesh-free one.

Element classes are unions of whole trees, and a face between two classes
is a domain boundary, so over a mesh of two classes the collective functions
run the one-class pipeline once per class, in ascending class order on
every rank, on the rank's leaves of that class (`_class_subforests`), and
merge the results back into stored (tree, key) order: Adapt per class
group, Partition with each wire entry tagged with its tree's class and
decoded by it, Balance and Ghost per class (one fused face sweep per class
per eval layer), validate's inside-root and key checks per class.  A mesh
of one class takes the one-class path directly.

Iterate (`iterate`) runs callbacks over a rank's elements and its local
face pairs, found in batch from one face sweep per class group and one lex
search.  The global-table oracles (`balance_oracle`, `ghost_oracle`) are the
JAX package's test oracles and wire-volume baseline: every rank allgathers
the full leaf table, and the message-based Balance and Ghost must equal
their results.

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
a card they raise.  Everything else follows the forests' device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .batch import BatchedOps, SweepHandle, count_dispatch, get_batch_ops, lex_search
from .cmesh import Cmesh
from .comm import Comm, CommHandle, LocalComm, SimComm
from .keys import span_exponent, span_mask
from .ops import ElementOps, get_ops
from .placement import target_ranks_np
from .types import (ECLASS_SIMPLEX, Simplex, concat, pack_wire, resolve_device, take,
                    to_numpy, unpack_wire)

__all__ = [
    "Forest",
    "Comm",
    "CommHandle",
    "SimComm",
    "LocalComm",
    "resolve_device",
    "new_uniform",
    "new_uniform_rank",
    "adapt",
    "partition",
    "repartition",
    "load_imbalance",
    "partition_markers",
    "count_global",
    "balance",
    "balance_oracle",
    "BalanceNonConvergence",
    "ghost",
    "ghost_oracle",
    "iterate",
    "validate",
    "face_kind",
    "face_kinds",
    "face_sweep_layer",
    "FaceSweepLayer",
    "FACE_INTERIOR",
    "FACE_INTER_TREE",
    "FACE_DOMAIN_BOUNDARY",
]

# ------------------------------------------------------------------- forest
@dataclasses.dataclass(eq=False)
class Forest:
    """One rank's portion of a partitioned forest.

    Elements are stored SoA (anchor/level/type + owning tree + key) in
    ascending (tree, TM-index) order — the paper's linear storage along the
    SFC — as tensors on one device.
    """

    d: int
    num_trees: int
    rank: int
    num_ranks: int
    anchor: torch.Tensor      # (n, d) int32
    level: torch.Tensor       # (n,)  int32
    stype: torch.Tensor       # (n,)  int32
    tree: torch.Tensor        # (n,)  int32
    keys: torch.Tensor        # (n,)  int64 morton keys (level-padded ids)
    # coarse-mesh connectivity; None = isolated trees (every tree face is a
    # domain boundary)
    cmesh: Cmesh | None = None

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    @property
    def eclasses(self) -> tuple:
        """Element classes of the coarse mesh (simplices without one)."""
        return (ECLASS_SIMPLEX,) if self.cmesh is None else self.cmesh.eclasses

    @property
    def eclass(self) -> int:
        """The one element class of this forest's leaves: the mesh's, or
        over a mesh of two classes that of the trees present here.  A rank
        holding leaves of both classes has none and raises: group by class
        first (`_class_groups`)."""
        ecs = self.eclasses
        if len(ecs) == 1:
            return ecs[0]
        present = torch.unique(self.cmesh.eclass_table(self.device)[self.tree.long()]).tolist()
        if len(present) > 1:
            raise ValueError("the forest holds leaves of two element classes; "
                             "group them by class first")
        return int(present[0]) if present else ECLASS_SIMPLEX

    @property
    def ops(self) -> ElementOps:
        return get_ops(self.d, self.eclass)

    @property
    def bops(self) -> BatchedOps:
        return get_batch_ops(self.d, self.eclass)

    @property
    def num_local(self) -> int:
        return self.level.shape[0]

    def simplices(self) -> Simplex:
        return Simplex(self.anchor, self.level, self.stype)

    def replace_elements(self, anchor, level, stype, tree) -> "Forest":
        """A new forest of the same ranks holding these elements (in stored
        order), with their keys computed in one batched encode per element
        class present."""
        dev = self.device
        anchor = anchor.to(dev, torch.int32).contiguous()
        level = level.to(dev, torch.int32).contiguous()
        stype = stype.to(dev, torch.int32).contiguous()
        tree = tree.to(dev, torch.int32).contiguous()
        s = Simplex(anchor, level, stype)
        keys = torch.empty(level.shape, dtype=torch.int64, device=dev)
        for ec, sel in _class_groups(self, tree):
            keys[sel] = get_batch_ops(self.d, ec).morton_key(take(s, sel))
        return dataclasses.replace(
            self, anchor=anchor, level=level, stype=stype, tree=tree, keys=keys)

    def global_first_desc_key(self) -> tuple[int, int]:
        """(tree, key) of this rank's first element; used as partition marker."""
        if self.num_local == 0:
            return (self.num_trees, 0)
        return (int(self.tree[0]), int(self.keys[0]))


def _empty(d, num_trees, rank, num_ranks, device, cmesh=None) -> Forest:
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Forest(d, num_trees, rank, num_ranks, z(0, d), z(0), z(0), z(0),
                  z(0, dtype=torch.int64), cmesh)


# ---------------------------------------------------------- element classes
# The element class is a property of a tree (`Cmesh.tree_eclass`); a face
# between two classes is a domain boundary, so a forest over a mesh of two
# classes is two independent forests.  The collective functions run the
# one-class pipeline once per class, in ascending class order (so every rank
# agrees), and merge the per-rank results back into stored (tree, key)
# order.  A mesh of one class takes the one-class path directly.


def _forest_classes(forests) -> tuple:
    f = forests[0] if isinstance(forests, (list, tuple)) else forests
    return f.eclasses


def _class_groups(f: Forest, tree: torch.Tensor | None = None) -> list:
    """[(class, selection)] for the element classes present among elements
    of trees `tree` (the rank's own leaves by default), ascending: over a
    mesh of one class one group selecting all of them (`slice(None)`),
    else a boolean mask a class present."""
    ecs = _forest_classes(f)
    if len(ecs) == 1:
        return [(ecs[0], slice(None))]
    te = f.cmesh.eclass_table(f.device)[(f.tree if tree is None else tree).long()]
    return [(ec, m) for ec in ecs if bool((m := te == ec).any())]


def _subforest(f: Forest, sel) -> Forest:
    """The forest restricted to the local elements `sel` (a mask or
    indices; the same mesh, ranks and tree ids; memoized sweeps and tables
    do not carry over)."""
    return dataclasses.replace(f, anchor=f.anchor[sel], level=f.level[sel],
                               stype=f.stype[sel], tree=f.tree[sel], keys=f.keys[sel])


def _class_subforests(forests: list[Forest], ec: int) -> list[Forest]:
    """Each rank's leaves of class `ec` (a mesh of two classes)."""
    return [_subforest(f, f.cmesh.eclass_table(f.device)[f.tree.long()] == ec)
            for f in forests]


def _merge_class_groups(base: Forest, parts: list[Forest]) -> Forest:
    """Per-class forests of one rank joined back into stored (tree, key)
    order; their keys are already right, so nothing is encoded."""
    tree = torch.cat([p.tree for p in parts])
    keys = torch.cat([p.keys for p in parts])
    by_key = torch.argsort(keys, stable=True)
    order = by_key[torch.argsort(tree[by_key], stable=True)]
    return dataclasses.replace(
        base, anchor=torch.cat([p.anchor for p in parts])[order],
        level=torch.cat([p.level for p in parts])[order],
        stype=torch.cat([p.stype for p in parts])[order], tree=tree[order], keys=keys[order])


def _forests_per_class(forests: list[Forest], run) -> list[Forest]:
    """`run(forests, eclass)` of the one-class pipeline, once per class
    group in ascending class order over a mesh of two classes (on each
    rank's leaves of that class), each rank's results merged back into
    stored (tree, key) order."""
    classes = _forest_classes(forests)
    if len(classes) == 1:
        return run(forests, classes[0])
    parts: list[list] = [[] for _ in forests]
    for ec in classes:
        for i, r in enumerate(run(_class_subforests(forests, ec), ec)):
            parts[i].append(r)
    return [_merge_class_groups(f, ps) for f, ps in zip(forests, parts)]


def _candidates_per_class(forests: list[Forest], run) -> list:
    """`run(forests, eclass)`'s per-rank sorted (tree, key, level, owner)
    candidate rows, once per class group over a mesh of two classes, each
    rank's joined and sorted."""
    classes = _forest_classes(forests)
    if len(classes) == 1:
        return run(forests, classes[0])
    per_class = [run(_class_subforests(forests, ec), ec) for ec in classes]
    return [_unique_rows(*(np.concatenate([c[i][:, j] for c in per_class]) for j in range(4)))
            for i in range(len(forests))]


def _layer_eclass(f: Forest, tree_ids: torch.Tensor) -> int:
    """The element class of a layer of elements, from their trees (one
    class: the per-class functions see to it)."""
    ecs = _forest_classes(f)
    if len(ecs) == 1:
        return ecs[0]
    present = torch.unique(f.cmesh.eclass_table(tree_ids.device)[tree_ids.long()]).tolist()
    if len(present) > 1:
        raise ValueError("face_sweep_layer needs a layer of one element class")
    return int(present[0]) if present else ECLASS_SIMPLEX


# ---------------------------------------------------------------------- new
def new_uniform(d: int, num_trees: int, level: int, comm: Comm,
                method: str = "decode", cmesh=None, device=None) -> list[Forest]:
    """Paper Algorithm 5.1 (New): partitioned uniform level-`level` forest.

    Returns one `Forest` per rank resident in this process (all P under
    `SimComm`), on `device` (the card by default).  With `cmesh`, the trees
    are glued per its face tables and Balance and Ghost follow neighbors
    across tree faces."""
    dev = resolve_device(device)
    return [new_uniform_rank(d, num_trees, level, p, comm.size, method=method,
                             cmesh=cmesh, device=dev)
            for p in comm.local_ranks]


def new_uniform_rank(d: int, num_trees: int, level: int, rank: int, num_ranks: int,
                     method: str = "decode", cmesh=None, device=None) -> Forest:
    """One rank's portion of a uniform refinement — communication free: the
    rank's index range of each tree goes through one batched Algorithm-4.8
    decode of the tree's element class (`method="decode"`), or is built
    from the coarsest subtrees inside it by child expansion
    (`method="successor"`, `_range_by_expansion`, kept for parity with the
    JAX package's option: on the card it is the slower of the two, see
    PERF.md).  Both give the same elements.  Both classes have 2^d
    children, so the split into ranks does not depend on the class."""
    if cmesh is not None and (cmesh.d != d or cmesh.num_trees != num_trees):
        raise ValueError(f"cmesh ({cmesh.d}D, {cmesh.num_trees} trees) does not match "
                         f"forest ({d}D, {num_trees} trees)")
    if method not in ("decode", "successor"):
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    o = get_ops(d)
    if not 0 <= level <= o.L:
        raise ValueError(f"level must lie in [0, {o.L}], got {level}")
    n_per_tree = o.num_elements(level)
    N = n_per_tree * num_trees
    g_first = (N * rank) // num_ranks
    g_last = (N * (rank + 1)) // num_ranks  # exclusive
    f = _empty(d, num_trees, rank, num_ranks, dev, cmesh)
    if g_last <= g_first:
        return f
    parts = []
    for t in range(g_first // n_per_tree, (g_last - 1) // n_per_tree + 1):
        bops = get_batch_ops(d, ECLASS_SIMPLEX if cmesh is None else cmesh.eclass_of(t))
        e_first = max(g_first - t * n_per_tree, 0)
        e_last = min(g_last - t * n_per_tree, n_per_tree)
        if method == "decode":
            s = _decode_range(bops, e_first, e_last, level, dev)
        else:
            s = _range_by_expansion(bops, e_first, e_last, level, dev)
        parts.append((s.anchor, s.level, s.stype, torch.full_like(s.level, t)))
    return f.replace_elements(*(torch.cat(col) for col in zip(*parts)))


def _decode_range(bops: BatchedOps, e_first: int, e_last: int, level: int,
                  device) -> Simplex:
    """Elements e_first..e_last-1 of a tree's uniform level `level`, by one
    batched Algorithm-4.8 decode."""
    ids = torch.arange(e_first, e_last, dtype=torch.int64, device=device)
    return bops.decode(ids << (bops.d * (bops.ops.L - level)),
                       torch.full_like(ids, level, dtype=torch.int32))


def _range_by_expansion(bops: BatchedOps, e_first: int, e_last: int, level: int,
                        device) -> Simplex:
    """The SFC range [e_first, e_last) of a tree's uniform level `level`
    with O(n) work, the vectorized counterpart of the paper's
    successor-based New: the subtrees of the coarsest level whose spans
    tile part of the range are decoded and expanded to `level` child by
    child; the ragged head and tail are decoded at `level`."""
    nc = bops.ops.nc
    for lv in range(level + 1):     # at lv = level, span 1, the whole range
        span = nc ** (level - lv)
        lo, hi = -(-e_first // span) * span, e_last // span * span
        if lo < hi:
            break
    mid = _decode_range(bops, lo // span, hi // span, lv, device)
    for _ in range(lv, level):
        kids = bops.children(mid)
        mid = Simplex(kids.anchor.reshape(-1, bops.d), kids.level.reshape(-1),
                      kids.stype.reshape(-1))
    return concat([_decode_range(bops, e_first, lo, level, device), mid,
                   _decode_range(bops, hi, e_last, level, device)])


# -------------------------------------------------------------------- adapt
AdaptCallback = Callable[[torch.Tensor, Simplex], torch.Tensor]
# callback(tree_ids, elements) -> int flags: >0 refine, 0 keep, <0 coarsen.


def _family_heads(f: Forest) -> torch.Tensor:
    """Boolean mask: element i starts a complete family of 2^d siblings.

    One batched parent/local-index sweep and one parent-key encode over all
    local elements (level-0 elements included: their parent is themselves
    at level -1, and the level test below drops them)."""
    b, n, nc = f.bops, f.num_local, f.ops.nc
    heads = torch.zeros(n, dtype=torch.bool, device=f.device)
    if n < nc:
        return heads
    parent, iloc = b.parent_and_local_index(f.simplices())
    pkey = b.morton_key(parent)
    m = n - nc + 1
    cand = torch.nonzero((iloc[:m] == 0) & (f.level[:m] > 0)).flatten()
    ok = torch.ones(cand.shape[0], dtype=torch.bool, device=f.device)
    for k in range(1, nc):
        ok &= ((iloc[cand + k] == k)
               & (pkey[cand + k] == pkey[cand])
               & (f.level[cand + k] == f.level[cand])
               & (f.tree[cand + k] == f.tree[cand]))
    heads[cand[ok]] = True
    return heads


def adapt(f: Forest, callback: AdaptCallback, recursive: bool = False,
          max_passes: int = 64) -> Forest:
    """Paper Section 5.2 (Adapt): refine/coarsen local elements by callback.

    `callback(tree_ids, elements)` gets the forest's tensors and returns one
    int flag per element (>0 refine, 0 keep, <0 coarsen; a family coarsens
    only if all 2^d siblings ask to).  Elements created by refinement are
    not coarsened within the same call, and vice versa.  Like the paper's
    Adapt this is process-local: families straddling a partition boundary
    are not coarsened.  With `recursive`, passes repeat on the new elements
    until nothing changes (at most `max_passes`).  Over a mesh of two
    classes each class group is adapted on its own (the callback sees each
    group's trees and elements in turn); a family never spans two classes,
    which are unions of whole trees."""
    groups = _class_groups(f)
    if len(groups) > 1:
        return _merge_class_groups(f, [_adapt_impl(_subforest(f, m), callback, recursive,
                                                   max_passes) for _, m in groups])
    return _adapt_impl(f, callback, recursive, max_passes)


def _adapt_impl(f: Forest, callback: AdaptCallback, recursive: bool,
                max_passes: int) -> Forest:
    o, nc, bops, dev = f.ops, f.ops.nc, f.bops, f.device
    d = f.d
    refined_origin = torch.zeros(f.num_local, dtype=torch.bool, device=dev)
    coarsened_origin = torch.zeros_like(refined_origin)
    for _ in range(max_passes):
        n = f.num_local
        if n == 0:
            return f
        flags = torch.as_tensor(callback(f.tree, f.simplices()), device=dev).to(torch.int32)
        if tuple(flags.shape) != (n,):
            raise ValueError(f"adapt callback returned shape {tuple(flags.shape)}, need ({n},)")
        # never coarsen refine-children / never refine coarsen-parents
        flags = torch.where(refined_origin & (flags < 0), 0, flags)
        flags = torch.where(coarsened_origin & (flags > 0), 0, flags)
        hidx = torch.nonzero(_family_heads(f)).flatten()
        whole = torch.ones(hidx.shape[0], dtype=torch.bool, device=dev)
        for k in range(nc):
            whole &= flags[hidx + k] < 0
        hidx = hidx[whole]                        # heads of coarsened families
        coarsen_head = torch.zeros(n, dtype=torch.bool, device=dev)
        coarsen_head[hidx] = True
        member = torch.zeros(n, dtype=torch.bool, device=dev)
        for k in range(nc):
            member[hidx + k] = True
        refine = (flags > 0) & ~member & (f.level < o.L)
        if not bool(refine.any() | coarsen_head.any()):
            break
        keep = ~refine & ~member

        # sizes: keep -> 1, refine -> nc, family head -> 1 (other members 0)
        counts = keep.long() + refine.long() * nc + coarsen_head.long()
        offs = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(counts, 0, out=offs[1:])
        total = int(offs[-1])
        A = torch.zeros((total, d), dtype=torch.int32, device=dev)
        L = torch.zeros(total, dtype=torch.int32, device=dev)
        B = torch.zeros_like(L)
        T = torch.zeros_like(L)
        OR = torch.zeros(total, dtype=torch.bool, device=dev)
        OC = torch.zeros_like(OR)
        kidx = torch.nonzero(keep).flatten()
        dst = offs[kidx]
        A[dst] = f.anchor[kidx]
        L[dst] = f.level[kidx]
        B[dst] = f.stype[kidx]
        T[dst] = f.tree[kidx]
        OR[dst] = refined_origin[kidx]
        OC[dst] = coarsened_origin[kidx]
        ridx = torch.nonzero(refine).flatten()
        if ridx.numel():
            kids = bops.children(Simplex(f.anchor[ridx], f.level[ridx], f.stype[ridx]))
            pos = (offs[ridx][:, None] + torch.arange(nc, device=dev)).reshape(-1)
            A[pos] = kids.anchor.reshape(-1, d)
            L[pos] = kids.level.reshape(-1)
            B[pos] = kids.stype.reshape(-1)
            T[pos] = f.tree[ridx].repeat_interleave(nc)
            OR[pos] = True
        if hidx.numel():
            par = bops.parent(Simplex(f.anchor[hidx], f.level[hidx], f.stype[hidx]))
            dst = offs[hidx]
            A[dst] = par.anchor
            L[dst] = par.level
            B[dst] = par.stype
            T[dst] = f.tree[hidx]
            OC[dst] = True
        f = f.replace_elements(A, L, B, T)
        refined_origin, coarsened_origin = OR, OC
        if not recursive:
            break
    return f


# ---------------------------------------------------------------- partition
def partition(forests: list[Forest], comm: Comm,
              weights: list | None = None, overlap: bool = True) -> list[Forest]:
    """Paper Section 5 (Partition): weighted SFC repartitioning, linear
    time — `repartition` metered under its own "partition" phase."""
    return repartition(forests, comm, weights=weights, overlap=overlap,
                       _phase="partition")


def repartition(forests: list[Forest], comm: Comm, weights: list | None = None,
                overlap: bool = True, _phase: str = "repartition") -> list[Forest]:
    """Dynamic repartition with element migration.

    Every rank derives the weighted Partition targets from the GLOBAL weight
    prefix sums (`placement.target_ranks_np`: float64 on the host, midpoint
    rule, monotone), so each destination's elements form one contiguous run
    of the local SFC order.  Migrating runs ship as the Remark-20 wire
    triples (`types.pack_wire`, 13 bytes/element) over one nonblocking
    `ialltoallv`, each entry tagged with its tree's element class;
    receivers recover (anchor, type) with one batched Algorithm-4.8 decode
    per class.  The weight-total allgather flies while the local
    prefix sums compute, and the migration while the kept slice is cut;
    `overlap=False` completes each collective at its post site instead
    (same result, same bytes).

    Old ranks own ascending contiguous global intervals, so concatenating in
    sender order restores the stored order without a sort; it is checked
    (strictly ascending (tree, key)) before return.  `weights`, when given,
    holds one nonnegative float per LOCAL element in stored order (arrays or
    tensors).  Returns NEW forests on the same device.
    """
    P = comm.size
    d = forests[0].d
    cm = forests[0].cmesh
    classes = _forest_classes(forests)
    if weights is None:
        weights = [np.ones(f.num_local, np.float64) for f in forests]
    weights = [to_numpy(w).astype(np.float64) for w in weights]
    for f, w in zip(forests, weights):
        if w.shape != (f.num_local,):
            raise ValueError(
                f"need one weight per local element: {w.shape} vs "
                f"{f.num_local} elements")
        if len(w) and float(w.min()) < 0:
            raise ValueError("element weights must be nonnegative")

    def post(h: CommHandle) -> CommHandle:
        return h if overlap else CommHandle.ready(h.wait())

    with comm.phase(_phase):
        h_tot = post(comm.iallgather([float(w.sum()) for w in weights]))
        cums = [np.cumsum(w) - w / 2.0 for w in weights]
        tots = h_tot.wait()
        prefix = np.concatenate([[0.0], np.cumsum(tots)])
        W = float(prefix[-1])
        send, keep_off = [], []
        for i, f in enumerate(forests):
            g = comm.local_ranks[i]
            t = target_ranks_np(prefix[g] + cums[i], P, W)
            # monotone targets => destination q's elements are the stored
            # run [offs[q], offs[q+1])
            offs = np.searchsorted(t, np.arange(P + 1))
            row = [np.zeros(0, np.uint8)] * P
            for q in range(P):
                a, b = int(offs[q]), int(offs[q + 1])
                if q != g and b > a:
                    tree = to_numpy(f.tree[a:b])
                    ec = classes[0] if len(classes) == 1 else cm.tree_eclass[tree]
                    row[q] = pack_wire(tree, f.keys[a:b], f.level[a:b], eclass=ec)
            keep_off.append((int(offs[g]), int(offs[g + 1])))
            send.append(row)
        h_mig = post(comm.ialltoallv(send))
        kept = []
        for i, f in enumerate(forests):
            a, b = keep_off[i]
            kept.append((f.anchor[a:b], f.level[a:b], f.stype[a:b], f.tree[a:b]))
        recv = h_mig.wait()
    out = []
    for i, f in enumerate(forests):
        g = comm.local_ranks[i]
        dev = f.device
        segs = []  # (src rank, tree, key, level) in ascending sender order
        for p in range(P):
            buf = recv[i][p] if p != g else None
            if buf is not None and len(buf):
                segs.append((p, *unpack_wire(buf)))
        if segs:
            rt = torch.from_numpy(np.concatenate([s[1] for s in segs])).to(dev)
            rk = torch.from_numpy(np.concatenate([s[2] for s in segs]).astype(np.int64)).to(dev)
            rl = torch.from_numpy(np.concatenate([s[3] for s in segs])).to(dev)
            dec = _decode_by_class(f, rt, rk, rl)
        blocks, pos, si = [], 0, 0
        for p in range(P):
            if p == g:
                blocks.append(kept[i])
            elif si < len(segs) and segs[si][0] == p:
                n = len(segs[si][3])
                blocks.append((dec.anchor[pos:pos + n], rl[pos:pos + n],
                               dec.stype[pos:pos + n], rt[pos:pos + n]))
                pos += n
                si += 1
        f2 = f.replace_elements(*(torch.cat(col) for col in zip(*blocks)))
        tt, k = f2.tree.long(), f2.keys
        ok = (tt[1:] > tt[:-1]) | ((tt[1:] == tt[:-1]) & (k[1:] > k[:-1]))
        if not bool(ok.all()):
            raise RuntimeError(f"repartition broke stored SFC order on rank {g}")
        out.append(f2)
    return out


def _decode_by_class(f: Forest, tree: torch.Tensor, key: torch.Tensor,
                     level: torch.Tensor) -> Simplex:
    """Elements of trees `tree` of `f`'s mesh from their keys and int32
    levels: one batched Algorithm-4.8 decode per element class present."""
    anchor = torch.empty((key.shape[0], f.d), dtype=torch.int32, device=key.device)
    stype = torch.empty_like(level)
    for ec, sel in _class_groups(f, tree):
        dec = get_batch_ops(f.d, ec).decode(key[sel], level[sel])
        anchor[sel], stype[sel] = dec.anchor, dec.stype
    return Simplex(anchor, level, stype)


def load_imbalance(forests: list[Forest], comm: Comm,
                   weights: list | None = None) -> float:
    """max rank load / mean rank load over the world (1.0 = perfect), with
    unit weights (element counts) by default."""
    if weights is None:
        sums = [float(f.num_local) for f in forests]
    else:
        sums = [float(to_numpy(w).astype(np.float64).sum()) for w in weights]
    loads = np.asarray(comm.allgather(sums), np.float64)
    return float(loads.max() / max(float(loads.mean()), 1e-300))


def _marker_pairs(forests: list[Forest]) -> list:
    """Per local rank, the (tree, key) of its first element — the payload of
    the marker allgather."""
    return [f.global_first_desc_key() for f in forests]


def _markers_from_pairs(K: int, P: int, pairs) -> tuple[np.ndarray, np.ndarray]:
    """Allgathered first-element pairs -> the lex-sorted host marker table
    (tree int32, key uint64).  Empty ranks inherit the next non-empty rank's
    marker (trailing empties keep the (num_trees, 0) sentinel).  The table
    must be lex-sorted; that is checked, not assumed."""
    mt = np.empty(P, np.int32)
    mk = np.empty(P, np.uint64)
    nxt = (K, 0)
    for r in range(P - 1, -1, -1):
        t, k = pairs[r]
        if t >= K:  # empty rank: route to the next non-empty range
            t, k = nxt
        mt[r], mk[r] = t, np.uint64(k)
        nxt = (t, k)
    lex = list(zip(mt.tolist(), mk.tolist()))
    if lex != sorted(lex):
        raise RuntimeError(
            f"partition markers are not lex-sorted: {lex} — the rank "
            "first-element keys disagree with the stored SFC order")
    return mt, mk


def partition_markers(forests: list[Forest], comm: Comm):
    """Allgather the partition-marker table: per rank the (tree, key) of its
    first local element, as host (tree int32, key uint64) arrays."""
    K = forests[0].num_trees
    pairs = comm.allgather(_marker_pairs(forests))
    return _markers_from_pairs(K, comm.size, pairs)


def count_global(forests: list[Forest], comm: Comm | None = None) -> int:
    """Total element count: the sum over the given forests, or, with `comm`,
    over every rank of the world."""
    if comm is None:
        return int(sum(f.num_local for f in forests))
    return int(sum(comm.allgather([int(f.num_local) for f in forests])))


# ------------------------------------------------------------ host helpers
def _unique_rows(*cols: np.ndarray) -> np.ndarray:
    """The distinct rows of int64 columns, sorted lex by the columns in the
    order given, as an (m, len(cols)) int64 array — the sorted contents of
    the set of tuples the JAX package builds (keys never negative, so int64
    order is its uint64 order)."""
    a = np.stack([np.asarray(c, np.int64).reshape(-1) for c in cols], axis=1)
    if len(a) == 0:
        return a
    a = a[np.lexsort(a.T[::-1])]
    keep = np.ones(len(a), bool)
    keep[1:] = (a[1:] != a[:-1]).any(axis=1)
    return a[keep]


def _pack_triples(tree, key, level, eclass: int = ECLASS_SIMPLEX) -> np.ndarray:
    """(tree, key, level) columns -> deterministic 13-byte/entry wire
    buffer: the distinct triples in lex (tree, key, level) order, so the
    bytes depend only on the set's contents (the JAX package's
    `_pack_triples` of a set of tuples), each tagged with `eclass`."""
    rows = _unique_rows(tree, key, level)
    if len(rows) == 0:
        return np.zeros(0, np.uint8)
    return pack_wire(rows[:, 0], rows[:, 1], rows[:, 2], eclass=eclass)


def _split_by_rank(first: np.ndarray, last: np.ndarray, cols, P: int, skip: int = -1) -> dict:
    """Host rows with a rank range [first, last] -> {rank q: the columns of
    the rows whose range holds q}, for every q but `skip` (a loop over the
    P ranks, vectorised over the rows; first == last groups rows by one
    rank column)."""
    dest = {}
    for q in range(P):
        if q == skip:
            continue
        m = (first <= q) & (q <= last)
        if m.any():
            dest[q] = tuple(c[m] for c in cols)
    return dest


def _expand_ranges(lo: torch.Tensor, hi: torch.Tensor):
    """Ranges [lo[i], hi[i]) -> every (i, position) pair, in order, as two
    flat tensors."""
    cnt = hi - lo
    which = torch.repeat_interleave(torch.arange(cnt.numel(), device=cnt.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    return which, lo[which] + torch.arange(which.numel(), device=cnt.device) - start[which]


# ------------------------------------------------------- face sweep layer
FACE_INTERIOR = 0          # neighbor in the same tree
FACE_INTER_TREE = 1        # neighbor across a glued tree face (coarse mesh)
FACE_DOMAIN_BOUNDARY = 2   # no neighbor: true domain boundary


@dataclasses.dataclass
class FaceSweepLayer:
    """Result of ONE fused `face_sweep` over an element layer: for every
    face of every element, where its neighbor region lives.  Tensors on the
    layer's device with a leading face axis of length nf (d + 1 for
    simplices, 2d for hexes); `level` is shared (same-level neighbors).

      tgt     (nf, n) tree whose leaf table holds the neighbor region
      nkey    (nf, n) int64 neighbor key (that of a neighbor outside the
              root where ~valid — never read it there)
      valid   (nf, n) False at the domain boundary
      anchor  (nf, n, d) / stype (nf, n): the same-level neighbor
      dual    (nf, n) neighbor's face index back to us
      kind    (nf, n) FACE_INTERIOR / FACE_INTER_TREE / FACE_DOMAIN_BOUNDARY
    Across a glued tree face the neighbor, its key and its dual face are
    those in the neighbor tree's frame, and `tgt` is that tree.
    """

    tgt: torch.Tensor
    nkey: torch.Tensor
    valid: torch.Tensor
    anchor: torch.Tensor
    level: torch.Tensor
    stype: torch.Tensor
    dual: torch.Tensor
    kind: torch.Tensor

    def face(self, f: int):
        """The (tgt, nkey, valid, neighbor, dual, kind) view of one face."""
        nb = Simplex(self.anchor[f], self.level, self.stype[f])
        return (self.tgt[f], self.nkey[f], self.valid[f], nb, self.dual[f], self.kind[f])


def face_sweep_layer(f: Forest, tree_ids: torch.Tensor, s: Simplex) -> FaceSweepLayer:
    """Neighbor lookup for ALL faces of the elements in `s` (any subset of
    local elements of one class, read off their trees `tree_ids`) in one
    `face_sweep` launch of that class.

    Faces that leave the root are domain boundary, unless the forest's
    coarse mesh glues the root face they lie on (`Cmesh.root_face_of`, plane
    tests on the device) to another tree.  Every such crossing of the layer,
    whatever connection it uses, goes through ONE `tree_transform` launch
    into the neighbor tree's frame (anchor, type, dual face through the
    connection's face map, target tree), and the crossed neighbors' keys are
    recomputed with ONE `morton_key` launch — the cross-tree branch of the
    JAX package's `face_sweep_layer`, which wraps the int64 transform to
    int32 once; the kernel's uint32 arithmetic gives the same bits."""
    ec = _layer_eclass(f, tree_ids)
    bops = get_batch_ops(f.d, ec)
    sw = bops.face_sweep(s)
    nf = sw.key.shape[0]
    tgt = tree_ids.to(torch.int32).expand(nf, -1).contiguous()
    valid = sw.inside
    kind = torch.where(sw.inside, FACE_INTERIOR, FACE_DOMAIN_BOUNDARY).to(torch.int32)
    anchor, stype, dual, nkey = sw.neighbor.anchor, sw.neighbor.stype, sw.dual, sw.key
    cm = f.cmesh
    if cm is not None and not bool(sw.inside.all()):
        fidx, eidx = torch.nonzero(~sw.inside, as_tuple=True)
        rf = cm.root_face_of(Simplex(s.anchor[eidx], s.level[eidx], s.stype[eidx]), fidx,
                             ec).long()
        glue = cm.gluing(f.device)
        t1 = tree_ids[eidx].long()
        keep = torch.nonzero((rf >= 0) & (glue.face_tree[t1, rf.clamp(min=0)] >= 0)).squeeze(1)
        if keep.numel():
            fk, ek = fidx[keep], eidx[keep]
            valid = valid.clone()
            crossed, dual2, tree2 = bops.transform_crossings(
                t1[keep] * cm.nf_max + rf[keep],
                Simplex(anchor[fk, ek], s.level[ek], stype[fk, ek]),
                dual[fk, ek], glue.conn)
            anchor[fk, ek] = crossed.anchor
            stype[fk, ek] = crossed.stype
            dual[fk, ek] = dual2
            tgt[fk, ek] = tree2
            valid[fk, ek] = True
            kind[fk, ek] = FACE_INTER_TREE
            nkey[fk, ek] = bops.morton_key(crossed)
    return FaceSweepLayer(tgt, nkey, valid, anchor, s.level, stype, dual, kind)


def _layer_handle(f: Forest, bops: BatchedOps, s: Simplex,
                  tree_ids: torch.Tensor) -> SweepHandle | None:
    """The resident sweep handle of an element layer: one fused sweep, with
    over a coarse mesh its crossings carried across the tree faces
    (`face_sweep_layer`)."""
    sw = face_sweep_layer(f, tree_ids, s)
    return bops.sweep_from_layer(sw.tgt, sw.nkey, sw.valid, sw.dual, sw.level)


def face_kinds(f: Forest, s: Simplex) -> torch.Tensor:
    """Classify every face of every element in one fused sweep: (nf, n)
    FACE_INTERIOR (0) / FACE_INTER_TREE (1) / FACE_DOMAIN_BOUNDARY (2)."""
    return face_sweep_layer(f, f.tree, s).kind


def face_kind(f: Forest, s: Simplex, face: int) -> torch.Tensor:
    """One face's row of `face_kinds` (each call sweeps all faces: call
    `face_kinds` once instead of looping this)."""
    return face_kinds(f, s)[face]


# ------------------------------------------------------------------ balance
class BalanceNonConvergence(RuntimeError):
    """Balance hit `max_rounds` before reaching the 2:1 fixpoint.

    Carries `rounds` (how many refine/exchange rounds ran) and
    `dirty_per_rank` (per rank, how many local elements still violated the
    2:1 condition when the budget ran out)."""

    def __init__(self, rounds: int, dirty_per_rank):
        self.rounds = rounds
        self.dirty_per_rank = [int(c) for c in dirty_per_rank]
        super().__init__(
            f"balance did not converge after {rounds} rounds; per-rank "
            f"still-dirty element counts: {self.dirty_per_rank}")


def _resident_sweep(f: Forest, bops: BatchedOps):
    """The resident face sweep of ALL of a rank's elements, memoized on the
    Forest object (its element tensors are never changed in place, so a
    Balance round over an unchanged rank, and a Ghost after a Balance,
    reuse it; the leaves of a swept forest are of one class, a mesh of two
    classes being swept a class subforest at a time).  A reuse charges one
    `face_sweep` dispatch, as the JAX meter does."""
    if f.num_local == 0:
        return None
    h = f.__dict__.get("_sweep")
    if h is not None:
        count_dispatch("face_sweep")
        return h
    h = f.__dict__["_sweep"] = _layer_handle(f, bops, f.simplices(), f.tree)
    return h


def _leaf_table(f: Forest, bops: BatchedOps):
    """The rank's lex-sorted local leaf table (None when empty), memoized
    on the Forest like the resident sweep."""
    if f.num_local == 0:
        return None
    t = f.__dict__.get("_leaf_table")
    if t is None:
        t = f.__dict__["_leaf_table"] = bops.upload_table(f.tree, f.keys, f.level)
    return t


class _Registry:
    """Answering side of Balance: every (tree, level, k0, source rank) query
    a rank has received, as sorted distinct host rows, and a device copy for
    the lookups of the newly refined children."""

    def __init__(self, d: int, L: int):
        self.d, self.L = d, L
        self.rows = np.zeros((0, 4), np.int64)   # (level, tree, k0, src)
        self._dev = None

    def add(self, tree, key, level, src) -> None:
        self.rows = _unique_rows(np.concatenate([self.rows[:, 0], level]),
                                 np.concatenate([self.rows[:, 1], tree]),
                                 np.concatenate([self.rows[:, 2], key]),
                                 np.concatenate([self.rows[:, 3], src]))
        self._dev = None

    def notify(self, ct: torch.Tensor, ck: torch.Tensor, cl: torch.Tensor) -> np.ndarray:
        """New leaves (ct, ck, cl) -> host rows (src, tree, key, level), one
        per registered query whose interval holds the leaf and whose querier
        it can make refine (leaf level > query level + 1)."""
        if len(self.rows) == 0 or ct.numel() == 0:
            return np.zeros((0, 4), np.int64)
        if self._dev is None:
            self._dev = torch.as_tensor(self.rows, device=ct.device)
        reg = self._dev
        levels, starts = np.unique(self.rows[:, 0], return_index=True)
        ends = np.append(starts[1:], len(self.rows))
        out = []
        for lq, a, b in zip(levels.tolist(), starts.tolist(), ends.tolist()):
            sel = torch.nonzero(cl > lq + 1).squeeze(1)
            if sel.numel() == 0:
                continue
            se = int(span_exponent(self.d, self.L, torch.tensor(lq)))
            t, k = ct[sel], ck[sel]
            k0 = (k >> se) << se
            which, pos = _expand_ranges(
                lex_search(reg[a:b, 1], reg[a:b, 2], t, k0),
                lex_search(reg[a:b, 1], reg[a:b, 2], t, k0, right=True))
            out.append(torch.stack([reg[a:b, 3][pos], t[which], k[which], cl[sel][which]], 1))
        if not out:
            return np.zeros((0, 4), np.int64)
        return torch.cat(out).cpu().numpy()


def balance(forests: list[Forest], comm: Comm, max_rounds: int = 64,
            overlap: bool = True) -> list[Forest]:
    """2:1 balance across faces (`_balance_impl`).  Over a mesh of two
    element classes the ripple runs once per class, in ascending class
    order on every rank (the class groups are independent: a face between
    classes is a domain boundary), and each rank's results merge back into
    stored (tree, key) order."""
    if max_rounds < 1:
        raise ValueError("max_rounds must be >= 1")
    return _forests_per_class(
        forests, lambda fs, ec: _balance_impl(fs, comm, max_rounds, overlap, ec))


def _balance_impl(forests: list[Forest], comm: Comm, max_rounds: int, overlap: bool,
                  eclass: int) -> list[Forest]:
    """2:1 balance across faces of the leaves of class `eclass`: the ripple
    algorithm of the JAX package's `balance`, message based, on the
    forests' device.

    A leaf is refined when some face neighbor's key interval holds a leaf
    more than one level finer.  No rank builds the global leaf table:
    routing uses the allgathered P partition markers and the `eval_route`
    kernel's owner ranges, and the wire carries key-range queries (packed
    (tree, key, level) triples, each element's once, when it is created),
    witness replies, and boundary-layer notifications (new leaves, pushed
    to the ranks whose registered query intervals they fall into).  Each
    round's refine decision is local: the resident face sweep against the
    local leaf table (`eval_2to1`) and against the cache of remote leaves
    learned from replies and notifications (`eval_cache`).

    The protocol, its messages and the per-round order of the collectives
    are the JAX package's, so `bytes_for("balance")` equals its; its
    per-query host loops are tensor code here (queries answered with
    one lex search and one range maximum; the registry as sorted rows; new
    children located with one search).  `overlap=False` completes every
    collective where it is posted (same result, same bytes).  Raises
    `BalanceNonConvergence` when `max_rounds` run out.  Returns NEW forests
    on the same device."""
    d = forests[0].d
    o = get_ops(d, eclass)
    L, nc = o.L, o.nc
    bops = get_batch_ops(d, eclass)
    P = comm.size
    nloc = len(forests)
    forests = list(forests)
    dev = forests[0].device

    def post(h: CommHandle) -> CommHandle:
        return h if overlap else CommHandle.ready(h.wait())

    with comm.phase("balance"):
        K = forests[0].num_trees
        h_mk = post(comm.iallgather(_marker_pairs(forests)))
        mt = mk = None
        registries = [_Registry(d, L) for _ in range(nloc)]
        # remote leaves learned from replies and notifications: distinct
        # (tree, key, level) host rows, uploaded as a LeafTable every round
        caches = [np.zeros((0, 3), np.int64) for _ in range(nloc)]
        cache_tables: list = [None] * nloc

        def fold(i: int, bufs: list) -> None:
            cols = [unpack_wire(b) for b in bufs if len(b)]
            if cols:
                c = caches[i]
                caches[i] = _unique_rows(
                    np.concatenate([c[:, 0]] + [x[0] for x in cols]),
                    np.concatenate([c[:, 1]] + [x[1].astype(np.int64) for x in cols]),
                    np.concatenate([c[:, 2]] + [x[2] for x in cols]))

        def recompile_cache(i: int) -> None:
            c = caches[i]
            cache_tables[i] = bops.upload_table(c[:, 0], c[:, 1], c[:, 2], device=dev)

        def sweep_handle(i: int, sel: torch.Tensor | None = None):
            f = forests[i]
            if sel is None:
                return _resident_sweep(f, bops)
            if sel.numel() == 0:
                return None
            s = Simplex(f.anchor[sel], f.level[sel], f.stype[sel])
            return _layer_handle(f, bops, s, f.tree[sel])

        def route_to_dests(i: int, rp) -> dict:
            """RoutePairs rows -> {dest rank: (tree, key, level) columns}."""
            return _split_by_rank(rp.first, rp.last, (rp.tree, rp.key, rp.level), P,
                                  skip=comm.local_ranks[i])

        def build_queries(i: int, sel: torch.Tensor) -> dict:
            h = sweep_handle(i, sel)
            if h is None:
                return {}
            return route_to_dests(i, bops.eval_route(h, mt, mk, comm.local_ranks[i]))

        def answer(i: int, table, srcs: list, bufs: list) -> dict:
            """Register rank i's received queries and answer them from its
            sorted leaves: for each query whose interval holds a leaf finer
            than the querier tolerates, the first leaf of the interval's
            finest level as a witness.  Returns {src: (tree, key, level)}."""
            cols = [unpack_wire(b) for b in bufs]
            qt = np.concatenate([c[0] for c in cols]).astype(np.int64)
            qk = np.concatenate([c[1] for c in cols]).astype(np.int64)
            ql = np.concatenate([c[2] for c in cols]).astype(np.int64)
            src = np.repeat(np.asarray(srcs, np.int64), [len(c[0]) for c in cols])
            registries[i].add(qt, qk, ql, src)
            if table is None:
                return {}
            qt_d, qk_d, ql_d = (torch.as_tensor(x, device=dev) for x in (qt, qk, ql))
            starts = lex_search(table.tree, table.key, qt_d, qk_d)
            ends = lex_search(table.tree, table.key, qt_d,
                              qk_d | span_mask(d, L, ql_d), right=True)
            mx = table.levmax.query(starts, ends)
            w = torch.nonzero(mx > ql_d + 1).squeeze(1)
            j = table.levmax.first_at_least(starts[w], ends[w], mx[w])
            rows = torch.stack([torch.as_tensor(src, device=dev)[w], qt_d[w],
                                table.key[j], mx[w].long()], 1).cpu().numpy()
            return _split_by_rank(rows[:, 0], rows[:, 0], (rows[:, 1], rows[:, 2], rows[:, 3]), P)

        def post_exchange(dests: list, notifs: list | None) -> CommHandle:
            send = []
            for i in range(nloc):
                row = []
                for q in range(P):
                    nt = notifs[i].get(q) if notifs is not None else None
                    qs = dests[i].get(q)
                    row.append((_pack_triples(*nt, eclass) if nt else np.zeros(0, np.uint8),
                                _pack_triples(*qs, eclass) if qs else np.zeros(0, np.uint8)))
                send.append(row)
            return comm.ialltoallv(send)

        def eval_round(pending: CommHandle, pre=None) -> list:
            """One double-buffered round: sweeps and leaf tables first (they
            hide the in-flight queries and notifications), then merge 1
            (answer queries, post replies), the interior 2:1 eval against
            the local leaves (hides the replies), merge 2 (fold replies,
            recompile the caches), and the boundary eval against them."""
            if pre is None:
                handles = [sweep_handle(i) for i in range(nloc)]
                tables = [_leaf_table(f, bops) for f in forests]
            else:
                handles, tables = pre
            recv = pending.wait()
            reply_rows, notif_bufs = [], []
            for i in range(nloc):
                g = comm.local_ranks[i]
                row = [np.zeros(0, np.uint8)] * P
                nbufs, srcs, qbufs = [], [], []
                for p in range(P):
                    if p == g or recv[i][p] is None:
                        continue
                    nbuf, qbuf = recv[i][p]
                    if len(nbuf):
                        nbufs.append(nbuf)
                    if len(qbuf):
                        srcs.append(p)
                        qbufs.append(qbuf)
                if qbufs:
                    for p, cols in answer(i, tables[i], srcs, qbufs).items():
                        row[p] = _pack_triples(*cols, eclass)
                reply_rows.append(row)
                notif_bufs.append(nbufs)
            hr = post(comm.ialltoallv(reply_rows))
            for i in range(nloc):
                fold(i, notif_bufs[i])
            needs = []
            for i in range(nloc):
                if handles[i] is None:
                    needs.append(np.zeros(forests[i].num_local, bool))
                else:
                    nd, _bm = bops.eval_2to1(handles[i], tables[i], mt, mk, comm.local_ranks[i])
                    needs.append(nd)
            rrecv = hr.wait()
            for i in range(nloc):
                g = comm.local_ranks[i]
                fold(i, [rrecv[i][p] for p in range(P)
                         if p != g and rrecv[i][p] is not None])
                recompile_cache(i)
            for i in range(nloc):
                if handles[i] is not None and cache_tables[i] is not None:
                    needs[i] |= bops.eval_cache(handles[i], cache_tables[i], mt, mk,
                                                comm.local_ranks[i])
            return needs

        def refine_and_build(needs: list):
            """Refine this round's violators and build the next round's
            queries (from the new children) and notifications (to the
            ranks whose registered intervals the children fall into)."""
            new_dests: list = [{} for _ in range(nloc)]
            new_notifs: list = [{} for _ in range(nloc)]
            for i in range(nloc):
                nd = needs[i]
                if not nd.any():
                    continue
                f = forests[i]
                idx = torch.as_tensor(np.nonzero(nd)[0], device=dev)
                lv = f.level[idx].long()
                shift = (d * (L - lv - 1)).clamp(min=0)
                j = torch.arange(nc, device=dev, dtype=torch.int64)
                ck = (f.keys[idx][:, None]
                      + torch.bitwise_left_shift(j[None, :], shift[:, None])).reshape(-1)
                ct = f.tree[idx].long().repeat_interleave(nc)
                cl = (lv + 1).repeat_interleave(nc)
                flags = torch.as_tensor(nd.astype(np.int32), device=dev)
                f2 = adapt(f, lambda tree, elems, fl=flags: fl, recursive=False)
                forests[i] = f2
                sel = torch.sort(lex_search(f2.tree, f2.keys, ct, ck)).values
                new_dests[i] = build_queries(i, sel)
                rows = registries[i].notify(ct, ck, cl)
                if len(rows):
                    new_notifs[i] = _split_by_rank(rows[:, 0], rows[:, 0],
                                                   (rows[:, 1], rows[:, 2], rows[:, 3]), P)
            return new_dests, new_notifs

        handles0 = [sweep_handle(i) for i in range(nloc)]
        tables0 = [_leaf_table(f, bops) for f in forests]
        mt, mk = _markers_from_pairs(K, P, h_mk.wait())
        pending = post(post_exchange(
            [route_to_dests(i, bops.eval_route(handles0[i], mt, mk, comm.local_ranks[i]))
             if handles0[i] is not None else {}
             for i in range(nloc)], None))
        needs = eval_round(pending, (handles0, tables0))
        for _ in range(max_rounds):
            h_conv = post(comm.iallgather([int(nd.any()) for nd in needs]))
            new_dests, new_notifs = refine_and_build(needs)
            if not any(h_conv.wait()):
                return forests
            pending = post(post_exchange(new_dests, new_notifs))
            needs = eval_round(pending)
        counts = comm.allgather([int(nd.sum()) for nd in needs])
        if not any(counts):
            return forests
    raise BalanceNonConvergence(max_rounds, counts)


def _gather_leaf_table(forests: list[Forest], comm: Comm, bops: BatchedOps):
    """Allgather every rank's (tree, key, level) columns, as the JAX
    oracles do (host arrays of its dtypes' widths, so the bytes metered
    equal its), and upload them lex-sorted to the forests' device: (the
    global `LeafTable`, or None when every rank is empty; each row's owner
    rank, int64).  The caller picks the phase."""
    tables = comm.allgather([(to_numpy(f.tree), to_numpy(f.keys), to_numpy(f.level))
                             for f in forests])
    dev = forests[0].device
    tree, key, level = (torch.from_numpy(np.concatenate([t[c] for t in tables])).to(dev)
                        for c in range(3))
    owner = torch.repeat_interleave(torch.arange(len(tables), device=dev),
                                    torch.as_tensor([len(t[0]) for t in tables], device=dev))
    by_key = torch.argsort(key, stable=True)
    order = by_key[torch.argsort(tree[by_key], stable=True)]
    return bops.upload_table(tree[order], key[order], level[order]), owner[order]


def balance_oracle(forests: list[Forest], comm: Comm, max_rounds: int = 64) -> list[Forest]:
    """The global-leaf-table Balance, the JAX package's test oracle and
    wire-volume baseline: every round allgathers the full (tree, key,
    level) leaf table of every rank, under the "balance_oracle" phase, so
    `bytes_for("balance_oracle")` equals the JAX package's.  The
    message-based `balance` must equal its result element for element.
    Over a mesh of two classes it runs once per class group, like
    `balance`.  Returns NEW forests on the same device."""
    return _forests_per_class(
        forests, lambda fs, ec: _balance_oracle_impl(fs, comm, max_rounds, ec))


def _balance_oracle_impl(forests: list[Forest], comm: Comm, max_rounds: int,
                         eclass: int) -> list[Forest]:
    """Rounds of: allgather the global table; per rank one face sweep, each
    neighbor interval [nkey, nkey | span_mask] located in the table by lex
    search and its range maximum of levels taken; a non-recursive Adapt of
    the elements with a leaf more than one level finer across a face.  The
    JAX package's `changed` allgather ends the loop; `max_rounds` spent
    raises `BalanceNonConvergence` with the last round's violators per
    rank."""
    if max_rounds < 1:
        raise ValueError("max_rounds must be >= 1")
    d = forests[0].d
    L = get_ops(d, eclass).L
    bops = get_batch_ops(d, eclass)
    forests = list(forests)
    nloc = len(forests)
    with comm.phase("balance_oracle"):
        for _ in range(max_rounds):
            table, _owner = _gather_leaf_table(forests, comm, bops)
            changed = False
            last_dirty = [0] * nloc
            for i, f in enumerate(forests):
                if f.num_local == 0:
                    continue
                sw = face_sweep_layer(f, f.tree, f.simplices())
                lo = lex_search(table.tree, table.key, sw.tgt, sw.nkey)
                hi = lex_search(table.tree, table.key, sw.tgt,
                                sw.nkey | span_mask(d, L, f.level)[None, :], right=True)
                need = (sw.valid & (table.levmax.query(lo, hi) > (f.level + 1)[None, :])).any(0)
                dirty = int(need.sum())
                if dirty:
                    changed = True
                    last_dirty[i] = dirty
                    forests[i] = adapt(f, lambda tree, elems, fl=need.to(torch.int32): fl)
            if not any(comm.allgather([int(changed)] * nloc)):
                return forests
        counts = comm.allgather(last_dirty)
    raise BalanceNonConvergence(max_rounds, counts)


# -------------------------------------------------------------------- ghost
def _empty_ghost(d: int, device) -> dict:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return {"anchor": z(0, d), "level": z(0), "stype": z(0), "tree": z(0), "owner": z(0)}


def _ghost_from_candidates(f: Forest, rows: np.ndarray) -> dict:
    """Distinct (tree, key, level, owner) host rows, sorted -> the ghost
    layer's tensors on `device` (anchors and types recovered by one batched
    decode per element class present, Remark 20)."""
    if len(rows) == 0:
        return _empty_ghost(f.d, f.device)
    t, k, l, p = (torch.as_tensor(np.ascontiguousarray(rows[:, c]), device=f.device)
                  for c in range(4))
    gs = _decode_by_class(f, t, k, l.to(torch.int32))
    return {"anchor": gs.anchor, "level": gs.level, "stype": gs.stype,
            "tree": t.to(torch.int32), "owner": p.to(torch.int32)}


def _face_planes(V: torch.Tensor):
    """Batched `tables.face_plane`: (m, d, d) points -> the primitive
    integer plane through each d-tuple, (normal (m, d), offset (m,)), int64."""
    V = V.to(torch.int64)
    if V.shape[-1] == 2:
        e = V[:, 1] - V[:, 0]
        n = torch.stack([-e[:, 1], e[:, 0]], dim=1)
        g = torch.gcd(n[:, 0].abs(), n[:, 1].abs())
    else:
        n = torch.linalg.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0], dim=1)
        g = torch.gcd(torch.gcd(n[:, 0].abs(), n[:, 1].abs()), n[:, 2].abs())
    n = torch.div(n, g.clamp(min=1)[:, None], rounding_mode="floor")
    return n, (n * V[:, 0]).sum(dim=1)


def ghost(forests: list[Forest], comm: Comm, overlap: bool = True) -> list[dict]:
    """Face-ghost layer: for each rank, the remote leaves touching its
    elements across faces.  Returns per local rank a dict of tensors on the
    forests' device — anchor (m, d), level, stype, tree, owner (int32) — in
    (tree, key, level, owner) order.

    Message based, as in the JAX package: each element's neighbor key
    interval goes, by the allgathered partition markers and the
    `eval_route` kernel's owner ranges, to its remote owner ranks as a
    14-byte (tree, key, level, dual face) quad; owners answer from their
    sorted leaves — same-or-finer leaves that touch the shared face (a whole
    facet of their corners on the plane of the neighbor's dual facet, the
    neighbor decoded from the query key), or the coarser leaf that contains
    the interval, by the owner of its first key only — and reply with leaf
    triples.  The answering is tensor code: one lex search per bound, the
    plane test batched over every (query, leaf) pair.  `overlap=False`
    completes every collective where it is posted (same bytes, same
    layers).  Over a mesh of two element classes the exchange runs once per
    class, in ascending class order, and each rank's candidates are joined
    before the layer is assembled."""
    cands = _candidates_per_class(forests,
                                  lambda fs, ec: _ghost_impl(fs, comm, overlap, ec))
    return [_ghost_from_candidates(forests[0], c) for c in cands]


def _ghost_impl(forests: list[Forest], comm: Comm, overlap: bool, eclass: int) -> list:
    """The ghost exchange of the leaves of class `eclass`; returns per local
    rank the distinct candidate rows (tree, key, level, owner), sorted, as
    an (m, 4) int64 host array."""
    d = forests[0].d
    o = get_ops(d, eclass)
    L = o.L
    bops = get_batch_ops(d, eclass)
    dev = forests[0].device
    fci = torch.as_tensor(o.face_corner_indices, dtype=torch.int64, device=dev)
    cpf = fci.shape[1]
    P = comm.size
    nloc = len(forests)

    def post(h: CommHandle) -> CommHandle:
        return h if overlap else CommHandle.ready(h.wait())

    with comm.phase("ghost"):
        K = forests[0].num_trees
        h_mk = post(comm.iallgather(_marker_pairs(forests)))
        handles = [_resident_sweep(f, bops) for f in forests]
        mt, mk = _markers_from_pairs(K, P, h_mk.wait())
        mt_d = torch.as_tensor(mt, device=dev)
        mk_d = torch.as_tensor(mk.astype(np.int64), device=dev)

        # ---- route queries: one eval_route per rank, quads per destination
        send = []
        for i in range(nloc):
            g = comm.local_ranks[i]
            row = [np.zeros(0, np.uint8)] * P
            if handles[i] is not None:
                rp = bops.eval_route(handles[i], mt, mk, g)
                for q, cols in _split_by_rank(rp.first, rp.last,
                                              (rp.tree, rp.key, rp.level, rp.dual), P,
                                              skip=g).items():
                    r = _unique_rows(*cols)
                    row[q] = pack_wire(r[:, 0], r[:, 1], r[:, 2], extra=r[:, 3], eclass=eclass)
            send.append(row)
        h_q = post(comm.ialltoallv(send))
        # the local leaf tables upload while the queries fly
        tables = [_leaf_table(f, bops) for f in forests]
        recv = h_q.wait()

        # ---- answer from the local sorted leaves
        reply_rows = []
        for i, f in enumerate(forests):
            g = comm.local_ranks[i]
            row = [np.zeros(0, np.uint8)] * P
            cols, srcs = [], []
            for p in range(P):
                buf = recv[i][p]
                if p == g or buf is None or not len(buf):
                    continue
                cols.append(unpack_wire(buf, with_extra=True))
                srcs.append(p)
            tb = tables[i]
            if cols and tb is not None:
                src = torch.as_tensor(np.repeat(srcs, [len(c[0]) for c in cols]), device=dev)
                t, k0, lq, du = (torch.as_tensor(np.concatenate([c[x] for c in cols])
                                                 .astype(np.int64), device=dev)
                                 for x in range(4))
                starts = lex_search(tb.tree, tb.key, t, k0)
                ends = lex_search(tb.tree, tb.key, t, k0 | span_mask(d, L, lq), right=True)
                tree_start = torch.searchsorted(tb.tree, t)
                # same-or-finer leaves in the interval must TOUCH the face
                pe = torch.nonzero(ends > starts).squeeze(1)
                pos, leaf = _expand_ranges(starts[pe], ends[pe])
                hits = [torch.zeros(0, dtype=torch.int64, device=dev)] * 2
                if pe.numel():
                    nb = bops.decode(k0[pe], lq[pe].to(torch.int32))
                    corners = o.coordinates(nb).to(torch.int64)          # (m, corners, d)
                    facet = fci[du[pe]][:, :d]                            # (m, d)
                    nrm, rhs = _face_planes(torch.gather(
                        corners, 1, facet[:, :, None].expand(-1, -1, d)))
                    leaves = Simplex(f.anchor[leaf], f.level[leaf], f.stype[leaf])
                    lc = o.coordinates(leaves).to(torch.int64)           # (np, corners, d)
                    on = ((lc * nrm[pos][:, None, :]).sum(-1) == rhs[pos][:, None]).sum(-1)
                    ok = on == cpf
                    hits = [pe[pos[ok]], leaf[ok]]
                # a coarser leaf containing the interval: the interval is
                # empty globally, and only the owner of its first key answers
                jj = (starts - 1).clamp(min=0)
                own = bops.owner_rank(t, k0, mt_d, mk_d)
                pred = ((ends == starts) & (starts > tree_start) & (own == g)
                        & (((k0 - tb.key[jj]) >> span_exponent(d, L, tb.level[jj])) == 0))
                pi = torch.nonzero(pred).squeeze(1)
                ent = torch.cat([hits[0], pi])
                lf = torch.cat([hits[1], jj[pi]])
                rows = torch.stack([src[ent], tb.tree[lf], tb.key[lf],
                                    tb.level[lf].long()], 1).cpu().numpy()
                for p, c in _split_by_rank(rows[:, 0], rows[:, 0],
                                           (rows[:, 1], rows[:, 2], rows[:, 3]), P).items():
                    row[p] = _pack_triples(*c, eclass)
            reply_rows.append(row)
        rrecv = post(comm.ialltoallv(reply_rows)).wait()

        # ---- candidates: replies from rank p are leaves owned by p
        out = []
        for i in range(nloc):
            g = comm.local_ranks[i]
            parts = []
            for p in range(P):
                buf = rrecv[i][p]
                if p == g or buf is None or not len(buf):
                    continue
                t_, k_, l_ = unpack_wire(buf)
                parts.append((t_, k_.astype(np.int64), l_, np.full(len(t_), p)))
            out.append(_unique_rows(*(np.concatenate(c) for c in zip(*parts)))
                       if parts else np.zeros((0, 4), np.int64))
        return out


def ghost_oracle(forests: list[Forest], comm: Comm) -> list[dict]:
    """The global-leaf-table Ghost, the JAX package's test oracle and
    wire-volume baseline: one allgather of every rank's full (tree, key,
    level) columns under the "ghost_oracle" phase, searched directly.  The
    message-based `ghost` must give identical layers.  Over a mesh of two
    classes it runs once per class group, like `ghost`."""
    cands = _candidates_per_class(forests,
                                  lambda fs, ec: _ghost_oracle_impl(fs, comm, ec))
    return [_ghost_from_candidates(forests[0], c) for c in cands]


def _ghost_oracle_impl(forests: list[Forest], comm: Comm, eclass: int) -> list:
    """Per local rank the distinct candidate rows (tree, key, level, owner)
    of class `eclass`, sorted, as an (m, 4) int64 host array: for every
    valid face of every element, the leaves owned elsewhere in the
    neighbor's key interval that touch the shared face (a whole facet of
    their corners, decoded in one batch, on the plane of the neighbor's
    dual facet), or, where the interval holds no leaf, the coarser leaf
    before it when it covers the neighbor and is owned elsewhere."""
    d = forests[0].d
    o = get_ops(d, eclass)
    L = o.L
    bops = get_batch_ops(d, eclass)
    dev = forests[0].device
    fci = torch.as_tensor(o.face_corner_indices, dtype=torch.int64, device=dev)
    cpf = fci.shape[1]
    with comm.phase("ghost_oracle"):
        table, owner = _gather_leaf_table(forests, comm, bops)
    out = []
    for i, f in enumerate(forests):
        me = comm.local_ranks[i]
        if f.num_local == 0:
            out.append(np.zeros((0, 4), np.int64))
            continue
        sw = face_sweep_layer(f, f.tree, f.simplices())
        fi, ei = torch.nonzero(sw.valid, as_tuple=True)
        t, k, lv = sw.tgt[fi, ei].long(), sw.nkey[fi, ei], f.level[ei]
        lo = lex_search(table.tree, table.key, t, k)
        hi = lex_search(table.tree, table.key, t, k | span_mask(d, L, lv), right=True)
        # only intervals holding a leaf owned elsewhere are expanded
        elsewhere = owner != me
        before = torch.zeros(table.n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(elsewhere.long(), 0, out=before[1:])
        q = torch.nonzero(before[hi] > before[lo]).squeeze(1)
        slot, leaf = _expand_ranges(lo[q], hi[q])
        m = elsewhere[leaf]
        slot, leaf = q[slot[m]], leaf[m]
        hits = leaf[:0]
        if leaf.numel():
            sf, se = fi[slot], ei[slot]
            nb = Simplex(sw.anchor[sf, se], lv[slot], sw.stype[sf, se])
            corners = o.coordinates(nb).to(torch.int64)
            facet = fci[sw.dual[sf, se].long()][:, :d]
            nrm, rhs = _face_planes(torch.gather(corners, 1, facet[:, :, None].expand(-1, -1, d)))
            lc = o.coordinates(bops.decode(table.key[leaf], table.level[leaf])).to(torch.int64)
            hits = leaf[((lc * nrm[:, None, :]).sum(-1) == rhs[:, None]).sum(-1) == cpf]
        pj = (lo - 1).clamp(min=0)
        pred = ((lo == hi) & (lo > 0) & (table.tree[pj] == t) & elsewhere[pj]
                & (k <= (table.key[pj] | span_mask(d, L, table.level[pj]))))
        j = torch.cat([hits, pj[pred]])
        rows = torch.stack([table.tree[j], table.key[j], table.level[j].long(), owner[j]], 1)
        out.append(_unique_rows(*rows.cpu().numpy().T))
    return out


# ------------------------------------------------------------------ iterate
def iterate(f: Forest, elem_fn=None, face_fn=None) -> list:
    """Paper's Iterate: callbacks over a rank's local elements and its local
    face pairs, pairs across glued tree faces included over a coarse mesh.

    `elem_fn(f.tree, f.simplices())` and `face_fn(f, pairs)` are called as
    the JAX package calls them, and their results returned in that order.
    `pairs` is an (n, 4) int64 tensor on the forest's device of rows (i, j,
    face_i, face_j), equal to the JAX package's array row for row:
    same-level pairs once (i < j in storage order; a self-pair across a
    periodic gluing with face_i < face_j), hanging faces once per fine
    sub-face as (fine i, coarse j) with face_j the coarse facet holding the
    shared face; face-major within a class group, ascending i within a
    face.  Over a mesh of two classes each class group is swept on its own
    (a face between classes is a domain boundary) and `face_fn` is called
    once with every pair, in the forest's local indexing."""
    results = []
    if elem_fn is not None:
        results.append(elem_fn(f.tree, f.simplices()))
    if face_fn is not None:
        pairs = [_iterate_pairs(f, sel, ec) for ec, sel in _class_groups(f)]
        results.append(face_fn(f, torch.cat(pairs) if pairs else
                               torch.zeros((0, 4), dtype=torch.int64, device=f.device)))
    return results


def _iterate_pairs(f: Forest, sel, eclass: int) -> torch.Tensor:
    """The local face pairs of one class group (`sel` selects its elements
    among the rank's), in the forest's local indexing.

    One face sweep of the group, then ONE lex search: the leaf that can
    share each face is the predecessor of (tgt, nkey) among the group's
    own leaves (neighbors never leave the class), because leaves do not
    overlap.  At the neighbor's level and key it is a same-level pair; at a
    coarser level whose span holds nkey, a hanging one (the JAX package
    walks the ancestor keys instead); else the neighbor region is finer or
    outside the forest and the pair is found from the other side."""
    dev = f.device
    gid = torch.arange(f.num_local, device=dev)[sel]
    n = gid.numel()
    if n == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=dev)
    o = get_ops(f.d, eclass)
    d, L = f.d, o.L
    s = take(f.simplices(), gid)
    tree, keys, level = f.tree[gid], f.keys[gid], f.level[gid]
    sw = face_sweep_layer(f, tree, s)
    j = lex_search(tree, keys, sw.tgt, sw.nkey, right=True) - 1
    jc = j.clamp(min=0)
    jl = level[jc]
    hit = sw.valid & (j >= 0) & (tree[jc] == sw.tgt)
    face = torch.arange(o.nf, device=dev)[:, None]
    row = torch.arange(n, device=dev)[None, :]
    same = (hit & (jl == level[None, :]) & (keys[jc] == sw.nkey)
            & ((jc > row) | ((jc == row) & (face < sw.dual))))
    hang = hit & (jl < level[None, :]) & (keys[jc] == (sw.nkey & ~span_mask(d, L, jl)))
    face_j = sw.dual.to(torch.int64)
    if bool(hang.any()):
        # the coarse facet whose plane holds every corner of the shared face
        hf, he = torch.nonzero(hang, as_tuple=True)
        fci = torch.as_tensor(o.face_corner_indices, dtype=torch.int64, device=dev)
        nb = Simplex(sw.anchor[hf, he], level[he], sw.stype[hf, he])
        idx = fci[sw.dual[hf, he].long()]
        shared = torch.gather(o.coordinates(nb).to(torch.int64), 1,
                              idx[:, :, None].expand(-1, -1, d))
        coarse = o.coordinates(take(s, jc[hf, he])).to(torch.int64)
        on = []
        for fc in range(o.nf):
            nrm, rhs = _face_planes(coarse[:, fci[fc, :d]])
            on.append(((shared * nrm[:, None, :]).sum(-1) == rhs[:, None]).all(-1))
        on = torch.stack(on, 1)
        if not bool(on.any(1).all()):
            raise AssertionError("hanging face without coarse facet")
        face_j[hf, he] = on.to(torch.int8).argmax(1)
    kf, ke = torch.nonzero(same | hang, as_tuple=True)
    return torch.stack([gid[ke], gid[jc[kf, ke]], kf, face_j[kf, ke]], 1)


# ----------------------------------------------------------------- validate
def validate(forests: list[Forest], ghosts: list[dict] | None = None) -> bool:
    """Forest invariants: globally ascending (tree, key) leaf order in
    stored rank-major order, leaves pairwise non-overlapping, all inside
    their root, complete volume coverage of the trees — and, with `ghosts`,
    every ghost entry an actual leaf of its claimed owner rank, never the
    rank itself.  All on the forests' device; the owner check is one sorted
    lookup of the ghosts in the global leaf order.  The inside-root test and
    the ghosts' keys go per element class."""
    d = forests[0].d
    o = get_ops(d)
    t = torch.cat([f.tree for f in forests]).long()
    k = torch.cat([f.keys for f in forests])
    lv = torch.cat([f.level for f in forests])
    n = t.shape[0]
    if n and (int(lv.min()) < 0 or int(lv.max()) > o.L):
        return False
    if n > 1:
        same = t[1:] == t[:-1]
        if not bool((t[1:] >= t[:-1]).all()):
            return False
        if not bool((k[1:] > k[:-1])[same].all()):
            return False
        # non-overlap: the next key lies at least one span further
        gap = (k[1:] - k[:-1]) >> span_exponent(d, o.L, lv[:-1])
        if not bool((gap != 0)[same].all()):
            return False
    for f in forests:
        for ec, sel in _class_groups(f):
            if f.num_local and not bool(
                    get_batch_ops(d, ec).is_inside_root(take(f.simplices(), sel)).all()):
                return False
    counts = torch.bincount(lv.long(), minlength=o.L + 1).tolist()
    vol = sum(c / float(1 << (d * l)) for l, c in enumerate(counts))
    K = forests[0].num_trees
    if not abs(vol - K) < 1e-9 * max(K, 1):
        return False
    if ghosts is not None:
        rank = torch.repeat_interleave(
            torch.arange(len(forests), device=t.device),
            torch.as_tensor([f.num_local for f in forests], device=t.device))
        for p, gh in enumerate(ghosts):
            m = len(gh["level"])
            if m == 0:
                continue
            if n == 0:
                return False
            gs = Simplex(gh["anchor"], gh["level"], gh["stype"])
            gk = torch.empty(m, dtype=torch.int64, device=t.device)
            for ec, sel in _class_groups(forests[0], gh["tree"]):
                gk[sel] = get_batch_ops(d, ec).morton_key(take(gs, sel))
            owner = gh["owner"].long()
            pos = lex_search(t, k, gh["tree"], gk).clamp(max=n - 1)
            found = ((t[pos] == gh["tree"]) & (k[pos] == gk) & (lv[pos] == gh["level"])
                     & (rank[pos] == owner) & (owner != p))
            if not bool(found.all()):
                return False
    return True
