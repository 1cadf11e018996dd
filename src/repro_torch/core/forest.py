"""Forest-of-trees AMR on the tetrahedral SFC (paper Section 5): New, Adapt
and Partition, on PyTorch tensors.

The counterpart of the JAX package's `repro.core.forest` for the path the
paper demonstrates: New (Alg. 5.1) -> Adapt (refine / coarsen by callback,
optionally recursive) -> Partition (weighted SFC repartition with element
migration).  A forest is a coarse mesh of K root simplices ("trees"), each
adaptively refined, with leaves totally ordered by (tree, TM-index) and
split across P ranks by contiguous SFC ranges.

SPMD style as in the reference: every function computes the view of the
ranks resident in this process (`comm.local_ranks` — all P under `SimComm`)
and cross-rank data moves through `core.comm`.  A forest's element fields
live as tensors on its device (keys int64, everything else int32), and the
element math goes through `core.batch` — CUDA kernels on the card, their
plain versions on the CPU.  What travels between ranks (weight totals,
packed wire triples) and the float64 partition prefix sums stay host numpy,
so the byte counts and the rank boundaries equal the reference's.

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
a card they raise.  `adapt` and `partition` follow the forest's device.
Coarse meshes (`cmesh`) and the hex element class are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .batch import BatchedOps, get_batch_ops
from .comm import Comm, CommHandle, LocalComm, SimComm
from .errors import not_ported
from .ops import ElementOps, get_ops
from .placement import target_ranks_np
from .types import ECLASS_SIMPLEX, Simplex, pack_wire, to_numpy, unpack_wire

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
]

def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card, and raises if there
    is none (pass device="cpu" to run on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


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
    cmesh: object = None

    def __post_init__(self):
        if self.cmesh is not None:
            raise not_ported("a forest over a coarse mesh (cmesh)", "cmesh")

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    @property
    def eclass(self) -> int:
        return ECLASS_SIMPLEX

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
        order), with their keys computed in one batched encode."""
        dev = self.device
        anchor = anchor.to(dev, torch.int32).contiguous()
        level = level.to(dev, torch.int32).contiguous()
        stype = stype.to(dev, torch.int32).contiguous()
        tree = tree.to(dev, torch.int32).contiguous()
        keys = self.bops.morton_key(Simplex(anchor, level, stype))
        return dataclasses.replace(
            self, anchor=anchor, level=level, stype=stype, tree=tree, keys=keys)

    def global_first_desc_key(self) -> tuple[int, int]:
        """(tree, key) of this rank's first element; used as partition marker."""
        if self.num_local == 0:
            return (self.num_trees, 0)
        return (int(self.tree[0]), int(self.keys[0]))


def _empty(d, num_trees, rank, num_ranks, device) -> Forest:
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Forest(d, num_trees, rank, num_ranks, z(0, d), z(0), z(0), z(0),
                  z(0, dtype=torch.int64))


# ---------------------------------------------------------------------- new
def new_uniform(d: int, num_trees: int, level: int, comm: Comm,
                method: str = "decode", cmesh=None, device=None) -> list[Forest]:
    """Paper Algorithm 5.1 (New): partitioned uniform level-`level` forest.

    Returns one `Forest` per rank resident in this process (all P under
    `SimComm`), on `device` (the card by default)."""
    dev = resolve_device(device)
    return [new_uniform_rank(d, num_trees, level, p, comm.size, method=method,
                             cmesh=cmesh, device=dev)
            for p in comm.local_ranks]


def new_uniform_rank(d: int, num_trees: int, level: int, rank: int, num_ranks: int,
                     method: str = "decode", cmesh=None, device=None) -> Forest:
    """One rank's portion of a uniform refinement — communication free: the
    rank's index range of each tree goes through one batched Algorithm-4.8
    decode (`method="decode"`)."""
    if cmesh is not None:
        raise not_ported("a forest over a coarse mesh (cmesh)", "cmesh")
    if method == "successor":
        raise not_ported('new_uniform(method="successor")', "successor")
    if method != "decode":
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    o = get_ops(d)
    if not 0 <= level <= o.L:
        raise ValueError(f"level must lie in [0, {o.L}], got {level}")
    n_per_tree = o.num_elements(level)
    N = n_per_tree * num_trees
    g_first = (N * rank) // num_ranks
    g_last = (N * (rank + 1)) // num_ranks  # exclusive
    f = _empty(d, num_trees, rank, num_ranks, dev)
    if g_last <= g_first:
        return f
    bops = get_batch_ops(d)
    parts = []
    for t in range(g_first // n_per_tree, (g_last - 1) // n_per_tree + 1):
        e_first = max(g_first - t * n_per_tree, 0)
        e_last = min(g_last - t * n_per_tree, n_per_tree)
        ids = torch.arange(e_first, e_last, dtype=torch.int64, device=dev)
        lv = torch.full_like(ids, level, dtype=torch.int32)
        s = bops.decode(ids << (d * (o.L - level)), lv)
        parts.append((s.anchor, s.level, s.stype, torch.full_like(lv, t)))
    return f.replace_elements(*(torch.cat(col) for col in zip(*parts)))


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
    until nothing changes (at most `max_passes`)."""
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
    `ialltoallv`; receivers recover (anchor, type) with one batched
    Algorithm-4.8 decode.  The weight-total allgather flies while the local
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
                    row[q] = pack_wire(f.tree[a:b], f.keys[a:b], f.level[a:b])
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
            dec = get_batch_ops(d).decode(rk, rl)
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
