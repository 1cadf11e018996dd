"""Batched element ops: the one seam through which the forest reaches the
element math (counterpart of `BatchedOps` in the JAX package's
`repro.core.batch`).

Every element method takes a `Simplex` (or keys) of shape (n,) on one device
and goes to the wrapper in `kernels.ops`, which launches the CUDA kernel for
CUDA tensors and runs the plain PyTorch version for CPU tensors.  There is
no backend knob: the device decides.  Outputs stay on the inputs' device.

The fused Balance/Ghost eval stage lives here too: `sweep_from_layer` keeps
one face sweep of an element layer resident as a `SweepHandle` (the
forest's `face_sweep_layer`, with over a coarse mesh the crossings that
`transform_crossings` carried into the neighbor trees; `sweep_full` is the
same handle straight from `face_sweep`, without crossings), `upload_table`
makes a lex-sorted `LeafTable`, and `eval_2to1` / `eval_cache` /
`eval_route` compute the 2:1 need masks, the boundary mask and the
compacted routing rows on the device, each with ONE host fetch of its
result.  The JAX package writes these as jitted jnp programs over padded
buffers; here they are plain PyTorch code on unpadded tensors (no jit, so
no padding buckets and no retrace meter), and the lex (tree, key) binary
search and the range maximum are written out (`lex_search`, `RangeMax`).

`dispatch_counts()` counts calls per op since `reset_dispatch_counts()`,
whatever the device, under the JAX meters' names; `host_fetch_counts()`
counts the eval stage's device-to-host fetches at the JAX package's sites.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops
from .cmesh import pack_connection
from .keys import span_mask, to_u64
from .ops import get_ops
from .types import ECLASS_SIMPLEX, Simplex

__all__ = ["BatchedOps", "FaceSweep", "SweepHandle", "LeafTable", "RoutePairs", "RangeMax",
           "lex_search", "get_batch_ops", "dispatch_counts", "reset_dispatch_counts",
           "count_dispatch", "host_fetch_counts", "reset_host_fetch_counts"]

_dispatch_counts: dict[str, int] = {}
_host_fetch_counts: dict[str, int] = {}


def reset_dispatch_counts() -> None:
    """Zero the per-op dispatch counters."""
    _dispatch_counts.clear()


def dispatch_counts() -> dict[str, int]:
    """Snapshot of {op name: number of BatchedOps calls} since reset."""
    return dict(_dispatch_counts)


def count_dispatch(name: str) -> None:
    """Charge one dispatch to `name`: a memoized batched result (the
    per-Forest resident sweep) counts each reuse like the dispatch it
    replaces, so the meters keep their evals-per-round meaning."""
    _dispatch_counts[name] = _dispatch_counts.get(name, 0) + 1


_count = count_dispatch


def reset_host_fetch_counts() -> None:
    """Zero the eval stage's host-fetch counters."""
    _host_fetch_counts.clear()


def host_fetch_counts() -> dict[str, int]:
    """Snapshot of {eval stage: device-to-host fetches} since reset."""
    return dict(_host_fetch_counts)


def _fetch(name: str, t: torch.Tensor) -> np.ndarray:
    """The eval stage's one device-to-host copy of a result, counted."""
    _host_fetch_counts[name] = _host_fetch_counts.get(name, 0) + 1
    return t.cpu().numpy()


# ------------------------------------------------------------ search helpers
def lex_search(tree_col: torch.Tensor, key_col: torch.Tensor, qt: torch.Tensor,
               qk: torch.Tensor, right: bool = False) -> torch.Tensor:
    """Positions of lex (tree, key) queries in a table sorted lex by (tree,
    key): the first row lex->= the query (lex-> with `right`), int64, the
    shape of `qt`.  Each query's tree slice comes from one searchsorted on
    the tree column; a binary search over the keys of that slice, written
    out for all queries at once, does the rest (one searchsorted over the
    keys alone would cross tree boundaries)."""
    n = tree_col.shape[0]
    tc = tree_col.to(torch.int64).contiguous()
    q = qt.to(torch.int64)
    lo = torch.searchsorted(tc, q)
    hi = torch.searchsorted(tc, q, right=True)
    if n == 0:
        return lo
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        km = key_col[mid.clamp(max=n - 1)]
        go = (km <= qk) if right else (km < qk)
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


class RangeMax:
    """Range maximum over a small nonnegative integer column (levels): a
    sparse table of row k = max over windows of 2^k, stored as one int8
    tensor, so a query [lo, hi) costs two gathers whatever its width."""

    def __init__(self, values: torch.Tensor):
        n = values.shape[0]
        rows, w = [values.to(torch.int8)], 1
        while 2 * w <= n:
            prev = rows[-1]
            rows.append(torch.maximum(prev[:-w], prev[w:]))
            w *= 2
        offs = np.cumsum([0] + [r.shape[0] for r in rows[:-1]])
        self.n = n
        self.flat = torch.cat(rows)
        self.offs = torch.as_tensor(offs, dtype=torch.int64, device=values.device)

    def query(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """max(values[lo:hi]) per pair as int32, -1 for an empty range."""
        ok = hi > lo
        if self.n == 0:
            return torch.full(lo.shape, -1, dtype=torch.int32, device=lo.device)
        lo_s = torch.where(ok, lo, 0)
        ln = torch.where(ok, hi - lo, 1)
        k = torch.log2(ln.to(torch.float64)).floor().to(torch.int64)
        one = torch.ones_like(k)
        k += ((one << (k + 1)) <= ln).long() - ((one << k) > ln).long()  # float rounding
        base = self.offs[k]
        a = self.flat[base + lo_s]
        b = self.flat[base + lo_s + ln - (one << k)]
        return torch.where(ok, torch.maximum(a, b).to(torch.int32), -1)

    def first_at_least(self, lo: torch.Tensor, hi: torch.Tensor,
                       value: torch.Tensor) -> torch.Tensor:
        """The first index j in [lo, hi) with values[j] >= value, for ranges
        that hold one (the first maximum, with `value` the range's max)."""
        a, b = lo + 1, hi.clone()
        for _ in range(max(self.n, 1).bit_length() + 1):
            mid = (a + b) >> 1
            ok = self.query(lo, mid) >= value
            b = torch.where(ok, mid, b)
            a = torch.where(ok, a, mid + 1)
        return b - 1


def lex_lt(t: torch.Tensor, k: torch.Tensor, bt: int, bk: int) -> torch.Tensor:
    """(t, k) lex-< (bt, bk), elementwise against one scalar pair."""
    return (t < bt) | ((t == bt) & (k < bk))


# ---------------------------------------------------------------- records
class FaceSweep(NamedTuple):
    """Result of the fused all-faces sweep, leading axis = face (nf = d + 1
    for simplices, 2d for hexes).

    neighbor  same-level neighbor per face: anchor (nf, n, d), level/stype
              (nf, n) — possibly outside the root (check `inside`)
    dual      (nf, n) int32 neighbor's face index back to us
    inside    (nf, n) bool inside-root mask
    key       (nf, n) int64 neighbor keys (of the neighbor as it is, inside
              the root or not: compare keys only where `inside`)
    """

    neighbor: Simplex
    dual: torch.Tensor
    inside: torch.Tensor
    key: torch.Tensor


class SweepHandle(NamedTuple):
    """One face sweep of an element layer, resident on the layer's device:
    target tree, neighbor key, validity (inside the root), dual face, each
    (nf, n) face-major, and the elements' levels (n,)."""

    n: int
    tgt: torch.Tensor
    key: torch.Tensor
    valid: torch.Tensor
    dual: torch.Tensor
    level: torch.Tensor


class LeafTable(NamedTuple):
    """A lex-sorted (tree, key, level) leaf table — the local leaves or the
    remote-leaf cache — on a device, with the range maximum of its levels."""

    n: int
    tree: torch.Tensor
    key: torch.Tensor
    level: torch.Tensor
    levmax: RangeMax


class RoutePairs(NamedTuple):
    """Compacted query candidates from `eval_route`: one host row per
    (face, element) pair whose neighbor key interval reaches outside the
    calling rank's partition, face-major, with the owner-rank range
    [first, last] of the interval."""

    tree: np.ndarray
    key: np.ndarray
    level: np.ndarray
    dual: np.ndarray
    first: np.ndarray
    last: np.ndarray


def _empty_route() -> RoutePairs:
    z = np.zeros(0, np.int32)
    return RoutePairs(z, np.zeros(0, np.int64), z.copy(), z.copy(), z.copy(), z.copy())


class BatchedOps:
    """Batched element ops over `Simplex` tensors of shape (n,), of one
    element class: every kernel wrapper is given the class, so a hex batch
    launches the hex bodies."""

    def __init__(self, d: int, eclass: int = ECLASS_SIMPLEX):
        self.d = d
        self.eclass = eclass
        self.ops = get_ops(d, eclass)
        self.nf = self.ops.nf

    def morton_key(self, s: Simplex) -> torch.Tensor:
        """Level-padded consecutive index (the mixed-level SFC sort key), int64."""
        _count("morton_key")
        return kops.morton_key(s.anchor, s.stype, self.eclass)

    def morton_key_np(self, s: Simplex) -> np.ndarray:
        """Host uint64 keys (the JAX package's forest key format)."""
        return to_u64(self.morton_key(s))

    def decode(self, key: torch.Tensor, level: torch.Tensor) -> Simplex:
        """Algorithm 4.8 from a level-padded key (inverse of `morton_key`)."""
        _count("decode")
        level = level.to(torch.int32)
        anchor, stype = kops.decode(self.d, key, level, self.eclass)
        return Simplex(anchor, level, stype)

    def parent(self, s: Simplex) -> Simplex:
        """Algorithm 4.3."""
        _count("parent")
        anchor, level, stype, _ = kops.parent(s.anchor, s.level, s.stype, self.eclass)
        return Simplex(anchor, level, stype)

    def parent_and_local_index(self, s: Simplex):
        """Algorithm 4.3 + Table 6 in one pass: (parent, TM child index) —
        the pair every family scan needs together."""
        _count("parent_and_local_index")
        anchor, level, stype, iloc = kops.parent(s.anchor, s.level, s.stype, self.eclass)
        return Simplex(anchor, level, stype), iloc

    def local_index(self, s: Simplex) -> torch.Tensor:
        """TM child index within the parent (paper Table 6): the index
        output of the `parent` kernel."""
        _count("local_index")
        return kops.parent(s.anchor, s.level, s.stype, self.eclass)[3]

    def children(self, s: Simplex) -> Simplex:
        """All 2^d children in TM order: batch shape (n, 2^d)."""
        _count("children")
        return Simplex(*kops.children(s.anchor, s.level, s.stype, self.eclass))

    def successor(self, s: Simplex) -> Simplex:
        """Batch Algorithm 4.10: the next same-level element along the curve
        (the last element of a level wraps to element 0)."""
        _count("successor")
        anchor, stype = kops.successor(s.anchor, s.level, s.stype, self.eclass)
        return Simplex(anchor, s.level, stype)

    def predecessor(self, s: Simplex) -> Simplex:
        """The previous same-level element (element 0 wraps to the last):
        the `morton_key` kernel, the key less one span at the element's
        level, the `decode` kernel.  The span, 2^63 at d = 3 and level 0,
        is never formed: key - (span - 1) - 1 stays within int64."""
        _count("predecessor")
        span1 = span_mask(self.d, self.ops.L, s.level)
        key = kops.morton_key(s.anchor, s.stype, self.eclass) & ~span1
        last = ((1 << (self.d * self.ops.L)) - 1) ^ span1       # the level's last key
        prev = torch.where(key == 0, last, key - span1 - 1)
        anchor, stype = kops.decode(self.d, prev, s.level, self.eclass)
        return Simplex(anchor, s.level, stype)

    def face_neighbor(self, s: Simplex, face):
        """Algorithm 4.6: (same-level neighbor, dual face) across `face`,
        one face for all elements or an int32 tensor of one per element.
        The neighbor may lie outside the root."""
        _count("face_neighbor")
        face = torch.as_tensor(face, device=s.device).to(torch.int32).expand(s.level.shape)
        face = face.contiguous()
        anchor, stype, dual = kops.face_neighbor(s.anchor, s.level, s.stype, face, self.eclass)
        return Simplex(anchor, s.level, stype), dual

    def owner_rank(self, tree: torch.Tensor, key: torch.Tensor, marker_tree: torch.Tensor,
                   marker_key: torch.Tensor) -> torch.Tensor:
        """The owner rank of each lex (tree, key) (int64 keys) against the
        P lex-sorted partition markers (`forest.partition_markers` as
        tensors, int64 keys), all on one device: the rank whose range
        [marker_r, marker_{r+1}) holds it, rank 0 for keys before the first
        marker.  (n,) int32 on that device (the JAX package's takes and
        gives host arrays)."""
        _count("owner_rank")
        return kops.owner_rank(tree.to(torch.int32).contiguous(), key.contiguous(),
                               marker_tree.to(torch.int32).contiguous(),
                               marker_key.contiguous(), self.eclass)

    def face_sweep(self, s: Simplex) -> FaceSweep:
        """Fused all-faces sweep: (face_neighbor, is_inside_root,
        morton_key) for every one of the class's nf faces in ONE kernel
        launch, face-major."""
        _count("face_sweep")
        anchor, stype, dual, inside, key = kops.face_sweep(s.anchor, s.level, s.stype,
                                                           self.eclass)
        level = s.level.expand(anchor.shape[0], -1)
        return FaceSweep(Simplex(anchor, level, stype), dual, inside, key)

    def is_inside_root(self, s: Simplex) -> torch.Tensor:
        """Section 4.4 inside-root test (Proposition 23 vs the root simplex;
        box containment in the root cube for hexes)."""
        _count("is_inside_root")
        return kops.inside_root(s.anchor, s.level, s.stype, self.eclass)

    def tree_transform(self, s: Simplex, M, c, typemap) -> Simplex:
        """Cross-tree coordinate change under one connection (the
        `core.cmesh` gluing map): anchor' = M @ anchor + c with the
        reflected-axis correction, type through `typemap`; the translation
        is carried modulo 2^32 (`cmesh.wrap_i32`).  The `tree_transform`
        kernel with a one-row connection table."""
        table = torch.as_tensor(pack_connection(self.d, M, c, typemap, eclass=self.eclass),
                                device=s.device).reshape(1, -1)
        zero = torch.zeros_like(s.level)
        return self.transform_crossings(zero, s, zero, table)[0]

    def transform_crossings(self, conn: torch.Tensor, s: Simplex, dual: torch.Tensor,
                            table: torch.Tensor):
        """ONE `tree_transform` launch for face crossings of any mix of
        connections: element i (a same-level neighbor just outside its root)
        crosses by row conn[i] of the packed connection table (rows of this
        class).  Returns (the elements in the neighbor trees' frames, their
        dual faces there, the neighbor trees)."""
        _count("tree_transform")
        anchor, stype, dual2, tree = kops.tree_transform(
            conn.to(torch.int32), s.anchor, s.level, s.stype, dual, table, self.eclass)
        return Simplex(anchor, s.level, stype), dual2, tree

    # -- fused Balance/Ghost eval stage --------------------------------------
    def sweep_full(self, s: Simplex, tree_ids: torch.Tensor) -> SweepHandle | None:
        """Face-sweep an element layer and keep the result resident: ONE
        `face_sweep` launch; the eval programs read the handle and only
        their compacted results reach the host."""
        n = int(s.level.shape[0])
        if n == 0:
            return None
        _count("face_sweep")
        _anchor, _stype, dual, inside, key = kops.face_sweep(s.anchor, s.level, s.stype,
                                                             self.eclass)
        tgt = tree_ids.to(torch.int32).expand(key.shape[0], -1).contiguous()
        return SweepHandle(n, tgt, key, inside, dual, s.level)

    def sweep_from_layer(self, tgt, nkey, valid, dual, level) -> SweepHandle | None:
        """A resident handle over a face sweep layer
        (`forest.face_sweep_layer`, its crossings carried across the tree
        faces over a coarse mesh): the JAX package's `sweep_from_host`, but
        the layer never left the device, so nothing is uploaded and no
        dispatch is counted (the layer's sweep was)."""
        n = int(level.shape[0])
        if n == 0:
            return None
        return SweepHandle(n, tgt.to(torch.int32).contiguous(), nkey, valid, dual, level)

    def upload_table(self, tree, keys, level, device=None) -> LeafTable | None:
        """A lex-sorted (tree, key, level) leaf table on `device` (the
        tensors' own by default; host arrays need it), with its range
        maximum; None for an empty table (callers skip the eval)."""
        n = len(level)
        if n == 0:
            return None
        tree, keys, level = (torch.as_tensor(x, device=device) for x in (tree, keys, level))
        level = level.to(torch.int32)
        return LeafTable(n, tree.to(torch.int64), keys.to(torch.int64), level,
                         RangeMax(level))

    def _finer(self, sw: SweepHandle, table: LeafTable, kend: torch.Tensor) -> torch.Tensor:
        """(nf, n): does the table hold a leaf more than one level finer than
        the element inside the neighbor's interval [key, kend]?"""
        lo = lex_search(table.tree, table.key, sw.tgt, sw.key)
        hi = lex_search(table.tree, table.key, sw.tgt, kend, right=True)
        return table.levmax.query(lo, hi) > (sw.level + 1)[None, :]

    def _off(self, sw: SweepHandle, kend: torch.Tensor, mt, mk, g: int) -> torch.Tensor:
        """(nf, n): the neighbor interval escapes rank g's partition range
        [marker_g, marker_{g+1}) — lex below the lower marker, or its last
        key at or above the upper one."""
        P = len(mt)
        off = torch.zeros(sw.key.shape, dtype=torch.bool, device=sw.key.device)
        if g > 0:
            off |= lex_lt(sw.tgt, sw.key, int(mt[g]), int(mk[g]))
        if g + 1 < P:
            off |= ~lex_lt(sw.tgt, kend, int(mt[g + 1]), int(mk[g + 1]))
        return off

    def _kend(self, sw: SweepHandle) -> torch.Tensor:
        return sw.key | span_mask(self.d, self.ops.L, sw.level)[None, :]

    def eval_2to1(self, sw: SweepHandle | None, table: LeafTable | None, mt, mk, g: int):
        """Fused interior 2:1 eval: (need, boundary) host element masks from
        one resident sweep against the local leaf table — one fetch."""
        if sw is None or sw.n == 0:
            z = np.zeros(0, bool)
            return z, z.copy()
        _count("eval_2to1")
        kend = self._kend(sw)
        bmask = (sw.valid & self._off(sw, kend, mt, mk, g)).any(dim=0)
        if table is None:
            need = torch.zeros_like(bmask)
        else:
            need = (sw.valid & self._finer(sw, table, kend)).any(dim=0)
        out = _fetch("eval_2to1", torch.stack([need, bmask]))
        return out[0].copy(), out[1].copy()

    def eval_cache(self, sw: SweepHandle | None, cache: LeafTable | None, mt, mk,
                   g: int) -> np.ndarray:
        """Fused remote-cache 2:1 eval: need mask of the boundary-adjacent
        elements against the cache of remote leaves — one fetch."""
        if sw is None or sw.n == 0 or cache is None:
            return np.zeros(0 if sw is None else sw.n, bool)
        _count("eval_cache")
        kend = self._kend(sw)
        bmask = (sw.valid & self._off(sw, kend, mt, mk, g)).any(dim=0)
        need = (sw.valid & bmask[None, :] & self._finer(sw, cache, kend)).any(dim=0)
        return _fetch("eval_cache", need)

    def eval_route(self, sw: SweepHandle | None, mt, mk, g: int) -> RoutePairs:
        """Fused boundary routing: the `eval_route` kernel's interval ends
        and owner ranges, then the (face, element) pairs whose interval
        reaches outside rank g's partition, compacted face-major — one
        fetch of (tree, key, level, dual, first, last) rows."""
        if sw is None or sw.n == 0:
            return _empty_route()
        _count("eval_route")
        dev = sw.key.device
        mt_t = torch.as_tensor(np.asarray(mt, np.int32), device=dev)
        mk_t = torch.as_tensor(np.asarray(mk, np.uint64).astype(np.int64), device=dev)
        _kend, first, last = kops.eval_route(self.d, sw.tgt, sw.key, sw.level, mt_t, mk_t)
        remote = sw.valid & ((first != g) | (last != g))
        idx = torch.nonzero(remote.reshape(-1)).squeeze(1)
        e = idx % sw.n
        rows = torch.stack([sw.tgt.reshape(-1)[idx].long(), sw.key.reshape(-1)[idx],
                            sw.level[e].long(), sw.dual.reshape(-1)[idx].long(),
                            first.reshape(-1)[idx].long(), last.reshape(-1)[idx].long()], 1)
        rows = _fetch("eval_route", rows)
        i32 = rows.astype(np.int32)
        return RoutePairs(i32[:, 0].copy(), rows[:, 1].copy(), i32[:, 2].copy(),
                          i32[:, 3].copy(), i32[:, 4].copy(), i32[:, 5].copy())


_BOPS: dict = {}


def get_batch_ops(d: int, eclass: int = ECLASS_SIMPLEX) -> BatchedOps:
    """The batched element ops for dimension `d` and element class `eclass`."""
    b = _BOPS.get((d, eclass))
    if b is None:
        b = _BOPS[(d, eclass)] = BatchedOps(d, eclass)
    return b
