"""Element algorithms of the tetrahedral SFC over batches of tensors.

The plain PyTorch counterpart of the JAX package's `repro.core.ops`, for
what the New -> Adapt -> Partition path calls:

  cube_id       Algorithm 4.2
  parent        Algorithm 4.3
  child_bey     Algorithm 4.4  (Bey order)
  child_tm      Algorithm 4.5  (TM order; `children_tm` for all 2^d)
  local_index   paper Table 6
  linear_id     Algorithm 4.7  (consecutive index at the element's level)
  morton_key    level-padded consecutive index
  from_linear_id / decode_key   Algorithm 4.8
  successor / predecessor       Algorithm 4.10, wrapping within the level
  sfc_less      the SFC order across levels
  coordinates   Algorithm 4.1
  face_neighbor Algorithm 4.6
  tree_transform  the coarse-mesh gluing map (cmesh)
  ancestor_at_level / nearest_common_ancestor
  is_ancestor   Proposition 23
  is_inside_root  Section 4.4

Every method works on the tensors' own device: the lookup tables are copied
to each device once.  Keys are int64 (see `core.keys`).  These are the plain
versions that `kernels.ref` delegates to and that the CUDA kernels are held
against.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import not_ported
from .tables import MAXLEVEL, get_tables
from .types import ECLASS_HEX, ECLASS_SIMPLEX, Simplex

__all__ = ["ElementOps", "SimplexOps", "get_ops"]


def _wrap_i32(a: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap of an int64 tensor (the JAX package's
    `cmesh.wrap_i32`, on tensors)."""
    return (((a + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _i64(x, device) -> torch.Tensor:
    """An array, tensor or nested list as an int64 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


class ElementOps:
    """Element algorithms bound to (dimension, element class).

    A concrete class supplies `eclass`, `nt` (types), `nc` (children) and the
    primitive algorithms; the level and key arithmetic shared by every class
    lives here."""

    d: int
    L: int
    eclass: int
    nt: int
    nc: int

    def h(self, level: torch.Tensor) -> torch.Tensor:
        """Cube side length at `level` (int32)."""
        return torch.bitwise_left_shift(torch.ones_like(level), self.L - level)

    def cube_id(self, s: Simplex, level: int | None = None) -> torch.Tensor:
        """Algorithm 4.2: cube-id of the level-`level` ancestor's cube (of
        the element's own level when `level` is None)."""
        if level is None:
            bits = torch.bitwise_right_shift(s.anchor, (self.L - s.level)[..., None]) & 1
        else:
            bits = (s.anchor >> (self.L - level)) & 1
        cid = bits[..., 0]
        for k in range(1, self.d):
            cid = cid | (bits[..., k] << k)
        return cid

    def _per_element(self, x, s: Simplex) -> torch.Tensor:
        """An int or a tensor of one value per element, as an int32 tensor
        of the batch shape on the elements' device."""
        return torch.as_tensor(x, device=s.device).to(torch.int32).expand(s.stype.shape)

    def sibling_tm(self, s: Simplex, iloc) -> Simplex:
        """The iloc-th TM child of s's parent."""
        return self.child_tm(self.parent(s), iloc)

    def children_tm(self, s: Simplex) -> Simplex:
        """All 2^d children in SFC order: batch shape (..., 2^d)."""
        kids = [self.child_tm(s, i) for i in range(self.nc)]
        return Simplex(
            torch.stack([k.anchor for k in kids], dim=-2),
            torch.stack([k.level for k in kids], dim=-1),
            torch.stack([k.stype for k in kids], dim=-1),
        )

    def num_elements(self, level) -> int:
        """Elements in a uniform refinement of one tree: 2^(d*level)."""
        return 1 << (self.d * int(level))

    def decode_key(self, key: torch.Tensor, level: torch.Tensor) -> Simplex:
        """Inverse of `morton_key` at a given level: drop the digits below
        the level and run Algorithm 4.8."""
        shift = (self.L - level.to(torch.int64)) * self.d
        return self.from_linear_id(torch.bitwise_right_shift(key, shift), level)

    # ------------------------------------------------------------ linear ids
    def linear_id(self, s: Simplex) -> torch.Tensor:
        """Algorithm 4.7: the consecutive index of s at its own level, int64."""
        shift = (self.L - s.level.to(torch.int64)) * self.d
        return torch.bitwise_right_shift(self.morton_key(s), shift)

    def _last_id(self, level: torch.Tensor) -> torch.Tensor:
        """2^(d*level) - 1, the last consecutive index of a level, int64 (at
        most 2^63 - 1: d*L <= 63)."""
        e = (self.d * level.to(torch.int64)).clamp(0, 63)
        return torch.bitwise_right_shift(torch.full_like(e, (1 << 63) - 1), 63 - e)

    def successor(self, s: Simplex) -> Simplex:
        """The next element of s's level along the curve (batch Algorithm
        4.10); the last element's successor is element 0, as in the JAX
        package.  The index is never incremented past 2^63 - 1."""
        lid, last = self.linear_id(s), self._last_id(s.level)
        nxt = torch.where(lid == last, 0, torch.minimum(lid, last - 1) + 1)
        return self.from_linear_id(nxt, s.level)

    def predecessor(self, s: Simplex) -> Simplex:
        """The previous element of s's level; element 0's is the last."""
        lid = self.linear_id(s)
        return self.from_linear_id(torch.where(lid == 0, self._last_id(s.level), lid - 1),
                                   s.level)

    def sfc_less(self, a: Simplex, b: Simplex) -> torch.Tensor:
        """Strict SFC order across mixed levels: ancestors precede
        descendants (Theorem 16 (i))."""
        ka, kb = self.morton_key(a), self.morton_key(b)
        return (ka < kb) | ((ka == kb) & (a.level < b.level))


class SimplexOps(ElementOps):
    """The paper's tetrahedral-Morton algorithms for d-simplices (d = 2, 3)."""

    eclass = ECLASS_SIMPLEX

    def __init__(self, d: int):
        self.d = d
        self.t = get_tables(d)
        self.L = MAXLEVEL[d]
        self.nt = self.t.num_types          # d!
        self.nc = self.t.num_children       # 2^d
        self.nf = d + 1                     # faces per simplex
        # face f is the face opposite corner f
        self.face_corner_indices = np.asarray(
            [[a for a in range(d + 1) if a != f] for f in range(d + 1)], np.int32)
        self._dev_tables: dict = {}

    def _tab(self, name: str, device) -> torch.Tensor:
        """Table `name` of `tables.SFCTables` as an int64 tensor on `device`."""
        key = (name, torch.device(device))
        t = self._dev_tables.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self.t, name), dtype=torch.int64, device=device)
            self._dev_tables[key] = t
        return t

    def _lookup(self, name: str, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        """table[row, col] as int32, gathered on the indices' device."""
        tab = self._tab(name, row.device)
        return tab[row.long(), col.long()].to(torch.int32)

    def _cid_bits(self, cid: torch.Tensor) -> torch.Tensor:
        """(..., d) 0/1 anchor offsets of a cube-id."""
        return torch.stack([(cid >> k) & 1 for k in range(self.d)], dim=-1)

    def coordinates(self, s: Simplex) -> torch.Tensor:
        """Algorithm 4.1: (..., d+1, d) int32 corner nodes, computed in
        int32 as the JAX package computes them: a vertex past 2^31 - 1 (a
        transformed element's at d = 2) wraps as it does there."""
        verts = self._tab("ref_verts", s.device)[s.stype.long()].to(torch.int32)
        return s.anchor[..., None, :] + self.h(s.level)[..., None, None] * verts

    # ------------------------------------------------------------- hierarchy
    def parent(self, s: Simplex) -> Simplex:
        """Algorithm 4.3."""
        h = self.h(s.level)
        cid = self.cube_id(s)
        anchor = s.anchor & ~h[..., None]
        return Simplex(anchor, s.level - 1, self._lookup("parent_type", cid, s.stype))

    def child_bey(self, s: Simplex, i) -> Simplex:
        """Algorithm 4.4: the i-th child in Bey's order (eq. 2); `i` one
        index for all elements or a tensor of one per element."""
        ib = self._per_element(i, s)
        h2 = self.h(s.level) >> 1
        off = self._tab("child_anchor", s.device)[s.stype.long(), ib.long()].to(torch.int32)
        return Simplex(s.anchor + h2[..., None] * off, s.level + 1,
                       self._lookup("child_type", s.stype, ib))

    def child_tm(self, s: Simplex, iloc) -> Simplex:
        """Algorithm 4.5: the iloc-th child in TM (SFC) order; `iloc` one
        index for all elements or a tensor of one per element."""
        h2 = self.h(s.level) >> 1
        il = self._per_element(iloc, s)
        cid = self._lookup("cube_id_of_local", s.stype, il)
        anchor = s.anchor + h2[..., None] * self._cid_bits(cid)
        return Simplex(anchor, s.level + 1, self._lookup("type_of_local", s.stype, il))

    def local_index(self, s: Simplex) -> torch.Tensor:
        """Paper Table 6: the TM child index of s within its parent."""
        return self._lookup("local_index", self.cube_id(s), s.stype)

    # ------------------------------------------------------------- neighbors
    def face_neighbor(self, s: Simplex, f):
        """Algorithm 4.6: (same-level neighbor across face f, dual face);
        `f` is one face for all elements or a tensor of one per element.
        The neighbor may lie outside the root simplex (`is_inside_root`)."""
        fi = self._per_element(f, s)
        off = self._tab("neighbor_offset", s.device)[s.stype.long(), fi.long()].to(torch.int32)
        anchor = s.anchor + self.h(s.level)[..., None] * off
        return (Simplex(anchor, s.level, self._lookup("neighbor_type", s.stype, fi)),
                self._lookup("neighbor_face", s.stype, fi))

    def tree_transform(self, s: Simplex, M, c, typemap) -> Simplex:
        """The coarse-mesh gluing map: anchor' = M @ anchor + c, less h on
        reflected rows so the anchor stays the image cube's minimum corner,
        and type' = typemap[type].  `M` is a signed permutation, (d, d) or
        per element (..., d, d); `c` the translation, pre-wrapped to int32,
        (d,) or (..., d); `typemap` (d!,) or (..., d!).  Computed in int64
        and wrapped to int32 once, which equals int32 ring arithmetic."""
        M, c, tm = (_i64(x, s.device) for x in (M, c, typemap))
        h = self.h(s.level).to(torch.int64)
        neg = M.sum(dim=-1).clamp(max=0)                   # -1 on reflected rows
        a = (s.anchor.to(torch.int64)[..., None, :] * M).sum(dim=-1) + c + h[..., None] * neg
        tm = tm.expand(s.stype.shape + tm.shape[-1:])
        stype = torch.gather(tm, -1, s.stype.long()[..., None])[..., 0]
        return Simplex(_wrap_i32(a), s.level, stype.to(torch.int32))

    # ------------------------------------------------- ancestors / containment
    def ancestor_at_level(self, s: Simplex, level) -> Simplex:
        """The ancestor of s at `level` (<= s.level; one level for all
        elements or one per element), by the walk from MAXLEVEL: below
        s.level the anchor bits are zero, so cube-id 0 keeps the type."""
        level = self._per_element(level, s)
        b = s.stype
        out_type = torch.where(level == s.level, s.stype, 0)
        for i in range(self.L, 0, -1):
            cid = self.cube_id(s, i)
            b = torch.where(i > s.level, b, self._lookup("parent_type", cid, b))
            out_type = torch.where(level == i - 1, b, out_type)
        mask = ~(self.h(level) - 1)
        return Simplex(s.anchor & mask[..., None], level, out_type)

    def nearest_common_ancestor(self, a: Simplex, b: Simplex) -> Simplex:
        """The deepest common ancestor, by the embedding Phi (Prop. 17): the
        deepest common prefix of the (cube-id, type) chains."""
        ca, ta = self._type_chain(a)
        cb, tb = self._type_chain(b)
        agree = torch.ones(torch.broadcast_shapes(a.level.shape, b.level.shape),
                           dtype=torch.bool, device=a.device)
        nca_level = torch.zeros_like(a.level)
        for i in range(1, self.L + 1):
            ok = (ca[i] == cb[i]) & (ta[i] == tb[i]) & (i <= a.level) & (i <= b.level)
            agree = agree & ok
            nca_level = torch.where(agree, i, nca_level)
        return self.ancestor_at_level(a, nca_level)

    def is_ancestor(self, t: Simplex, n: Simplex) -> torch.Tensor:
        """Proposition 23 (constant time): True where t is an ancestor of n
        (t == n included).  Shapes must broadcast."""
        dev = n.device
        ht = self.h(t.level)
        rel = n.anchor - t.anchor
        p = self._tab("outside_perm", dev)[t.stype.long()]          # (..., d)
        rel, p = torch.broadcast_tensors(rel, p)
        a = torch.gather(rel, -1, p)
        ai, aj = a[..., 0], a[..., 1]
        same = (t.level == n.level) & (ai == 0) & (aj == 0)
        if self.d == 3:
            same = same & (a[..., 2] == 0)
        same = same & (t.stype == n.stype)
        deeper = n.level > t.level

        def ok(name):
            return self._lookup(name, t.stype, n.stype) == 0

        if self.d == 2:
            inside = (aj >= 0) & (ai < ht) & (aj <= ai)
            inside = inside & ((aj != ai) | ok("outside_types_kj"))
        else:
            ak = a[..., 2]
            inside = (aj >= 0) & (ai < ht) & (ak <= ai) & (aj <= ak)
            eq_ik, eq_kj = ak == ai, aj == ak
            good = torch.where(eq_ik & eq_kj, ok("outside_types_diag"),
                               torch.where(eq_ik, ok("outside_types_ik"),
                                           torch.where(eq_kj, ok("outside_types_kj"), True)))
            inside = inside & good
        return same | (deeper & inside)

    def is_inside_root(self, s: Simplex) -> torch.Tensor:
        """Section 4.4: does s lie inside the root simplex T_d^0?"""
        root = Simplex(torch.zeros_like(s.anchor), torch.zeros_like(s.level),
                       torch.zeros_like(s.stype))
        return self.is_ancestor(root, s) & (s.level >= 0)

    # ------------------------------------------------------------ linear ids
    def _type_chain(self, s: Simplex):
        """Cube-ids and types of the ancestors T^i, i = 1..MAXLEVEL (T_0-chain
        padded below s.level): two lists indexed by level, entry 0 None."""
        cids = [None] * (self.L + 1)
        types = [None] * (self.L + 1)
        b = s.stype
        for i in range(self.L, 0, -1):
            cid = self.cube_id(s, i)
            cids[i], types[i] = cid, b
            b = torch.where(i > s.level, b, self._lookup("parent_type", cid, b))
        return cids, types

    def morton_key(self, s: Simplex) -> torch.Tensor:
        """Level-padded consecutive index I(s) << d*(MAXLEVEL - level), int64.

        Walks the (cube-id, type) chain from MAXLEVEL up; below s.level the
        anchor bits are zero, so the chain keeps the type there (the T_0-chain
        padding of the paper)."""
        b = s.stype
        key = torch.zeros(s.level.shape, dtype=torch.int64, device=s.device)
        for i in range(self.L, 0, -1):
            cid = self.cube_id(s, i)
            iloc = self._lookup("local_index", cid, b)
            key = key | (iloc.to(torch.int64) << (self.d * (self.L - i)))
            b = torch.where(i > s.level, b, self._lookup("parent_type", cid, b))
        return key

    def from_linear_id(self, index: torch.Tensor, level: torch.Tensor) -> Simplex:
        """Algorithm 4.8: the simplex from a consecutive index + level."""
        shape = torch.broadcast_shapes(index.shape, level.shape)
        level = level.to(torch.int32).expand(shape)
        key = torch.bitwise_left_shift(
            index.expand(shape), (self.L - level.to(torch.int64)) * self.d)
        anchor = torch.zeros(shape + (self.d,), dtype=torch.int32, device=index.device)
        b = torch.zeros(shape, dtype=torch.int32, device=index.device)
        mask = self.nc - 1
        for i in range(1, self.L + 1):
            iloc = ((key >> (self.d * (self.L - i))) & mask).to(torch.int32)
            cid = self._lookup("cube_id_of_local", b, iloc)
            anchor = anchor | (self._cid_bits(cid) << (self.L - i))
            b = self._lookup("type_of_local", b, iloc)
        return Simplex(anchor, level, b)


_OPS: dict = {}


def get_ops(d: int, eclass: int = ECLASS_SIMPLEX) -> ElementOps:
    """The element ops of dimension `d` and class `eclass` (simplices; the
    hex class is not ported yet)."""
    if eclass == ECLASS_HEX:
        raise not_ported("the hex element class", "hex")
    if eclass != ECLASS_SIMPLEX or d not in (2, 3):
        raise ValueError(f"no element ops for d={d}, eclass={eclass}")
    o = _OPS.get(d)
    if o is None:
        o = _OPS[d] = SimplexOps(d)
    return o
