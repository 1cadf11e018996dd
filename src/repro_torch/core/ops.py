"""Element algorithms of the tetrahedral SFC over batches of tensors.

The plain PyTorch counterpart of the JAX package's `repro.core.ops`, for
what the New -> Adapt -> Partition path calls:

  cube_id       Algorithm 4.2
  parent        Algorithm 4.3
  child_tm      Algorithm 4.5  (TM order; `children_tm` for all 2^d)
  local_index   paper Table 6
  morton_key    level-padded consecutive index (Algorithm 4.7)
  decode_key    Algorithm 4.8 from a level-padded key
  coordinates   Algorithm 4.1, in the root frame
  face_neighbor Algorithm 4.6
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
        """Algorithm 4.1: (..., d+1, d) int32 corner nodes.  Elements of the
        root frame only: the vertices of an element inside the root fit
        int32 (the cross-tree vertex wrap comes with the coarse mesh)."""
        verts = self._tab("ref_verts", s.device)[s.stype.long()].to(torch.int32)
        return s.anchor[..., None, :] + self.h(s.level)[..., None, None] * verts

    # ------------------------------------------------------------- hierarchy
    def parent(self, s: Simplex) -> Simplex:
        """Algorithm 4.3."""
        h = self.h(s.level)
        cid = self.cube_id(s)
        anchor = s.anchor & ~h[..., None]
        return Simplex(anchor, s.level - 1, self._lookup("parent_type", cid, s.stype))

    def child_tm(self, s: Simplex, iloc: int) -> Simplex:
        """Algorithm 4.5: the iloc-th child in TM (SFC) order."""
        h2 = self.h(s.level) >> 1
        il = torch.full_like(s.stype, iloc)
        cid = self._lookup("cube_id_of_local", s.stype, il)
        anchor = s.anchor + h2[..., None] * self._cid_bits(cid)
        return Simplex(anchor, s.level + 1, self._lookup("type_of_local", s.stype, il))

    def local_index(self, s: Simplex) -> torch.Tensor:
        """Paper Table 6: the TM child index of s within its parent."""
        return self._lookup("local_index", self.cube_id(s), s.stype)

    # ------------------------------------------------------------- neighbors
    def face_neighbor(self, s: Simplex, f: int):
        """Algorithm 4.6: (same-level neighbor across face f, dual face).
        The neighbor may lie outside the root simplex (`is_inside_root`)."""
        dev = s.device
        fi = torch.full_like(s.stype, f)
        off = self._tab("neighbor_offset", dev)[s.stype.long(), f].to(torch.int32)
        anchor = s.anchor + self.h(s.level)[..., None] * off
        return (Simplex(anchor, s.level, self._lookup("neighbor_type", s.stype, fi)),
                self._lookup("neighbor_face", s.stype, fi))

    # ------------------------------------------------- ancestors / containment
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
