"""Coarse meshes: K root simplices glued face to face (the counterpart of
the JAX package's `repro.core.cmesh`).

Every tree's local frame is the reference root simplex S_0 at scale
2^MAXLEVEL.  A gluing between two trees is an affine automorphism of the
Freudenthal (Kuhn) complex, x -> M @ x + c, with M a global-sign signed
permutation and c an integer translation.  The per-connection tables (type
map, vertex/face map) are derived by transforming the reference simplices
and matching them again, never typed in.

The tables are host numpy arrays built once, at construction, with the
same shapes, dtypes and values as the JAX package's (simplex trees only:
the hex and hybrid constructors come with port slice 4).  For the forest's
crossing fix-up each `Cmesh` keeps one device copy of its gluing tables per
device (`gluing`): the neighbor-tree column for the connected-face test and
one packed row per (tree, root face) that the `tree_transform` kernel reads.

Constructors: `cmesh_single`, `cmesh_disconnected`, `cmesh_unit_cube`,
`cmesh_brick` (periodic per axis too) and `cmesh_rotated_pair`.  The
construction-time proofs of `_check_connectivity` (every gluing involutive,
and mapping the level-0 outside neighbor onto the neighbor tree's root) run
on every constructed mesh.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .errors import not_ported
from .ops import get_ops
from .tables import MAXLEVEL, get_tables, root_face_planes
from .types import ECLASS_SIMPLEX, Simplex

__all__ = [
    "Cmesh",
    "GluingTables",
    "CMESH_FIELDS",
    "cmesh_single",
    "cmesh_disconnected",
    "cmesh_unit_cube",
    "cmesh_brick",
    "cmesh_rotated_pair",
    "signed_perm_maps",
    "conn_row_width",
    "pack_connection",
    "wrap_i32",
]

# The fields of a `Cmesh`, those of the JAX package's, in its order.
CMESH_FIELDS = ("d", "num_trees", "face_tree", "face_face", "face_M", "face_c",
                "face_typemap", "face_facemap", "tree_embed_M", "tree_embed_o",
                "tree_eclass")


def wrap_i32(a) -> np.ndarray:
    """Two's-complement int32 wrap of an int64 array.

    Gluing translations reach 2 * 2^MAXLEVEL (2^31 at d = 2), one past the
    int32 range; every valid transformed anchor lands back in
    [0, 2^MAXLEVEL), so doing the transform arithmetic modulo 2^32 is
    exact."""
    a = np.asarray(a, np.int64)
    return ((a + 2**31) % 2**32 - 2**31).astype(np.int32)


# ------------------------------------------------------------ derived pieces
@lru_cache(maxsize=None)
def _signed_perm_maps_cached(d: int, M_key: tuple) -> tuple:
    t = get_tables(d)
    nt = t.num_types
    M = np.asarray(M_key, np.int64)
    typemap = np.zeros(nt, np.int32)
    vertmap = np.zeros((nt, d + 1), np.int32)
    refs = [[tuple(r) for r in t.ref_verts[b].astype(np.int64).tolist()] for b in range(nt)]
    for b in range(nt):
        W = t.ref_verts[b].astype(np.int64) @ M.T
        # every type holds the cube's main diagonal, so the minimum over the
        # image's vertices is the image cube's anchor
        rel = [tuple(r) for r in (W - W.min(axis=0)).tolist()]
        for b2 in range(nt):
            if set(rel) == set(refs[b2]):
                typemap[b] = b2
                for a in range(d + 1):
                    vertmap[b, a] = refs[b2].index(rel[a])
                break
        else:
            raise ValueError(
                f"linear part {M.tolist()} is not an automorphism of the "
                f"Freudenthal complex (d={d}); only global-sign signed "
                "permutations are admissible")
    return typemap, vertmap


def signed_perm_maps(d: int, M) -> tuple[np.ndarray, np.ndarray]:
    """(typemap, vertmap) of the complex automorphism with linear part `M`:
    typemap[b] is the type of the image of a type-b simplex, and
    vertmap[b, a] the vertex of the image (in its reference numbering) that
    vertex a maps to — face f lies opposite vertex f, so this is also the
    face map.  Raises ValueError where `M` does not preserve the Kuhn
    triangulation."""
    M = np.asarray(M, np.int64)
    tm, vm = _signed_perm_maps_cached(d, tuple(map(tuple, M.tolist())))
    return tm.copy(), vm.copy()


def _is_signed_perm(d: int, M: np.ndarray) -> bool:
    """Signed permutation test: one nonzero entry, +-1, per row and column."""
    M = np.asarray(M, np.int64)
    return (M.shape == (d, d)
            and np.array_equal(np.abs(M).sum(axis=0), np.ones(d, np.int64))
            and np.array_equal(np.abs(M).sum(axis=1), np.ones(d, np.int64))
            and bool(np.isin(M, (-1, 0, 1)).all()))


def _perm_matrix_for_type(d: int, b: int) -> np.ndarray:
    """The unique permutation matrix mapping S_0 onto S_b (permutations act
    simply transitively on the Kuhn simplices of a cube)."""
    t = get_tables(d)
    target = set(map(tuple, t.ref_verts[b].astype(np.int64).tolist()))
    for perm in itertools.permutations(range(d)):
        P = np.zeros((d, d), np.int64)
        for a, pa in enumerate(perm):
            P[pa, a] = 1
        img = set(tuple(v) for v in (t.ref_verts[0].astype(np.int64) @ P.T).tolist())
        if img == target:
            return P
    raise ValueError(f"no permutation maps S_0 to S_{b} (d={d})")


# ------------------------------------------------- packed connection rows
def conn_row_width(d: int) -> int:
    """Width of one packed connection row: d axis codes, d translations,
    d! type-map and d!(d+1) face-map entries, and the neighbor tree."""
    nt = math.factorial(d)
    return 2 * d + nt + nt * (d + 1) + 1


def pack_connection(d: int, M, c, typemap, facemap=None, tree: int = 0) -> np.ndarray:
    """One int32 row of the table the `tree_transform` kernel reads:

      [k]                       source axis of output axis k, | 4 if reflected
      [d + k]                   c[k], wrapped to int32
      [2d + b]                  typemap[b]
      [2d + d! + b (d+1) + f]   facemap[b, f] (identity when not given)
      [-1]                      the neighbor tree

    `M` must be a signed permutation (ValueError otherwise)."""
    M = np.asarray(M, np.int64)
    if not _is_signed_perm(d, M):
        raise ValueError(f"gluing linear part {M.tolist()} is not a signed permutation")
    nt, nf = math.factorial(d), d + 1
    if facemap is None:
        facemap = np.tile(np.arange(nf, dtype=np.int32), (nt, 1))
    row = np.zeros(conn_row_width(d), np.int32)
    for k in range(d):
        ax = int(np.nonzero(M[k])[0][0])
        row[k] = ax | (4 if M[k, ax] < 0 else 0)
    row[d:2 * d] = wrap_i32(c)
    row[2 * d:2 * d + nt] = np.asarray(typemap, np.int32)
    row[2 * d + nt:2 * d + nt + nt * nf] = np.asarray(facemap, np.int32).reshape(-1)
    row[-1] = tree
    return row


class GluingTables(NamedTuple):
    """A coarse mesh's gluing tables on one device: `face_tree` (K, d+1)
    int32 (-1 at the domain boundary) and `conn` (K (d+1), W) int32, the
    packed row of connection tree * (d+1) + root face (`pack_connection`)."""

    face_tree: torch.Tensor
    conn: torch.Tensor


# ------------------------------------------------------------------- Cmesh
@dataclasses.dataclass(eq=False)
class Cmesh:
    """K root simplices with per-face (neighbor tree, neighbor face, gluing
    transform) tables, all in each tree's local frame (root = S_0 at scale
    2^MAXLEVEL).

    face_tree[t, f] is -1 where face f of tree t is a domain boundary;
    otherwise (face_M, face_c) map tree-t coordinates into the neighbor
    tree's frame.  Host numpy tables, as the JAX package holds them."""

    d: int
    num_trees: int
    face_tree: np.ndarray      # (K, d+1) int32, -1 = domain boundary
    face_face: np.ndarray      # (K, d+1) int32, neighbor's face index
    face_M: np.ndarray         # (K, d+1, d, d) int32 gluing linear part
    face_c: np.ndarray         # (K, d+1, d) int64 gluing translation (scale 2^L)
    face_typemap: np.ndarray   # (K, d+1, d!) int32 type map under face_M
    face_facemap: np.ndarray   # (K, d+1, d!, d+1) int32 vertex/face map
    tree_embed_M: np.ndarray   # (K, d, d) int32 world embedding linear part
    tree_embed_o: np.ndarray   # (K, d) int64 world cube offset (unit scale)
    tree_eclass: np.ndarray = None  # (K,) int32 element class per tree

    def __post_init__(self):
        if self.tree_eclass is None:
            self.tree_eclass = np.zeros(self.num_trees, np.int32)
        else:
            self.tree_eclass = np.asarray(self.tree_eclass, np.int32)
        if (self.tree_eclass != ECLASS_SIMPLEX).any():
            raise not_ported("a coarse mesh with hex trees", "hex")
        self._gluing: dict = {}

    @property
    def L(self) -> int:
        return MAXLEVEL[self.d]

    def is_connected(self, tree: int, root_face: int) -> bool:
        """True where `root_face` of `tree` is an inter-tree face (False =
        domain boundary)."""
        return bool(self.face_tree[tree, root_face] >= 0)

    def gluing(self, device) -> GluingTables:
        """The device copy of the gluing tables, made once per device."""
        dev = torch.device(device)
        g = self._gluing.get(dev)
        if g is None:
            d, nf = self.d, self.d + 1
            rows = np.stack([
                pack_connection(d, self.face_M[t, f], self.face_c[t, f],
                                self.face_typemap[t, f], self.face_facemap[t, f],
                                max(int(self.face_tree[t, f]), 0))
                for t in range(self.num_trees) for f in range(nf)])
            g = self._gluing[dev] = GluingTables(
                torch.as_tensor(self.face_tree, dtype=torch.int32, device=dev),
                torch.as_tensor(rows, device=dev))
        return g

    # ------------------------------------------------------------ geometry
    def root_face_of(self, s: Simplex, face) -> torch.Tensor:
        """Which root facet holds face `face` of each element (plane tests
        of the face's corners against the root's facet equations, on the
        elements' device); -1 where the face is interior.  `face` is a
        scalar or an (n,) tensor of element-face indices.  Returns (n,)
        int32."""
        o = get_ops(self.d)
        dev = s.device
        coords = o.coordinates(s).to(torch.int64)          # (n, d+1, d)
        n = coords.shape[0]
        face = torch.as_tensor(face, dtype=torch.int64, device=dev).expand(n)
        fci = torch.as_tensor(o.face_corner_indices, dtype=torch.int64, device=dev)
        V = torch.gather(coords, 1, fci[face][:, :, None].expand(-1, -1, self.d))
        out = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for rf, (nrm, r) in enumerate(root_face_planes(self.d)):
            on = ((V * torch.as_tensor(nrm, dtype=torch.int64, device=dev)).sum(-1)
                  == (r << self.L)).all(dim=1)
            out[on] = rf
        return out

    # ----------------------------------------------------------- transform
    def transform_across_face(self, s: Simplex, tree: int, root_face: int,
                              bops=None) -> tuple[Simplex, int]:
        """Map elements `s` (in `tree`'s frame, just OUTSIDE its root across
        `root_face`) into the neighbor tree's frame: (s', tree').  With
        `bops` (a `BatchedOps`) the `tree_transform` kernel wrapper does the
        math, otherwise the plain `SimplexOps.tree_transform`."""
        tree, root_face = int(tree), int(root_face)
        t2 = int(self.face_tree[tree, root_face])
        if t2 < 0:
            raise ValueError(f"tree {tree} face {root_face} is a domain boundary")
        M = self.face_M[tree, root_face]
        c = self.face_c[tree, root_face]
        tm = self.face_typemap[tree, root_face]
        if bops is not None:
            return bops.tree_transform(s, M, c, tm), t2
        return get_ops(self.d).tree_transform(s, M, wrap_i32(c), tm), t2

    def world_vertices(self, tree: int, s: Simplex) -> torch.Tensor:
        """(n, d+1, d) int64 vertex coordinates in the world lattice (scale
        2^L per unit cube), from the int32 `coordinates` of the elements as
        the JAX package computes them."""
        coords = get_ops(self.d).coordinates(s).to(torch.int64)
        M = torch.as_tensor(self.tree_embed_M[tree], dtype=torch.int64, device=s.device)
        off = torch.as_tensor(self.tree_embed_o[tree].astype(np.int64) << self.L,
                              device=s.device)
        return coords @ M.T + off


# ------------------------------------------------------------- construction
def _from_embeddings(d: int, embeds, box=None, periodic=None) -> Cmesh:
    """Derive the whole connectivity from per-tree world embeddings
    world = M_t @ local + o_t * 2^L (unit-scale integer offsets o_t), by
    matching faces in world coordinates."""
    t = get_tables(d)
    L = MAXLEVEL[d]
    nt = t.num_types
    K = len(embeds)
    nf = d + 1
    periodic = tuple(periodic) if periodic is not None else (False,) * d
    rv0 = t.ref_verts[0].astype(np.int64)
    Ms, os_, world = [], [], []
    for M, o in embeds:
        M = np.asarray(M, np.int64)
        o = np.asarray(o, np.int64)
        signed_perm_maps(d, M)  # validates admissibility
        Ms.append(M)
        os_.append(o)
        world.append(rv0 @ M.T + o)

    # face registry in (wrapped) world coordinates at unit scale
    reg: dict[frozenset, list] = {}
    for tr in range(K):
        for f in range(nf):
            V = np.delete(world[tr], f, axis=0)
            w = np.zeros(d, np.int64)
            if box is not None:
                for k in range(d):
                    if periodic[k] and np.all(V[:, k] == box[k]):
                        w[k] = -box[k]
            key = frozenset(map(tuple, (V + w).tolist()))
            reg.setdefault(key, []).append((tr, f, w))

    face_tree = np.full((K, nf), -1, np.int32)
    face_face = np.zeros((K, nf), np.int32)
    face_M = np.tile(np.eye(d, dtype=np.int32), (K, nf, 1, 1))
    face_c = np.zeros((K, nf, d), np.int64)
    face_typemap = np.tile(np.arange(nt, dtype=np.int32), (K, nf, 1))
    face_facemap = np.tile(np.arange(nf, dtype=np.int32), (K, nf, nt, 1))
    for key, lst in reg.items():
        if len(lst) == 1:
            continue  # domain boundary
        if len(lst) != 2:
            raise ValueError(f"face {sorted(key)} shared by {len(lst)} trees")
        for (t1, f1, w1), (t2, f2, w2) in (lst, lst[::-1]):
            M = Ms[t2].T @ Ms[t1]
            c = (Ms[t2].T @ (os_[t1] - os_[t2] + w1 - w2)) << L
            # adjacent cubes keep |c| <= 2 * 2^L
            if np.abs(c).max(initial=0) > (2 << L):
                raise ValueError(f"non-adjacent gluing of trees {t1} and {t2}")
            face_tree[t1, f1] = t2
            face_face[t1, f1] = f2
            face_M[t1, f1] = M
            face_c[t1, f1] = c
            tm, vm = signed_perm_maps(d, M)
            face_typemap[t1, f1] = tm
            face_facemap[t1, f1] = vm

    cm = Cmesh(d=d, num_trees=K, face_tree=face_tree, face_face=face_face,
               face_M=face_M, face_c=face_c, face_typemap=face_typemap,
               face_facemap=face_facemap, tree_embed_M=np.stack(Ms).astype(np.int32),
               tree_embed_o=np.stack(os_), tree_eclass=np.zeros(K, np.int32))
    _check_connectivity(cm)
    return cm


def _check_connectivity(cm: Cmesh) -> None:
    """Construction-time proofs: every gluing is involutive (composes with
    its reverse to the identity) and maps the level-0 outside neighbor of
    the source root exactly onto the neighbor tree's root.  Raises
    ValueError on the first gluing that fails."""
    d = cm.d
    o = get_ops(d)
    z = torch.zeros(1, dtype=torch.int32)
    root = Simplex(torch.zeros((1, d), dtype=torch.int32), z, z)

    def need(ok: bool, what: str, t1: int, f1: int) -> None:
        if not ok:
            raise ValueError(f"gluing of tree {t1} face {f1}: {what}")

    for t1 in range(cm.num_trees):
        for f1 in range(d + 1):
            t2 = int(cm.face_tree[t1, f1])
            if t2 < 0:
                continue
            f2 = int(cm.face_face[t1, f1])
            need(int(cm.face_tree[t2, f2]) == t1 and int(cm.face_face[t2, f2]) == f1,
                 "the partner face does not point back", t1, f1)
            M12, c12 = cm.face_M[t1, f1].astype(np.int64), cm.face_c[t1, f1]
            M21, c21 = cm.face_M[t2, f2].astype(np.int64), cm.face_c[t2, f2]
            need(np.array_equal(M21 @ M12, np.eye(d, dtype=np.int64))
                 and np.array_equal(M21 @ c12 + c21, np.zeros(d, np.int64)),
                 "not involutive", t1, f1)
            nb, dual = o.face_neighbor(root, f1)
            s2, tt = cm.transform_across_face(nb, t1, f1)
            need(tt == t2 and int(s2.stype[0]) == 0 and int(s2.level[0]) == 0
                 and not bool(s2.anchor.any()),
                 "the level-0 outside neighbor does not map onto the neighbor root", t1, f1)
            need(int(cm.face_facemap[t1, f1, int(nb.stype[0]), int(dual[0])]) == f2,
                 "the face map does not give the partner face", t1, f1)


def cmesh_disconnected(d: int, num_trees: int) -> Cmesh:
    """K isolated trees: every tree face is a domain boundary (the meaning
    of `Forest.cmesh is None`).  Trees sit two cubes apart along axis 0, so
    world coordinates stay unique."""
    embeds = []
    for k in range(num_trees):
        o = np.zeros(d, np.int64)
        o[0] = 2 * k
        embeds.append((np.eye(d, dtype=np.int64), o))
    return _from_embeddings(d, embeds)


def cmesh_single(d: int) -> Cmesh:
    """One root simplex, all faces domain boundary (the paper's setting)."""
    return cmesh_disconnected(d, 1)


def cmesh_brick(d: int, shape, periodic=None) -> Cmesh:
    """An array of prod(shape) Kuhn cubes, each split into d! trees (2
    triangles / 6 tetrahedra); interior and (per axis, optionally) periodic
    faces are glued, the outer faces are domain boundary.  Tree order:
    cells in C order, types 0..d!-1 within a cell."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != d or any(s < 1 for s in shape):
        raise ValueError(f"a brick needs d = {d} positive extents, got {shape}")
    perms = [_perm_matrix_for_type(d, b) for b in range(math.factorial(d))]
    embeds = [(P, np.asarray(cell, np.int64)) for cell in np.ndindex(shape) for P in perms]
    return _from_embeddings(d, embeds, box=shape, periodic=periodic)


def cmesh_unit_cube(d: int, periodic=None) -> Cmesh:
    """The Kuhn decomposition of one cube: 2 trees in 2D, 6 in 3D."""
    return cmesh_brick(d, (1,) * d, periodic=periodic)


def cmesh_rotated_pair() -> Cmesh:
    """2D: S_0 and its point-reflected copy glued along face 0 into a
    parallelogram, the smallest domain whose gluing has sigma = -1."""
    embeds = [(np.eye(2, dtype=np.int64), np.zeros(2, np.int64)),
              (-np.eye(2, dtype=np.int64), np.array([2, 1], np.int64))]
    return _from_embeddings(2, embeds)
