"""Derivation of all lookup tables for the tetrahedral Morton (TM) space-filling curve.

Reference: C. Burstedde, J. Holke, "A tetrahedral space-filling curve for
non-conforming adaptive meshes" (2015/2016), the t8code SFC.

Rather than transcribing the paper's printed tables (1, 2, 6, 7, 8 and the
face-neighbor tables 3/4), we *derive* every table from first principles:

  * The reference simplices S_0 .. S_{d!-1} are defined exactly by the
    paper's Algorithm 4.1 (Coordinates): S_b = [0, e_i, e_i + e_j, (1,..,1)]
    with i = b // 2 (3D) resp. i = b (2D) and j = (i+2)%3 for even b,
    j = (i+1)%3 for odd b.
  * Bey's red-refinement rule (paper eq. (2)) produces the 2^d ordered
    children of a simplex from its corner midpoints.
  * The type of any sub-simplex is found by normalising its vertex set to
    its associated cube and matching against {S_b} (Property 4 guarantees
    a unique match).
  * Face-neighbor tables are found by brute-force search in a local uniform
    Kuhn lattice (they are translation- and level-invariant).
  * The "is outside / ancestor" boundary-type sets of Proposition 23 are
    fitted against an exact descendant oracle.

The unit tests cross-check the derived tables against every legible entry
of the paper's printed tables.

All tables are small (<= 6 x 8) int8/int32 numpy arrays.  The PyTorch ops
in ``repro_torch.core.ops`` turn them into tensors on the caller's device,
and ``repro_torch.kernels.build`` writes the packed encode/decode tables
into a generated CUDA header.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from functools import lru_cache

import numpy as np

__all__ = [
    "SFCTables",
    "get_tables",
    "MAXLEVEL",
    "face_plane",
    "root_face_planes",
]

# Maximum refinement level per dimension.  Chosen so (a) the consecutive index
# (d * level bits, at most 63) fits a non-negative int64 key, and (b) the root
# cube side 2^MAXLEVEL stays below 2^31 (anchor coords are int32).
MAXLEVEL = {2: 30, 3: 21}


def _ref_simplex_vertices(d: int, b: int) -> np.ndarray:
    """Vertices of reference simplex S_b at scale 1, per Algorithm 4.1 (paper).

    Returns (d+1, d) int array; row 0 is the anchor node (origin).
    """
    v = np.zeros((d + 1, d), dtype=np.int64)
    if d == 2:
        i = b
        j = 1 - i
        e = np.eye(2, dtype=np.int64)
        v[1] = v[0] + e[i]
        v[2] = (1, 1)
    elif d == 3:
        i = b // 2
        j = (i + 2) % 3 if b % 2 == 0 else (i + 1) % 3
        e = np.eye(3, dtype=np.int64)
        v[1] = v[0] + e[i]
        v[2] = v[1] + e[j]
        v[3] = (1, 1, 1)
    else:
        raise ValueError(f"d must be 2 or 3, got {d}")
    return v


def _bey_children_vertices(d: int, verts: np.ndarray) -> list[np.ndarray]:
    """The 2^d ordered Bey children of a simplex given by `verts` (scale even).

    Vertex coordinates must be even integers so midpoints stay integral.
    Ordering follows Bey's numbering, paper eq. (2).
    """
    x = [verts[i] for i in range(d + 1)]

    def m(i, j):
        return (x[i] + x[j]) // 2

    if d == 2:
        return [
            np.stack([x[0], m(0, 1), m(0, 2)]),
            np.stack([m(0, 1), x[1], m(1, 2)]),
            np.stack([m(0, 2), m(1, 2), x[2]]),
            np.stack([m(0, 1), m(0, 2), m(1, 2)]),
        ]
    return [
        np.stack([x[0], m(0, 1), m(0, 2), m(0, 3)]),
        np.stack([m(0, 1), x[1], m(1, 2), m(1, 3)]),
        np.stack([m(0, 2), m(1, 2), x[2], m(2, 3)]),
        np.stack([m(0, 3), m(1, 3), m(2, 3), x[3]]),
        np.stack([m(0, 1), m(0, 2), m(0, 3), m(1, 3)]),
        np.stack([m(0, 1), m(0, 2), m(1, 2), m(1, 3)]),
        np.stack([m(0, 2), m(0, 3), m(1, 3), m(2, 3)]),
        np.stack([m(0, 2), m(1, 2), m(1, 3), m(2, 3)]),
    ]


def _type_of(d: int, verts: np.ndarray, h: int, anchor: np.ndarray) -> int:
    """Match a simplex (vertex set) against the reference types.

    `h` is the side length of its associated cube, `anchor` the cube anchor.
    """
    rel = verts - anchor[None, :]
    assert np.all(rel >= 0) and np.all(rel <= h), (verts, anchor, h)
    key = frozenset(map(tuple, (rel // (h // 1)).tolist())) if h == 1 else frozenset(
        map(tuple, (rel / h).astype(np.float64).tolist())
    )
    # Compare as exact rational grids: rel must be multiples of h.
    assert np.all(rel % h == 0)
    key = frozenset(map(tuple, (rel // h).tolist()))
    for b in range(math.factorial(d)):
        sb = frozenset(map(tuple, _ref_simplex_vertices(d, b).tolist()))
        if key == sb:
            return b
    raise AssertionError(f"no reference simplex matches {verts} (anchor {anchor}, h {h})")


def _cube_id(offset: np.ndarray) -> int:
    """cube-id from an anchor offset in {0,1}^d: x + 2y (+ 4z)."""
    return int(sum(int(offset[k]) << k for k in range(len(offset))))


@dataclasses.dataclass(frozen=True)
class SFCTables:
    """All derived lookup tables for dimension `d`."""

    d: int
    num_types: int                      # d!
    num_children: int                   # 2^d
    maxlevel: int
    # (d!, d+1, d) vertex offsets of S_b in units of h (Algorithm 4.1).
    ref_verts: np.ndarray
    # (d!, 2^d) child type, Bey order  (paper Table 1, "Ct").
    child_type: np.ndarray
    # (d!, 2^d, d) child anchor offset in units of h/2, Bey order.
    child_anchor: np.ndarray
    # (d!, 2^d) cube-id of Bey-child i of a type-b parent.
    child_cube_id: np.ndarray
    # (2^d, d!) parent type from (cube-id, own type)  (paper Fig. 8, "Pt").
    parent_type: np.ndarray
    # (d!, 2^d) sigma_b: Bey index -> TM local index  (paper Table 2).
    bey_to_local: np.ndarray
    # (d!, 2^d) sigma_b^{-1}: TM local index -> Bey index.
    local_to_bey: np.ndarray
    # (2^d, d!) local index from (own cube-id, own type)  (paper Table 6).
    local_index: np.ndarray
    # (d!, 2^d) cube-id of the TM-child `iloc` of a type-b parent (Table 7).
    cube_id_of_local: np.ndarray
    # (d!, 2^d) type of the TM-child `iloc` of a type-b parent (Table 8).
    type_of_local: np.ndarray
    # (d!, d+1) face-neighbor type            (paper Tables 3/4).
    neighbor_type: np.ndarray
    # (d!, d+1, d) face-neighbor anchor offset in units of h.
    neighbor_offset: np.ndarray
    # (d!, d+1) dual face number f~ of the neighbor.
    neighbor_face: np.ndarray
    # (d!, d) axis permutation (x_i, x_j, x_k) of Prop. 23 / Table 5.
    # perm[b] = (axis of x_i, axis of x_j, axis of x_k); for 2D only (i, j).
    outside_perm: np.ndarray
    # Boundary type sets for the ancestor test (derived, cf. Prop 23 (51d),
    # (52e)-(52g)).  outside_types_*[b, t] == 1 iff a candidate of type t whose
    # anchor lies on the respective boundary plane of a type-b simplex is
    # OUTSIDE.  "ik": plane x_i == x_k (3D only); "kj": plane x_k == x_j
    # (2D: the diagonal x_i == x_j); "diag": x_i == x_k == x_j (3D only).
    outside_types_ik: np.ndarray
    outside_types_kj: np.ndarray
    outside_types_diag: np.ndarray


def _derive_child_tables(d: int):
    nt, nc = math.factorial(d), 2 ** d
    child_type = np.zeros((nt, nc), dtype=np.int8)
    child_anchor = np.zeros((nt, nc, d), dtype=np.int8)
    child_cube_id = np.zeros((nt, nc), dtype=np.int8)
    for b in range(nt):
        verts = _ref_simplex_vertices(d, b) * 2  # scale 2 so midpoints are ints
        for i, cv in enumerate(_bey_children_vertices(d, verts)):
            anchor = cv.min(axis=0)
            # The anchor of every Kuhn simplex is a vertex (all types share the
            # cube's main diagonal), and equals its associated cube's anchor.
            assert any(np.array_equal(anchor, v) for v in cv)
            child_type[b, i] = _type_of(d, cv, 1, anchor)
            child_anchor[b, i] = anchor  # units of h/2 given parent scale 2
            child_cube_id[b, i] = _cube_id(anchor)
    return child_type, child_anchor, child_cube_id


def _derive_parent_type(d, child_type, child_cube_id):
    nt, nc = math.factorial(d), 2 ** d
    parent_type = -np.ones((nc, nt), dtype=np.int8)
    for b in range(nt):
        for i in range(nc):
            c, t = child_cube_id[b, i], child_type[b, i]
            if parent_type[c, t] >= 0:
                assert parent_type[c, t] == b, "Pt would be ambiguous"
            parent_type[c, t] = b
    assert np.all(parent_type >= 0), "Pt not total"
    return parent_type


def _derive_tm_order(d, child_type, child_cube_id):
    """TM order of children = lexicographic by (cube-id, type), paper eq. (17)."""
    nt, nc = math.factorial(d), 2 ** d
    bey_to_local = np.zeros((nt, nc), dtype=np.int8)
    local_to_bey = np.zeros((nt, nc), dtype=np.int8)
    for b in range(nt):
        keys = [(int(child_cube_id[b, i]), int(child_type[b, i])) for i in range(nc)]
        order = sorted(range(nc), key=lambda i: keys[i])  # order[r] = bey index of rank r
        for rank, i in enumerate(order):
            bey_to_local[b, i] = rank
            local_to_bey[b, rank] = i
    return bey_to_local, local_to_bey


def _derive_local_index(d, child_type, child_cube_id, parent_type, bey_to_local):
    nt, nc = math.factorial(d), 2 ** d
    local_index = -np.ones((nc, nt), dtype=np.int8)
    for b in range(nt):  # parent type
        for i in range(nc):
            c, t = child_cube_id[b, i], child_type[b, i]
            local_index[c, t] = bey_to_local[b, i]
    assert np.all(local_index >= 0)
    return local_index


def _derive_local_lookup(d, child_type, child_cube_id, local_to_bey):
    nt, nc = math.factorial(d), 2 ** d
    cube_id_of_local = np.zeros((nt, nc), dtype=np.int8)
    type_of_local = np.zeros((nt, nc), dtype=np.int8)
    for b in range(nt):
        for rank in range(nc):
            i = local_to_bey[b, rank]
            cube_id_of_local[b, rank] = child_cube_id[b, i]
            type_of_local[b, rank] = child_type[b, i]
    return cube_id_of_local, type_of_local


def _derive_face_neighbors(d: int):
    """Brute-force the same-level face-neighbor tables in a local Kuhn lattice.

    Tables are translation invariant, so one interior sample per type suffices.
    Face f_i of T = [x_0..x_d] is the face NOT containing x_i.
    """
    nt = math.factorial(d)
    neighbor_type = np.zeros((nt, d + 1), dtype=np.int8)
    neighbor_offset = np.zeros((nt, d + 1, d), dtype=np.int8)
    neighbor_face = np.zeros((nt, d + 1), dtype=np.int8)

    # Build all simplices of the uniform Kuhn mesh in cubes with anchors in
    # {-1,0,1,2}^d (side 1), around the sample simplex at cube anchor 0.
    cells = []
    for a in itertools.product(range(-1, 3), repeat=d):
        for b in range(nt):
            verts = _ref_simplex_vertices(d, b) + np.array(a, dtype=np.int64)
            cells.append((np.array(a), b, verts))

    face_map: dict[frozenset, list[int]] = {}
    for idx, (_, _, verts) in enumerate(cells):
        for f in range(d + 1):
            fv = frozenset(tuple(verts[k]) for k in range(d + 1) if k != f)
            face_map.setdefault(fv, []).append(idx)

    for b in range(nt):
        verts = _ref_simplex_vertices(d, b)
        for f in range(d + 1):
            fv = frozenset(tuple(verts[k]) for k in range(d + 1) if k != f)
            owners = face_map[fv]
            others = [
                i for i in owners
                if not (np.array_equal(cells[i][0], np.zeros(d)) and cells[i][1] == b)
            ]
            assert len(others) == 1, f"face {f} of type {b}: owners {owners}"
            a2, b2, v2 = cells[others[0]]
            neighbor_type[b, f] = b2
            neighbor_offset[b, f] = a2
            # dual face: index of the vertex of the neighbor not on the face
            nf = [k for k in range(d + 1) if tuple(v2[k]) not in fv]
            assert len(nf) == 1
            neighbor_face[b, f] = nf[0]
    return neighbor_type, neighbor_offset, neighbor_face


def _derive_outside_perm(d: int):
    """Axis permutation (i, j, k) of Prop. 23 / Table 5, derived from S_b.

    S_b = {0 <= a_{x_j} <= a_{x_k} <= a_{x_i} <= 1} (3D)
    resp. {0 <= a_{x_j} <= a_{x_i} <= 1} (2D).
    The axes are recovered from the reference vertices: x_i is the axis of the
    first edge (largest coordinate), x_k the second edge axis, x_j the rest.
    """
    nt = math.factorial(d)
    perm = np.zeros((nt, d), dtype=np.int8)
    for b in range(nt):
        v = _ref_simplex_vertices(d, b)
        i_ax = int(np.argmax(v[1]))
        if d == 2:
            perm[b] = (i_ax, 1 - i_ax)
        else:
            k_ax = int(np.argmax(v[2] - v[1]))
            j_ax = 3 - i_ax - k_ax
            perm[b] = (i_ax, j_ax, k_ax)
    return perm


@lru_cache(maxsize=None)
def _descendant_sets(d: int, level: int):
    """All descendants of the root simplex down to `level` at vertex scale 2^level.

    Returns dict level -> list of (anchor tuple, type, verts).  Used only for
    table fitting/testing (exponential; keep level small).
    """
    scale = 2 ** level
    root = _ref_simplex_vertices(d, 0) * scale
    out = {0: [(tuple([0] * d), 0, root)]}
    for lv in range(1, level + 1):
        cur = []
        h = scale >> lv
        for _, b, verts in out[lv - 1]:
            for cv in _bey_children_vertices(d, verts):
                anchor = cv.min(axis=0)
                t = _type_of(d, cv, h, anchor)
                cur.append((tuple(int(a) for a in anchor), t, cv))
        out[lv] = cur
    return out


def _derive_outside_type_sets(d: int, perm, child_type, child_cube_id, parent_type):
    """Fit the boundary type sets of the constant-time ancestor test.

    For a simplex T of type b (take T = root, type 0..d!-1 via relabeling:
    instead we test against actual descendants of sub-simplices) a candidate N
    with relative anchor a (a = N.anchor - T.anchor) and level > T.level is a
    descendant iff
        0 <= a_{xj} <= a_{xk} <= a_{xi} < h(T)      (3D; 2D drops x_k)
    AND the type of N is admissible on the boundary planes:
        - a_{xj} == a_{xk}  (< a_{xi})        -> N.b in KJ_inside[b]
        - a_{xk} == a_{xi}  (> a_{xj})        -> N.b in IK_inside[b]
        - a_{xj} == a_{xk} == a_{xi}          -> N.b in DIAG_inside[b]
    We *fit* the inside sets with an exact oracle: enumerate all descendants of
    a level-1 simplex of each type within a level-3 refinement of the root.
    Returns OUTSIDE (complement) boolean arrays of shape (d!, d!).
    """
    nt = math.factorial(d)
    rel_levels = 2          # candidate level relative to T
    h_T = 2 ** rel_levels   # T's cube side at candidate vertex scale 1

    # Oracle: recursively enumerate the (anchor, type) of all relative-level-2
    # descendants of T = S_b scaled by h_T.  The descendant relation is
    # translation/scale invariant (Property 4), so placing T at the origin is
    # fully general.
    def descendants_of(verts_T):
        acc = set()
        stack = [(verts_T, 0)]
        while stack:
            v, lv = stack.pop()
            if lv == rel_levels:
                a = v.min(axis=0)
                acc.add((tuple(int(x) for x in a), _type_of(d, v, 1, a)))
            else:
                stack.extend((cv, lv + 1) for cv in _bey_children_vertices(d, v))
        return acc

    on_ik = -np.ones((nt, nt), dtype=np.int8)
    on_kj = -np.ones((nt, nt), dtype=np.int8)
    on_diag = -np.ones((nt, nt), dtype=np.int8)

    for bT in range(nt):
        desc = descendants_of(_ref_simplex_vertices(d, bT) * h_T)
        p = perm[bT]
        for aN in itertools.product(range(-1, h_T + 1), repeat=d):
            for bN in range(nt):
                rel = np.array(aN)
                ai = rel[p[0]]
                aj = rel[p[1]]
                ak = rel[p[2]] if d == 3 else aj  # 2D: treat x_k := x_j
                inside_open = (0 <= aj <= ak <= ai < h_T) if d == 3 else (0 <= aj <= ai < h_T)
                is_desc = (tuple(aN), bN) in desc
                if not inside_open:
                    assert not is_desc, "oracle violates anchor-ordering condition"
                    continue
                if d == 3:
                    eq_kj, eq_ik = (aj == ak), (ak == ai)
                else:
                    eq_kj, eq_ik = (aj == ai), False
                if not eq_kj and not eq_ik:
                    assert is_desc, "strict interior must be a descendant"
                    continue
                tgt = on_diag if (eq_kj and eq_ik and d == 3) else (on_ik if eq_ik else on_kj)
                val = 0 if is_desc else 1  # 1 = outside
                if tgt[bT, bN] >= 0:
                    assert tgt[bT, bN] == val, "boundary type set not well-defined"
                tgt[bT, bN] = val

    # every combination must have been observed
    assert np.all(on_kj >= 0)
    if d == 3:
        assert np.all(on_ik >= 0) and np.all(on_diag >= 0)
    else:
        on_ik = np.zeros_like(on_kj)
        on_diag = np.zeros_like(on_kj)
    return on_ik.astype(np.int8), on_kj.astype(np.int8), on_diag.astype(np.int8)


def face_plane(V) -> tuple[np.ndarray, int]:
    """Primitive integer plane equation through the d points `V` ((d, d)
    int array): returns (normal, offset) with the plane {x : n @ x == r}."""
    V = np.asarray(V, np.int64)
    if V.shape[1] == 2:
        e = V[1] - V[0]
        n = np.array([-e[1], e[0]], np.int64)
    else:
        n = np.cross(V[1] - V[0], V[2] - V[0])
    g = int(np.gcd.reduce(np.abs(n)))
    n = n // max(g, 1)
    return n, int(n @ V[0])


@lru_cache(maxsize=None)
def root_face_planes(d: int) -> tuple:
    """Integer plane equations of the d+1 facets of the root simplex S_0 at
    unit scale: entry f is (normal, offset) with face f in {x : n @ x == r}.

    Derived from the reference vertices; the coarse-mesh layer classifies
    which root facet a boundary element's face lies on by testing these
    planes at scale 2^MAXLEVEL.
    """
    rv = _ref_simplex_vertices(d, 0)
    planes = []
    for f in range(d + 1):
        n, r = face_plane(np.delete(rv, f, axis=0))
        planes.append((tuple(int(v) for v in n), r))
    return tuple(planes)


@lru_cache(maxsize=None)
def hex_root_face_planes(d: int) -> tuple:
    """Integer plane equations of the 2d facets of the root cube [0, 1)^d at
    unit scale, in face order f = 2*axis + dir: the lower (x_axis = 0) and
    upper (x_axis = 1) face per axis — same (normal, offset) convention as
    `root_face_planes`, tested at scale 2^MAXLEVEL by the coarse-mesh layer."""
    planes = []
    for f in range(2 * d):
        n = tuple(int(k == f // 2) for k in range(d))
        planes.append((n, f % 2))
    return tuple(planes)


@lru_cache(maxsize=None)
def get_tables(d: int) -> SFCTables:
    if d not in (2, 3):
        raise ValueError(f"d must be 2 or 3, got {d}")
    nt, nc = math.factorial(d), 2 ** d
    ref_verts = np.stack([_ref_simplex_vertices(d, b) for b in range(nt)]).astype(np.int8)
    child_type, child_anchor, child_cube_id = _derive_child_tables(d)
    parent_type = _derive_parent_type(d, child_type, child_cube_id)
    bey_to_local, local_to_bey = _derive_tm_order(d, child_type, child_cube_id)
    local_index = _derive_local_index(d, child_type, child_cube_id, parent_type, bey_to_local)
    cube_id_of_local, type_of_local = _derive_local_lookup(d, child_type, child_cube_id, local_to_bey)
    neighbor_type, neighbor_offset, neighbor_face = _derive_face_neighbors(d)
    outside_perm = _derive_outside_perm(d)
    o_ik, o_kj, o_diag = _derive_outside_type_sets(
        d, outside_perm, child_type, child_cube_id, parent_type
    )
    return SFCTables(
        d=d,
        num_types=nt,
        num_children=nc,
        maxlevel=MAXLEVEL[d],
        ref_verts=ref_verts,
        child_type=child_type,
        child_anchor=child_anchor,
        child_cube_id=child_cube_id,
        parent_type=parent_type,
        bey_to_local=bey_to_local,
        local_to_bey=local_to_bey,
        local_index=local_index,
        cube_id_of_local=cube_id_of_local,
        type_of_local=type_of_local,
        neighbor_type=neighbor_type,
        neighbor_offset=neighbor_offset,
        neighbor_face=neighbor_face,
        outside_perm=outside_perm,
        outside_types_ik=o_ik,
        outside_types_kj=o_kj,
        outside_types_diag=o_diag,
    )


if __name__ == "__main__":
    for d in (2, 3):
        t = get_tables(d)
        print(f"== d={d} ==")
        print("child_type (Table 1):\n", t.child_type)
        print("bey_to_local (Table 2):\n", t.bey_to_local)
        print("parent_type (Fig 8):\n", t.parent_type)
        print("local_index (Table 6):\n", t.local_index)
        print("cube_id_of_local (Table 7):\n", t.cube_id_of_local)
        print("type_of_local (Table 8):\n", t.type_of_local)
        print("neighbor_type (Tables 3/4):\n", t.neighbor_type)
        print("neighbor_offset:\n", t.neighbor_offset.reshape(t.num_types, -1))
        print("neighbor_face:\n", t.neighbor_face)
        print("outside_perm (Table 5):\n", t.outside_perm)
        print("outside ik/kj/diag:\n", t.outside_types_ik, "\n", t.outside_types_kj, "\n", t.outside_types_diag)
