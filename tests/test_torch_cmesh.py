"""The port's coarse mesh (`repro_torch.core.cmesh`) against the JAX
package's `repro.core.cmesh`, exactly, on the CPU.

Every table of every simplex constructor (single, disconnected, unit cube,
brick with and without periodic axes, rotated pair) at d = 2 and 3 must be
the JAX package's, shape, dtype and value.  On elements made from a numpy
seed, `root_face_of`, `transform_across_face` (plain and through
`BatchedOps.tree_transform`, whose CPU path is the `tree_transform`
kernel's plain version) and `world_vertices` must equal the JAX package's,
the latter under `use_backend("jnp")`.  The d = 2 translation
c = (0, 2^30) puts a vertex of the transformed element at 2^31, which
`SimplexOps.coordinates` wraps to -2^31 in int32 in both packages: the port
matches that wrap (it is kept here, not sampled around)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import batch as jbatch
from repro.core import cmesh as JC
from repro.core import u64 as u64m
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro_torch import convert
from repro_torch.core import cmesh as TC
from repro_torch.core.batch import get_batch_ops
from repro_torch.core.ops import get_ops
from repro_torch.core.types import Simplex
from repro_torch.kernels import ref as kref

CONSTRUCTORS = {
    "single": lambda d: ("cmesh_single", (d,), {}),
    "disconnected": lambda d: ("cmesh_disconnected", (d, 3), {}),
    "unit_cube": lambda d: ("cmesh_unit_cube", (d,), {}),
    "unit_cube_periodic": lambda d: ("cmesh_unit_cube", (d,), {"periodic": (True,) * d}),
    "brick": lambda d: ("cmesh_brick", (d, (2,) + (1,) * (d - 1)), {}),
    "brick_periodic": lambda d: ("cmesh_brick", (d, (2,) * d),
                                 {"periodic": (True,) + (False,) * (d - 1)}),
}
CASES = [(name, d) for name in CONSTRUCTORS for d in (2, 3)] + [("rotated_pair", 2)]


def _pair(name, d):
    """The same coarse mesh from both packages: (port, JAX)."""
    if name == "rotated_pair":
        return TC.cmesh_rotated_pair(), JC.cmesh_rotated_pair()
    fn, args, kw = CONSTRUCTORS[name](d)
    return getattr(TC, fn)(*args, **kw), getattr(JC, fn)(*args, **kw)


def _elements(d, n, level, seed):
    """n random elements of one level, as numpy (anchor, level, stype)."""
    o = jget_ops(d)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, o.num_elements(level), size=n).astype(np.uint64)
    s = o.from_linear_id(u64m.from_int(ids), jnp.full(n, level, jnp.int32))
    return np.array(s.anchor), np.array(s.level), np.array(s.stype)


def _both(arrays):
    a, l, b = arrays
    return (Simplex(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (a, l, b))),
            JSimplex(jnp.asarray(a), jnp.asarray(l), jnp.asarray(b)))


def _assert_same(ts: Simplex, js: JSimplex):
    for x, y in zip(ts, js):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("name,d", CASES)
def test_tables_match_reference(name, d):
    tc, jc = _pair(name, d)
    for k in TC.CMESH_FIELDS:
        x, y = getattr(tc, k), getattr(jc, k)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k
    glued = int((tc.face_tree >= 0).sum())
    assert (glued == 0) == (name in ("single", "disconnected"))


@pytest.mark.parametrize("name,d", [c for c in CASES if c[0] not in ("single", "disconnected")])
def test_root_face_transform_and_world_vertices_match_reference(name, d):
    """For every face of random elements at levels 1 and 3 of every tree: the
    root face, and for each crossing the transformed element (plain and
    batched) and its world vertices, as in the JAX package."""
    tc, jc = _pair(name, d)
    o, jo = get_ops(d), jget_ops(d)
    crossings = 0
    for level in (1, 3):
        ts, js = _both(_elements(d, 48, level, seed=10 * level + d))
        for face in range(d + 1):
            rf = tc.root_face_of(ts, face)
            assert rf.dtype == torch.int32
            np.testing.assert_array_equal(rf.numpy(), jc.root_face_of(js, face))
            nb, _dual = o.face_neighbor(ts, face)
            jnb, _jdual = jo.face_neighbor(js, face)
            for tree in range(tc.num_trees):
                for rfv in np.unique(rf.numpy()[rf.numpy() >= 0]):
                    if not tc.is_connected(tree, rfv):
                        continue
                    idx = np.nonzero(rf.numpy() == rfv)[0]
                    sub = Simplex(*(x[torch.from_numpy(idx)] for x in nb))
                    jsub = JSimplex(*(x[idx] for x in jnb))
                    s2, t2 = tc.transform_across_face(sub, tree, rfv)
                    j2, jt2 = jc.transform_across_face(jsub, tree, int(rfv))
                    assert t2 == jt2
                    _assert_same(s2, j2)
                    b2, bt2 = tc.transform_across_face(sub, tree, rfv, bops=get_batch_ops(d))
                    with jbatch.use_backend("jnp"):
                        jb2, _ = jc.transform_across_face(jsub, tree, int(rfv),
                                                          bops=jbatch.get_batch_ops(d))
                    assert bt2 == t2
                    _assert_same(b2, jb2)
                    np.testing.assert_array_equal(tc.world_vertices(t2, s2).numpy(),
                                                  jc.world_vertices(jt2, j2))
                    crossings += len(idx)
    assert crossings > 0


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("reflect", [False, True])
def test_batched_tree_transform_matches_reference_with_wrap(d, reflect):
    """`BatchedOps.tree_transform` against the JAX package's under
    `use_backend("jnp")` for a global-sign signed permutation and a
    translation of up to 2 * 2^L per axis — at d = 2 the case c = (0, 2^30)
    and past it, whose anchors and vertices wrap in int32 — and the
    transformed elements' int32 coordinates equal to the JAX package's,
    wrap included."""
    L = get_ops(d).L
    sigma = -1 if reflect else 1
    M = np.zeros((d, d), np.int64)
    M[np.arange(d), np.roll(np.arange(d), 1)] = sigma
    tm, _vm = JC.signed_perm_maps(d, M)
    cs = [np.zeros(d, np.int64), np.array([0, 1] + [0] * (d - 2), np.int64) << L,
          np.array([2, -1] + [1] * (d - 2), np.int64) << L]
    wrapped = 0
    for c in cs:
        for level in (0, 1, 5, L):
            ts, js = _both(_elements(d, 64, level, seed=level + d))
            got = get_batch_ops(d).tree_transform(ts, M, c, tm)
            with jbatch.use_backend("jnp"):
                want = jbatch.get_batch_ops(d).tree_transform(js, M, c, tm)
            _assert_same(got, want)
            gv = get_ops(d).coordinates(got)
            jv = np.asarray(jget_ops(d).coordinates(want))
            assert gv.dtype == torch.int32
            np.testing.assert_array_equal(gv.numpy(), jv)
            true = np.asarray(jget_ops(d).coordinates(js), np.int64) @ M.T + c
            wrapped += int(((true < -2**31) | (true > 2**31 - 1)).sum())
    assert (wrapped > 0) == (d == 2)


def test_the_vertex_at_2_to_the_31_wraps_as_in_the_reference():
    """The fault the JAX package's own round-trip test shows at d = 2: the
    translation c = (0, 2^30) puts a vertex of an element at 2^31, which
    int32 coordinates give as -2^31.  The port computes the same int32
    wrap (its integer contract is bit for bit)."""
    d, L = 2, 30
    M = np.eye(2, dtype=np.int64)
    c = np.array([0, 1 << L], np.int64)
    tm, _ = JC.signed_perm_maps(d, M)
    ts, js = _both((np.array([[0, (1 << L) - 1]], np.int32), np.array([L], np.int32),
                    np.array([1], np.int32)))
    got = get_ops(d).tree_transform(ts, M, TC.wrap_i32(c), tm)
    want = jget_ops(d).tree_transform(js, M, JC.wrap_i32(c), tm)
    _assert_same(got, want)
    v = get_ops(d).coordinates(got).numpy()
    np.testing.assert_array_equal(v, np.asarray(jget_ops(d).coordinates(want)))
    assert v.min() == -2**31


@pytest.mark.parametrize("d", [2, 3])
def test_signed_perm_maps_match_reference(d):
    import itertools

    for perm in itertools.permutations(range(d)):
        for sigma in (1, -1):
            M = np.zeros((d, d), np.int64)
            M[np.arange(d), perm] = sigma
            for x, y in zip(TC.signed_perm_maps(d, M), JC.signed_perm_maps(d, M)):
                np.testing.assert_array_equal(x, y)
    M = np.eye(d, dtype=np.int64)
    M[0, 0] = -1
    with pytest.raises(ValueError, match="not an automorphism"):
        TC.signed_perm_maps(d, M)
    np.testing.assert_array_equal(TC.wrap_i32(np.array([2**31, -2**31 - 1, 5])),
                                  JC.wrap_i32(np.array([2**31, -2**31 - 1, 5])))


@pytest.mark.parametrize("name,d", [("brick_periodic", 2), ("unit_cube", 3), ("rotated_pair", 2)])
def test_gluing_rows_drive_the_plain_kernel(name, d):
    """The device table of `Cmesh.gluing` holds one packed row per (tree,
    root face); the kernel's plain version, fed the rows, carries every
    root's level-0 outside neighbor onto its neighbor tree's root with the
    partner face as dual, as `_check_connectivity` proves."""
    tc, _jc = _pair(name, d)
    g = tc.gluing("cpu")
    assert g.conn.shape == (tc.num_trees * (d + 1), TC.conn_row_width(d))
    assert g.conn.dtype == torch.int32 and tc.gluing("cpu") is g
    np.testing.assert_array_equal(g.face_tree.numpy(), tc.face_tree)
    t1, f1 = np.nonzero(tc.face_tree >= 0)
    n = len(t1)
    z = torch.zeros(n, dtype=torch.int32)
    root = Simplex(torch.zeros((n, d), dtype=torch.int32), z, z)
    nb, dual = get_ops(d).face_neighbor(root, torch.from_numpy(f1.astype(np.int32)))
    conn = torch.from_numpy((t1 * (d + 1) + f1).astype(np.int32))
    anchor, stype, dual2, tree = kref.tree_transform(conn, nb.anchor.contiguous(), nb.level,
                                                     nb.stype, dual, g.conn)
    assert not anchor.any() and not stype.any()
    np.testing.assert_array_equal(tree.numpy(), tc.face_tree[t1, f1])
    np.testing.assert_array_equal(dual2.numpy(), tc.face_face[t1, f1])


def test_cmesh_crosses_to_the_reference_and_back():
    tc, jc = _pair("brick_periodic", 3)
    tables = convert.cmesh_to_reference(tc)
    back = JC.Cmesh(**tables)
    for k in TC.CMESH_FIELDS:
        np.testing.assert_array_equal(getattr(back, k), getattr(jc, k))
    for src in (jc, tables):
        again = convert.cmesh_from_reference(src)
        for k in TC.CMESH_FIELDS:
            np.testing.assert_array_equal(getattr(again, k), getattr(tc, k))
    with pytest.raises(ValueError):
        convert.cmesh_from_reference(dict(tables, face_c=tables["face_c"][:1]))
    with pytest.raises(ValueError):
        TC.cmesh_brick(3, (2, 2))
