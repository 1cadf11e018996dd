"""The port's hex element ops (`repro_torch.core.ops.HexOps`) against the
JAX package's `HexOps`, exactly, at d = 2 and 3, and the hex `BatchedOps`
queries (successor, predecessor, the single-face neighbor over all 2d
faces) against the same.

Inputs come from a numpy seed: hexes of every level 0..L (the first rows at
levels 0, 1 and L), element 0 and the last element of their level among
them, and the same levels with h-aligned anchors anywhere in the box
[-2^L, 2^L)^d, twice the root cube, for the tests that must see elements
outside the root."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import u64 as u64m
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro_torch.core.batch import get_batch_ops
from repro_torch.core.ops import HexOps, get_ops
from repro_torch.core.tables import MAXLEVEL
from repro_torch.core.types import ECLASS_HEX, Simplex

N = 240


@pytest.fixture(params=[2, 3])
def d(request):
    return request.param


def _ids(d, n, seed):
    """(consecutive index uint64, level int32): levels 0..L with the first
    rows at 0, 1 and L; every third row from the fourth on is element 0 of
    its level and every third from the fifth the level's last element."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:3] = (0, 1, L)
    top = np.left_shift(np.uint64(1), (d * level).astype(np.uint64)) - np.uint64(1)
    ids = rng.integers(0, 1 << 63, n, dtype=np.uint64) & top
    ids[3::3] = 0
    ids[4::3] = top[4::3]
    return ids, level


def _hexes(d, n, seed):
    """Numpy (anchor, level) of the indexed hexes, by the JAX package."""
    ids, level = _ids(d, n, seed)
    s = jget_ops(d, ECLASS_HEX).from_linear_id(u64m.from_int(ids), jnp.asarray(level))
    return np.array(s.anchor), level


def _box(d, n, seed):
    """Numpy (anchor, level): h-aligned hexes anywhere in [-2^L, 2^L)^d."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    h = (1 << (L - level.astype(np.int64)))[:, None]
    anchor = np.floor_divide(rng.integers(-(1 << L), 1 << L, (n, d)), h) * h
    return anchor.astype(np.int32), level


def _both(anchor, level):
    z = np.zeros(len(level), np.int32)
    return (JSimplex(jnp.asarray(anchor), jnp.asarray(level), jnp.asarray(z)),
            Simplex(torch.from_numpy(np.array(anchor)), torch.from_numpy(np.array(level)),
                    torch.from_numpy(z)))


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        g = g.numpy()
        w = np.broadcast_to(np.asarray(w), g.shape)
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def _keys(k):
    return u64m.to_np(k)


def test_get_ops_gives_hex_ops(d):
    o, j = get_ops(d, ECLASS_HEX), jget_ops(d, ECLASS_HEX)
    assert isinstance(o, HexOps) and o is get_ops(d, ECLASS_HEX)
    assert (o.eclass, o.L, o.nt, o.nc, o.nf, o.num_corners) == (
        j.eclass, j.L, j.nt, j.nc, j.nf, j.num_corners)
    np.testing.assert_array_equal(o.face_corner_indices, j.face_corner_indices)
    assert o.num_elements(3) == j.num_elements(3) == 1 << (3 * d)


def test_hierarchy_matches_reference(d):
    """coordinates, parent, local_index, child_tm (each child, and one per
    element), children_tm and sibling_tm."""
    o, j = get_ops(d, ECLASS_HEX), jget_ops(d, ECLASS_HEX)
    js, ts = _both(*_hexes(d, N, seed=1))
    np.testing.assert_array_equal(o.coordinates(ts).numpy(), np.asarray(j.coordinates(js)))
    _same(o.parent(ts), j.parent(js))
    np.testing.assert_array_equal(o.local_index(ts).numpy(), np.asarray(j.local_index(js)))
    for i in range(1 << d):
        _same(o.child_tm(ts, i), j.child_tm(js, i))
        _same(o.sibling_tm(ts, i), j.sibling_tm(js, i))
    per = np.arange(N, dtype=np.int32) % (1 << d)
    _same(o.child_tm(ts, torch.from_numpy(per)), j.child_tm(js, jnp.asarray(per)))
    _same(o.children_tm(ts), j.children_tm(js))


def test_neighbors_and_containment_match_reference(d):
    """face_neighbor over every face (one for all, and one per element),
    is_inside_root and is_ancestor, on hexes inside and outside the root."""
    o, j = get_ops(d, ECLASS_HEX), jget_ops(d, ECLASS_HEX)
    js, ts = _both(*_box(d, N, seed=2))
    for f in range(2 * d):
        (tn, td), (jn, jd) = o.face_neighbor(ts, f), j.face_neighbor(js, f)
        _same(tn, jn)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    per = np.arange(N, dtype=np.int32) % (2 * d)
    (tn, td), (jn, jd) = o.face_neighbor(ts, torch.from_numpy(per)), j.face_neighbor(
        js, jnp.asarray(per))
    _same(tn, jn)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    inside = o.is_inside_root(ts).numpy()
    np.testing.assert_array_equal(inside, np.asarray(j.is_inside_root(js)))
    assert inside.any() and not inside.all()
    ja, ta = _both(*_hexes(d, N, seed=3))
    for k in (0, 1, 5):
        lv = np.minimum(np.asarray(ja.level), k)
        anc_t, anc_j = o.ancestor_at_level(ta, torch.from_numpy(lv)), j.ancestor_at_level(ja, lv)
        _same(anc_t, anc_j)
        np.testing.assert_array_equal(o.is_ancestor(anc_t, ta).numpy(),
                                      np.asarray(j.is_ancestor(anc_j, ja)))
        assert o.is_ancestor(anc_t, ta).all()
    got = o.is_ancestor(ta, Simplex(*(x.flip(0) for x in ta))).numpy()
    np.testing.assert_array_equal(got, np.asarray(j.is_ancestor(
        ja, JSimplex(*(x[::-1] for x in ja)))))


def test_keys_and_curve_match_reference(d):
    """morton_key, linear_id, from_linear_id, decode_key, successor and
    predecessor (wrapping at element 0 and the last element of each level),
    sfc_less and nearest_common_ancestor."""
    o, j = get_ops(d, ECLASS_HEX), jget_ops(d, ECLASS_HEX)
    ids, level = _ids(d, N, seed=4)
    js, ts = _both(*_hexes(d, N, seed=4))
    key = o.morton_key(ts)
    np.testing.assert_array_equal(key.numpy().astype(np.uint64), _keys(j.morton_key(js)))
    np.testing.assert_array_equal(o.linear_id(ts).numpy().astype(np.uint64), ids)
    _same(o.from_linear_id(torch.from_numpy(ids.astype(np.int64)), ts.level),
          j.from_linear_id(u64m.from_int(ids), js.level))
    garbage = key | torch.from_numpy(np.random.default_rng(5).integers(0, 1 << 20, N))
    garbage = torch.where(ts.level < MAXLEVEL[d] - 7, garbage, key)
    _same(o.decode_key(garbage, ts.level),
          j.decode_key(u64m.from_int(garbage.numpy().astype(np.uint64)), js.level))
    _same(o.successor(ts), j.successor(js))
    _same(o.predecessor(ts), j.predecessor(js))
    jb, tb = _both(*_hexes(d, N, seed=6))
    np.testing.assert_array_equal(o.sfc_less(ts, tb).numpy(), np.asarray(j.sfc_less(js, jb)))
    _same(o.nearest_common_ancestor(ts, tb), j.nearest_common_ancestor(js, jb))
    # pairs with deep common ancestors: an element and its successor
    _same(o.nearest_common_ancestor(ts, o.successor(ts)),
          j.nearest_common_ancestor(js, j.successor(js)))


def test_tree_transform_matches_reference(d):
    """The gluing map under signed permutations a hex tree admits (a
    rotation: an axis permuted and reflected; a reflection of one axis),
    type 0 through the trivial map."""
    o, j = get_ops(d, ECLASS_HEX), jget_ops(d, ECLASS_HEX)
    js, ts = _both(*_hexes(d, N, seed=7))
    L = MAXLEVEL[d]
    rot = np.eye(d, dtype=np.int32)
    rot[:2, :2] = [[0, -1], [1, 0]]
    flip = np.eye(d, dtype=np.int32)
    flip[-1, -1] = -1
    for M in (rot, flip):
        c = np.full(d, 1 << L, np.int32) if d == 3 else np.full(d, 1 << (L - 1), np.int32)
        tm = np.zeros(1 if d == 2 else 6, np.int32)
        _same(o.tree_transform(ts, M, c, tm), j.tree_transform(js, M, c, tm))


def test_batched_hex_queries_match_reference(d):
    """`BatchedOps(d, ECLASS_HEX)` successor, predecessor and face_neighbor
    over all 2d faces (the hex bodies' plain versions here) against the JAX
    `HexOps`; the face sweep's planes agree with the single-face neighbor."""
    b, j = get_batch_ops(d, ECLASS_HEX), jget_ops(d, ECLASS_HEX)
    assert b.nf == 2 * d and b.eclass == ECLASS_HEX
    js, ts = _both(*_hexes(d, N, seed=8))
    _same(b.successor(ts), j.successor(js))
    _same(b.predecessor(ts), j.predecessor(js))
    sw = b.face_sweep(ts)
    for f in range(2 * d):
        (tn, td), (jn, jd) = b.face_neighbor(ts, f), j.face_neighbor(js, f)
        _same(tn, jn)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert torch.equal(sw.neighbor.anchor[f], tn.anchor) and torch.equal(sw.dual[f], td)
    np.testing.assert_array_equal(b.morton_key(ts).numpy().astype(np.uint64),
                                  _keys(j.morton_key(js)))
