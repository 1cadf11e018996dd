"""The port's element queries of paper Section 4 (`repro_torch.core.ops`
and `core.types`) against the JAX package's (`repro.core.ops`,
`repro.core.types`), exactly, at d = 2 and 3.

Inputs come from a numpy seed: elements of every level 0..L (the first
rows at levels 0, 1 and L), with element 0 and the last element of their
level among them, so the successor of the last element (element 0 of the
level) and the predecessor of element 0 (the last) are compared too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.core import u64 as u64m
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro_torch.core import types as ttypes
from repro_torch.core.ops import get_ops
from repro_torch.core.tables import MAXLEVEL
from repro_torch.core.types import ECLASS_HEX, Simplex

N = 240


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


def _elements(d, n, seed):
    """Numpy (anchor, level, stype) of the indexed elements, by the JAX
    package's Algorithm 4.8."""
    ids, level = _ids(d, n, seed)
    s = jget_ops(d).from_linear_id(u64m.from_int(ids), jnp.asarray(level))
    return np.array(s.anchor), level, np.array(s.stype)


def _both(anchor, level, stype):
    return (JSimplex(jnp.asarray(anchor), jnp.asarray(level), jnp.asarray(stype)),
            Simplex(*(torch.from_numpy(np.array(x)) for x in (anchor, level, stype))))


def _same(got: Simplex, want: JSimplex):
    for g, w in zip(got, want, strict=True):
        g = g.numpy()
        w = np.broadcast_to(np.asarray(w), g.shape)
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module", params=[2, 3])
def d(request):
    return request.param


@pytest.fixture(scope="module")
def elems(d):
    return _both(*_elements(d, N, seed=7 + d))


def test_linear_id_matches_reference(d, elems):
    js, ts = elems
    got = get_ops(d).linear_id(ts)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  u64m.to_np(jget_ops(d).linear_id(js)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), _ids(d, N, seed=7 + d)[0])


@pytest.mark.parametrize("which", ["successor", "predecessor"])
def test_successor_predecessor_match_reference_with_wrap(d, elems, which):
    """Same level, wrapping within it: the successor of a level's last
    element is its element 0, the predecessor of element 0 the last, and a
    level-0 element maps to the root."""
    js, ts = elems
    o = get_ops(d)
    got = getattr(o, which)(ts)
    _same(got, getattr(jget_ops(d), which)(js))
    lid = o.linear_id(got).numpy().astype(np.uint64)
    ids, level = _ids(d, N, seed=7 + d)
    top = np.left_shift(np.uint64(1), (d * level).astype(np.uint64)) - np.uint64(1)
    if which == "successor":        # each level's last element -> its element 0
        np.testing.assert_array_equal(lid[4::3], 0)
    else:                           # each level's element 0 -> its last element
        np.testing.assert_array_equal(lid[3::3], top[3::3])
    assert lid[0] == 0 and level[0] == 0
    back = o.predecessor(got) if which == "successor" else o.successor(got)
    _same(back, js)


def test_sfc_less_matches_reference(d, elems):
    """Strict order across levels, on pairs that include an element and its
    own ancestors (equal padded keys, ancestor first)."""
    js, ts = elems
    o, jo = get_ops(d), jget_ops(d)
    rng = np.random.default_rng(d)
    perm = rng.permutation(N)
    lv = (rng.random(N) * (ts.level.numpy() + 1)).astype(np.int32)
    anc_t = o.ancestor_at_level(ts, torch.from_numpy(lv))
    anc_j = jo.ancestor_at_level(js, jnp.asarray(lv))
    others_t = Simplex(*(x[perm] for x in ts))
    others_j = JSimplex(*(jnp.asarray(np.asarray(x)[perm]) for x in js))
    for a_t, b_t, a_j, b_j in ((ts, others_t, js, others_j), (ts, anc_t, js, anc_j),
                               (anc_t, ts, anc_j, js), (ts, ts, js, js)):
        got = o.sfc_less(a_t, b_t).numpy()
        np.testing.assert_array_equal(got, np.asarray(jo.sfc_less(a_j, b_j)))
    assert o.sfc_less(anc_t, ts).numpy()[lv < ts.level.numpy()].all()


def test_sibling_and_children_match_reference(d, elems):
    """sibling_tm and child_bey for every child index, and with one index
    per element."""
    js, ts = elems
    o, jo = get_ops(d), jget_ops(d)
    lv = ts.level.numpy()
    deep, shallow = np.nonzero(lv >= 1)[0], np.nonzero(lv < MAXLEVEL[d])[0]
    dt, dj = Simplex(*(x[deep] for x in ts)), JSimplex(*(x[deep] for x in js))
    st, sj = Simplex(*(x[shallow] for x in ts)), JSimplex(*(x[shallow] for x in js))
    for i in range(o.nc):
        _same(o.sibling_tm(dt, i), jo.sibling_tm(dj, jnp.int32(i)))
        _same(o.child_bey(st, i), jo.child_bey(sj, jnp.int32(i)))
    idx = np.random.default_rng(3).integers(0, o.nc, len(shallow)).astype(np.int32)
    _same(o.child_bey(st, torch.from_numpy(idx)), jo.child_bey(sj, jnp.asarray(idx)))
    _same(o.child_tm(st, torch.from_numpy(idx)), jo.child_tm(sj, jnp.asarray(idx)))


def test_type_chain_and_ancestors_match_reference(d, elems):
    js, ts = elems
    o, jo = get_ops(d), jget_ops(d)
    (tc, tt), (jc, jt) = o._type_chain(ts), jo._type_chain(js)
    assert tc[0] is None and tt[0] is None and len(tc) == MAXLEVEL[d] + 1
    for i in range(1, MAXLEVEL[d] + 1):
        np.testing.assert_array_equal(tc[i].numpy(), np.asarray(jc[i]))
        np.testing.assert_array_equal(tt[i].numpy(), np.asarray(jt[i]))
    lv = ts.level.numpy()
    for target in (np.zeros_like(lv), np.maximum(lv - 1, 0), lv,
                   (np.random.default_rng(5).random(N) * (lv + 1)).astype(np.int32)):
        _same(o.ancestor_at_level(ts, torch.from_numpy(target)),
              jo.ancestor_at_level(js, jnp.asarray(target)))
    _same(o.ancestor_at_level(ts, 0), jo.ancestor_at_level(js, 0))


def test_nearest_common_ancestor_matches_reference(d):
    """Pairs that share a prefix of random depth (and unrelated pairs, and
    an element with itself)."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(11 + d)
    ia, la = _ids(d, N, seed=20 + d)
    lb = rng.integers(0, L + 1, N).astype(np.int32)
    keep = (rng.random(N) * (np.minimum(la, lb) + 1)).astype(np.int64)
    ka = ia << (d * (L - la)).astype(np.uint64)
    low = np.left_shift(np.uint64(1), (d * (L - keep)).astype(np.uint64)) - np.uint64(1)
    kb = (ka & ~low) | (rng.integers(0, 1 << 63, N, dtype=np.uint64) & low)
    kb &= ~(np.left_shift(np.uint64(1), (d * (L - lb)).astype(np.uint64)) - np.uint64(1))
    jo = jget_ops(d)
    a = jo.decode_key(u64m.from_int(ka), jnp.asarray(la))
    b = jo.decode_key(u64m.from_int(kb), jnp.asarray(lb))
    (ja, ta), (jb, tb) = (_both(*(np.asarray(x) for x in s)) for s in (a, b))
    o = get_ops(d)
    got = o.nearest_common_ancestor(ta, tb)
    _same(got, jo.nearest_common_ancestor(ja, jb))
    assert (got.level.numpy() >= keep).all() and (got.level.numpy() > 0).any()
    _same(o.nearest_common_ancestor(ta, ta), ja)
    assert bool(o.is_ancestor(got, ta).all()) and bool(o.is_ancestor(got, tb).all())


def test_types_helpers_match_reference(d, elems):
    """simplex, root, concat, take and the Remark-20 size at rest: 10 bytes
    a triangle and 14 a tetrahedron, 9 a quad and 13 a hexahedron (no type
    byte); the at-rest blobs of both classes as the JAX package packs them."""
    js, ts = elems
    r, jr = ttypes.root(d, device="cpu"), jtypes.root(d)
    _same(r, jr)
    assert ttypes.nbytes_at_rest(r) == jtypes.nbytes_at_rest(jr) == 4 * d + 2
    assert ttypes.nbytes_at_rest(ts) == jtypes.nbytes_at_rest(js) == N * (10 if d == 2 else 14)
    a = np.array(js.anchor)
    _same(ttypes.simplex(a, 3, 1, device="cpu"), jtypes.simplex(a, 3, 1))
    ta = ttypes.simplex(torch.from_numpy(a), 3, 1)
    assert ta.device.type == "cpu" and ta.level.dtype == torch.int32
    assert ta.level.is_contiguous() and ta.stype.is_contiguous()
    _same(ttypes.concat([ts, ts, ts]), jtypes.concat([js, js, js]))
    idx = np.array([5, 0, N - 1, 5])
    _same(ttypes.take(ts, torch.from_numpy(idx)), jtypes.take(js, jnp.asarray(idx)))
    assert (ttypes.nbytes_at_rest(ts, ECLASS_HEX) == jtypes.nbytes_at_rest(js, ECLASS_HEX)
            == N * (9 if d == 2 else 13))
    for ec in (0, ECLASS_HEX):
        got, want = ttypes.pack(ts, ec), jtypes.pack(js, ec)
        assert set(got) == set(want) == ({"anchor", "level"} | ({"stype"} if ec == 0 else set()))
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        _same(ttypes.unpack(got, "cpu"), jtypes.unpack(want))
    with pytest.raises(ValueError):
        ttypes.nbytes_at_rest(ts, 7)
    with pytest.raises(ValueError):
        ttypes.pack(ts, 7)


def test_types_constructors_default_to_the_card(d, monkeypatch):
    """`root` and `simplex` of host data put their tensors on the card
    unless asked for the CPU, and raise when there is no card; a tensor
    anchor keeps its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.zeros((4, d), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttypes.root(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttypes.simplex(a, 3, 1)
    assert ttypes.root(d, device="cpu").device.type == "cpu"
    assert ttypes.simplex(a, 3, 1, device="cpu").device.type == "cpu"
    assert ttypes.simplex(torch.from_numpy(a), 3, 1).device.type == "cpu"
