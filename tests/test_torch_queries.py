"""The port's element-query kernels (owner rank, successor, single-face
neighbor) and their `BatchedOps` entry points, held against the JAX
package, exactly.  (`new_uniform(method="successor")` is held against it
in `test_torch_new_successor.py`.)

On this CPU the wrappers in `repro_torch.kernels.ops` run their plain
versions (`kernels.ref`), which must equal the JAX Pallas kernels in
interpret mode (as `tests/kernels/test_sfc_kernels.py` runs them; the
Pallas successor, slow there, only under `-m slow` here) and the JAX
package's oracles.  The CUDA kernels are held against the plain versions
on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.core import u64 as u64m
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro.kernels import ops as jkops
from repro.kernels import ref as jkref
from repro_torch.core import batch as tbatch
from repro_torch.core.tables import MAXLEVEL
from repro_torch.core import types as ttypes
from repro_torch.core.types import Simplex
from repro_torch.kernels import ops as kops


def _elements(d, n, seed):
    """Numpy (anchor, level, stype): levels 0..L (the first rows at 0, 1
    and L), every third row from the fourth on element 0 of its level and
    every third from the fifth the level's last element."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:3] = (0, 1, L)[:n]
    top = np.left_shift(np.uint64(1), (d * level).astype(np.uint64)) - np.uint64(1)
    ids = rng.integers(0, 1 << 63, n, dtype=np.uint64) & top
    ids[3::3] = 0
    ids[4::3] = top[4::3]
    s = jget_ops(d).from_linear_id(u64m.from_int(ids), jnp.asarray(level))
    return np.array(s.anchor), level, np.array(s.stype)


def _cube(d, n, seed):
    """Numpy (anchor, level, stype, face): elements anywhere in the root
    cube (most outside the root simplex), of every type, one face each."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    h = (1 << (L - level.astype(np.int64)))[:, None]
    anchor = (rng.integers(0, 1 << L, (n, d)) // h * h).astype(np.int32)
    stype = rng.integers(0, 2 if d == 2 else 6, n).astype(np.int32)
    face = rng.integers(0, d + 1, n).astype(np.int32)
    return anchor, level, stype, face


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _markers(P, trees, d, seed):
    """P lex-sorted markers (tree int32, key uint64) over `trees` trees with
    empty ranks (repeated markers) and a trailing (trees, 0) sentinel."""
    rng = np.random.default_rng(seed)
    mt = np.sort(rng.integers(0, trees, P)).astype(np.int32)
    mk = rng.integers(0, 1 << (d * MAXLEVEL[d]), P, dtype=np.uint64)
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    mt[0], mk[0] = 0, 0
    mt[2:4], mk[2:4] = mt[1], mk[1]
    mt[-1], mk[-1] = trees, 0
    return mt, mk


def _queries(n, trees, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, trees + 1, n).astype(np.int32),
            rng.integers(0, 1 << (d * MAXLEVEL[d]), n, dtype=np.uint64))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [7, 250])
def test_plain_owner_rank_matches_pallas_kernel(d, n):
    """P = 5 markers (sentinel-padded for the Pallas kernel), two empty
    ranks among them."""
    mt, mk = _markers(5, 3, d, seed=n + d)
    tree, key = _queries(n, 3, d, seed=n)
    got = kops.owner_rank(*_t(tree, key.astype(np.int64), mt, mk.astype(np.int64)))
    mt_p, mk_p = jbatch._pad_markers(mt, mk)
    want = jkops.owner_rank(u64m.from_int(key), jnp.asarray(tree),
                            (jnp.asarray(mt_p), u64m.from_int(mk_p)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    owners = set(np.unique(got.numpy()).tolist())
    assert not owners & {1, 2}                 # empty ranks: their markers repeat rank 3's
    assert owners == {0, 3, 4} or n < 50


@pytest.mark.parametrize("d", [2, 3])
def test_plain_face_neighbor_matches_pallas_kernel(d):
    """One face per element, elements anywhere in the root cube."""
    anchor, level, stype, face = _cube(d, 130, seed=d)
    got = kops.face_neighbor(*_t(anchor, level, stype, face))
    s = JSimplex(jnp.asarray(anchor), jnp.asarray(level), jnp.asarray(stype))
    nb, dual = jkops.face_neighbor(d, s, jnp.asarray(face))
    for g, w in zip(got, (nb.anchor, nb.stype, dual), strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("d", [2, 3])
def test_plain_successor_matches_successor_ref(d):
    """Levels 0..L, the wrap of each level's last element included, against
    the Pallas kernel's oracle."""
    anchor, level, stype = _elements(d, 300, seed=30 + d)
    got = kops.successor(*_t(anchor, level, stype))
    want = jkref.successor_ref(d, *(jnp.asarray(anchor[:, k]) for k in range(d)),
                               jnp.asarray(level), jnp.asarray(stype))
    np.testing.assert_array_equal(got[0].numpy(), np.stack([np.asarray(w) for w in want[:d]], 1))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[d]))
    assert not got[0].numpy()[4::3].any() and not got[1].numpy()[4::3].any()


@pytest.mark.slow
@pytest.mark.parametrize("d", [2, 3])
def test_plain_successor_matches_pallas_kernel(d):
    anchor, level, stype = _elements(d, 130, seed=40 + d)
    got = kops.successor(*_t(anchor, level, stype))
    want = jkops.successor(d, JSimplex(jnp.asarray(anchor), jnp.asarray(level),
                                       jnp.asarray(stype)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.anchor))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.stype))


@pytest.mark.parametrize("P", [5, 4097])
def test_batched_owner_rank_matches_reference(P):
    """`BatchedOps.owner_rank` (tensors in and out) against the JAX
    package's (host arrays, its jnp backend), either side of the 4096
    markers the kernel keeps in shared memory."""
    d = 3
    mt, mk = _markers(P, 4, d, seed=P)
    tree, key = _queries(2000, 4, d, seed=P + 1)
    tbatch.reset_dispatch_counts()
    got = tbatch.get_batch_ops(d).owner_rank(*_t(tree, key.astype(np.int64), mt,
                                                mk.astype(np.int64)))
    assert tbatch.dispatch_counts() == {"owner_rank": 1}
    want = jbatch.get_batch_ops(d, "jnp").owner_rank(tree, key, mt, mk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > min(P - 3, 100)


@pytest.mark.parametrize("d", [2, 3])
def test_batched_queries_match_reference(d):
    """`BatchedOps` successor, predecessor, face_neighbor (one face for all
    elements, and one per element) and local_index against the JAX
    package's batched and element ops."""
    anchor, level, stype = _elements(d, 200, seed=50 + d)
    face = np.random.default_rng(d).integers(0, d + 1, 200).astype(np.int32)
    tb, jb, jo = tbatch.get_batch_ops(d), jbatch.get_batch_ops(d, "reference"), jget_ops(d)
    ts = Simplex(*_t(anchor, level, stype))
    js = JSimplex(jnp.asarray(anchor), jnp.asarray(level), jnp.asarray(stype))

    def same(got, want):
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.broadcast_to(np.asarray(w), g.shape))

    tbatch.reset_dispatch_counts()
    same(tb.successor(ts), jb.successor(js))
    same(tb.predecessor(ts), jo.predecessor(js))
    for f in range(d + 1):
        nb, dual = tb.face_neighbor(ts, f)
        jnb, jdual = jb.face_neighbor(js, f)
        same((*nb, dual), (*jnb, jdual))
    nb, dual = tb.face_neighbor(ts, torch.from_numpy(face))
    jnb, jdual = jo.face_neighbor(js, jnp.asarray(face))
    same((*nb, dual), (*jnb, jdual))
    same((tb.local_index(ts),), (jb.local_index(js),))
    assert tbatch.dispatch_counts() == {"successor": 1, "predecessor": 1,
                                        "face_neighbor": d + 2, "local_index": 1}


@pytest.mark.parametrize("d", [2, 3])
def test_batched_queries_take_constructed_simplices(d):
    """A batch from `types.simplex` with one level and type for all its
    elements goes through `BatchedOps.successor` and `face_neighbor` and
    gives what the JAX package gives for the same elements."""
    L = MAXLEVEL[d]
    h = 1 << (L - 5)
    anchor = (np.random.default_rng(d).integers(0, 1 << 5, (64, d)) * h).astype(np.int32)
    ts = ttypes.simplex(anchor, 5, 1, device="cpu")
    js = JSimplex(jnp.asarray(anchor), jnp.full(64, 5, jnp.int32), jnp.full(64, 1, jnp.int32))
    tb, jb = tbatch.get_batch_ops(d), jbatch.get_batch_ops(d, "reference")
    for g, w in zip(tb.successor(ts), jb.successor(js), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for f in range(d + 1):
        (nb, dual), (jnb, jdual) = tb.face_neighbor(ts, f), jb.face_neighbor(js, f)
        for g, w in zip((*nb, dual), (*jnb, jdual), strict=True):
            np.testing.assert_array_equal(g.numpy(), np.broadcast_to(np.asarray(w), g.shape))
