"""The owner count that `owner_rank` and `eval_route` share (on the card one
O(log P) search a query, `csrc/sfc.cu` `owner_count`), held against the JAX
package on the CPU: the plain compare-and-count `kernels.ref._owner_count`
against `repro.core.batch.owner_rank_lex` at marker counts around the
search's edges, and both wrappers with no markers against the JAX package's
owner rank and eval route (every rank 0).  Inputs come from a numpy seed:
lex-sorted markers with a run of empty ranks (repeated markers) and a
trailing sentinel, queries equal to markers, before the first marker, past
the last tree and, at d = 3, at key 2^63 - 1.  Tolerance 0.  The card's
search itself is held against these plain versions by
`tests/test_torch_cuda.py` and `chip_smoke.py`."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.core import forest as JF
from repro.core import u64 as u64m
from repro.core.batch import _pad_markers, owner_rank_lex
from repro.kernels import ref as jkref
from repro_torch import convert
from repro_torch.core import batch as tbatch
from repro_torch.core.tables import MAXLEVEL
from repro_torch.kernels import ops as kops, ref as kref

TREES = 4


def _markers(P, d, seed):
    """P lex-sorted (tree int32, key uint64) markers over TREES trees: the
    first at (0, 0), ranks 1-2 empty (repeating rank 3's marker) and a
    trailing (TREES, 0) sentinel where P allows."""
    rng = np.random.default_rng(seed)
    mt = np.sort(rng.integers(0, TREES, P)).astype(np.int32)
    mk = rng.integers(0, 1 << (d * MAXLEVEL[d]), P, dtype=np.uint64)
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    if P:
        mt[0], mk[0] = 0, 0
    if P >= 4:
        mt[1:3], mk[1:3] = mt[3], mk[3]
    if P >= 3:
        mt[-1], mk[-1] = TREES, 0
    return mt, mk


def _queries(n, d, seed, mt, mk):
    """n (tree int32, key uint64) queries: random trees -1..TREES + 1, a
    third equal to a marker, four before the first marker, four past the
    last tree and, at d = 3, four at key 2^63 - 1."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-1, TREES + 2, n).astype(np.int32)
    k = rng.integers(0, 1 << (d * MAXLEVEL[d]), n, dtype=np.uint64)
    if len(mt):
        eq = np.nonzero(rng.random(n) < 1 / 3)[0]
        j = rng.integers(0, len(mt), len(eq))
        t[eq], k[eq] = mt[j], mk[j]
    t[:4], t[4:8], k[4:8] = -1, TREES + 1, 0
    if d == 3:
        t[8:12], k[8:12] = 0, (1 << 63) - 1
    return t, k


@functools.lru_cache(maxsize=None)
def _jax_counts(P, d, n):
    """owner_rank_lex of `_queries` against `_markers`, as numpy."""
    mt, mk = _markers(P, d, seed=P + d)
    t, k = _queries(n, d, seed=7 * P + d, mt=mt, mk=mk)
    q, m = u64m.from_int(k), u64m.from_int(mk)
    return np.asarray(owner_rank_lex(jnp.asarray(t), q.hi, q.lo, jnp.asarray(mt), m.hi, m.lo))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("P", [1, 2, 33, 4097])
def test_plain_owner_count_matches_owner_rank_lex(d, P):
    """The plain compare-and-count equals the JAX package's one shared lex
    searchsorted, empty ranks and the sentinel owning nothing."""
    n = 257
    mt, mk = _markers(P, d, seed=P + d)
    t, k = _queries(n, d, seed=7 * P + d, mt=mt, mk=mk)
    got = kref._owner_count(torch.from_numpy(t), torch.from_numpy(k.astype(np.int64)),
                            torch.from_numpy(mt), torch.from_numpy(mk.astype(np.int64)))
    want = _jax_counts(P, d, n)
    np.testing.assert_array_equal(got.numpy(), want)
    if P >= 4:
        assert not np.isin([1, 2], want).any()


def test_owner_rank_without_markers_matches_reference():
    """With no markers, owner_rank sends every key to rank 0, as
    `owner_rank_lex` over no markers and the JAX `BatchedOps.owner_rank`
    (which pads the table with sentinels) do."""
    t, k = _queries(100, 3, seed=1, mt=np.zeros(0, np.int32), mk=np.zeros(0, np.uint64))
    none_t, none_k = np.zeros(0, np.int32), np.zeros(0, np.uint64)
    got = kops.owner_rank(torch.from_numpy(t), torch.from_numpy(k.astype(np.int64)),
                          torch.from_numpy(none_t), torch.from_numpy(none_k.astype(np.int64)))
    q, m = u64m.from_int(k), u64m.from_int(none_k)
    lex = owner_rank_lex(jnp.asarray(t), q.hi, q.lo, jnp.asarray(none_t), m.hi, m.lo)
    bops = jbatch.get_batch_ops(3, "jnp").owner_rank(t, k, none_t, none_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lex))
    np.testing.assert_array_equal(got.numpy(), bops)
    assert got.dtype == torch.int32 and not got.any()


@pytest.mark.parametrize("d", [2, 3])
def test_eval_route_without_markers_matches_reference(d):
    """With no markers, eval_route gives every pair first = last = 0 and
    its end key, as the JAX package's eval route does (its jnp program runs
    `owner_rank_lex` over the sentinel-padded table); and `BatchedOps.
    eval_route` routes the same rows as the JAX one for a rank 0 and 1."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(40 + d)
    n, nf = 300, d + 1
    level = rng.integers(0, L + 1, n).astype(np.int32)
    shift = (np.uint64(d) * (np.uint64(L) - level.astype(np.uint64)))[None, :]
    key = (rng.integers(0, 1 << (d * L), (nf, n), dtype=np.uint64) >> shift) << shift
    tgt = rng.integers(0, TREES, (nf, n)).astype(np.int32)
    none_t, none_k = np.zeros(0, np.int32), np.zeros(0, np.uint64)
    kend, first, last = kops.eval_route(
        d, torch.from_numpy(tgt), torch.from_numpy(key.astype(np.int64)),
        torch.from_numpy(level), torch.from_numpy(none_t),
        torch.from_numpy(none_k.astype(np.int64)))
    mt_p, mk_p = _pad_markers(none_t, none_k)
    hh, hl, jf, jl = jkref.eval_route_ref(
        d, jnp.asarray(tgt), jnp.asarray((key >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(key.astype(np.uint32)), jnp.asarray(np.broadcast_to(level, (nf, n))),
        jnp.asarray(mt_p), jnp.asarray((mk_p >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(mk_p.astype(np.uint32)))
    jend = (np.asarray(hh).astype(np.uint64) << np.uint64(32)) | np.asarray(hl).astype(np.uint64)
    np.testing.assert_array_equal(kend.numpy().astype(np.uint64), jend)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jl))
    assert not first.any() and not last.any()
    with jbatch.use_backend("jnp"):
        jf_ = JF.new_uniform(d, 2, 1, JF.SimComm(1))[0]
        tf_ = convert.forest_from_reference({k: getattr(jf_, k) for k in convert.FIELDS},
                                            device="cpu")
        jb, tb = jbatch.get_batch_ops(d), tbatch.get_batch_ops(d)
        jsw = jb.sweep_full(jf_.simplices(), jf_.tree)
        tsw = tb.sweep_full(tf_.simplices(), tf_.tree)
        for g in (0, 1):
            got, want = tb.eval_route(tsw, none_t, none_k, g), jb.eval_route(jsw, none_t, none_k, g)
            for name in ("tree", "level", "dual", "first", "last"):
                np.testing.assert_array_equal(getattr(got, name), getattr(want, name), name)
            np.testing.assert_array_equal(got.key.astype(np.uint64), want.key)
            assert (len(got.tree) == 0) == (g == 0)
