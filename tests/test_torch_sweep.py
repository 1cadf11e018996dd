"""The port's face sweep, routing eval and inside-root test against the JAX
package, on the CPU: the element ops (`face_neighbor`, `is_inside_root`,
`is_ancestor`, `coordinates`), the plain versions of the three kernels
(`kernels.ref.face_sweep`, `eval_route`, `inside_root`), and the fused eval
stage of `core.batch` (`sweep_full`, `eval_2to1`, `eval_cache`,
`eval_route`) with its dispatch and host-fetch budgets.

The JAX package runs under `use_backend("jnp")` or through its own plain
references (`repro.kernels.ref`).  Inputs are made with numpy from a seed
and cover levels 0..L, every type, and elements anywhere in the root cube,
so that neighbors leave the root.  Tolerance is 0 everywhere.  A neighbor
outside the root has a key in both packages, but the JAX package calls it
garbage ("never read it there"), so keys are compared where `inside` is 1;
the port's kernel and plain version agree on it everywhere
(`tests/test_torch_cuda.py`)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.core import forest as JF
from repro.core import u64 as u64m
from repro.core.batch import _pad_markers
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro.kernels import ref as jkref
from repro_torch import convert
from repro_torch.core import batch as tbatch
from repro_torch.core import forest as TF
from repro_torch.core.ops import get_ops
from repro_torch.core.types import Simplex
from repro_torch.kernels import ops as kops, ref as kref

ROOT = Path(__file__).resolve().parents[1]


def _elements(d, n, seed):
    """(anchor, level, stype) numpy: levels 0..L (0 and L first), types
    0..d!-1, anchors anywhere in the root cube at the element's level, half
    of them decoded from random keys (inside the root)."""
    o = get_ops(d)
    L = o.L
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:4] = (0, L, 0, L)
    h = (1 << (L - level.astype(np.int64)))[:, None]
    anchor = (rng.integers(0, 1 << L, (n, d)) // h * h).astype(np.int32)
    stype = rng.integers(0, o.nt, n).astype(np.int32)
    key = rng.integers(0, 1 << (d * L), n, dtype=np.uint64).astype(np.int64)
    dec = o.decode_key(torch.from_numpy(key), torch.from_numpy(level))
    half = np.arange(n) % 2 == 0
    anchor[half] = dec.anchor.numpy()[half]
    stype[half] = dec.stype.numpy()[half]
    return anchor, level, stype


def _both(anchor, level, stype):
    t = Simplex(*(torch.from_numpy(x) for x in (anchor, level, stype)))
    j = JSimplex(*(jnp.asarray(x) for x in (anchor, level, stype)))
    return t, j


def _keys_np(k):
    return np.asarray(u64m.to_np(k)).astype(np.int64)


@pytest.mark.parametrize("d", [2, 3])
def test_element_ops_match_reference(d):
    """face_neighbor (Alg. 4.6), is_inside_root, is_ancestor (Prop. 23) and
    coordinates (Alg. 4.1) equal the JAX SimplexOps, levels 0 and L
    included."""
    o, jo = get_ops(d), jget_ops(d)
    anchor, level, stype = _elements(d, 3000, seed=d)
    t, j = _both(anchor, level, stype)
    for f in range(o.nf):
        tn, td = o.face_neighbor(t, f)
        jn, jd = jo.face_neighbor(j, jnp.int32(f))
        np.testing.assert_array_equal(tn.anchor.numpy(), np.asarray(jn.anchor))
        np.testing.assert_array_equal(tn.stype.numpy(), np.asarray(jn.stype))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(o.is_inside_root(tn).numpy(),
                                      np.asarray(jo.is_inside_root(jn)))
    np.testing.assert_array_equal(o.is_inside_root(t).numpy(), np.asarray(jo.is_inside_root(j)))
    inside = o.is_inside_root(t).numpy()
    assert inside.any() and not inside.all()
    np.testing.assert_array_equal(o.coordinates(t).numpy(), np.asarray(jo.coordinates(j)))
    # is_ancestor over (parent-of-parent, element) pairs and shuffled pairs
    t2, j2 = _both(*(x[::-1].copy() for x in (anchor, level, stype)))
    np.testing.assert_array_equal(o.is_ancestor(t2, t).numpy(), np.asarray(jo.is_ancestor(j2, j)))
    tp = o.parent(o.parent(t))
    jp = jo.parent(jo.parent(j))
    got = o.is_ancestor(tp, t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jo.is_ancestor(jp, j)))
    assert got[level >= 2].all()
    np.testing.assert_array_equal(o.face_corner_indices, jo.face_corner_indices)
    assert o.nf == jo.nf == d + 1


@pytest.mark.parametrize("d", [2, 3])
def test_plain_face_sweep_matches_reference(d):
    """The plain face sweep equals the JAX `face_sweep_ref` and its jnp
    `BatchedOps.face_sweep`: neighbors, types, duals and inside masks
    everywhere, keys where inside (both packages compute them elsewhere
    too, the JAX package without promising them)."""
    anchor, level, stype = _elements(d, 2000, seed=10 + d)
    t, j = _both(anchor, level, stype)
    nb_anchor, nb_stype, dual, inside, key = kref.face_sweep(t.anchor, t.level, t.stype)
    assert nb_anchor.shape == (d + 1, 2000, d) and key.dtype == torch.int64
    assert inside.dtype == torch.bool
    want = jkref.face_sweep_ref(d, *[j.anchor[:, k] for k in range(d)], j.level, j.stype)
    for k in range(d):
        np.testing.assert_array_equal(nb_anchor[..., k].numpy(), np.asarray(want[k]).T)
    np.testing.assert_array_equal(nb_stype.numpy(), np.asarray(want[d]).T)
    np.testing.assert_array_equal(dual.numpy(), np.asarray(want[d + 1]).T)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want[d + 2]).T.astype(bool))
    jkey = ((np.asarray(want[d + 3]).T.astype(np.uint64) << np.uint64(32))
            | np.asarray(want[d + 4]).T.astype(np.uint64)).astype(np.int64)
    ins = inside.numpy()
    assert ins.any() and not ins.all()
    np.testing.assert_array_equal(key.numpy()[ins], jkey[ins])
    with jbatch.use_backend("jnp"):
        sw = jbatch.get_batch_ops(d).face_sweep(j)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(sw.inside))
    np.testing.assert_array_equal(dual.numpy(), np.asarray(sw.dual))
    np.testing.assert_array_equal(key.numpy()[ins], _keys_np(sw.key)[ins])
    fs = tbatch.get_batch_ops(d).face_sweep(t)
    assert torch.equal(fs.key, key) and torch.equal(fs.inside, inside)
    assert fs.neighbor.level.shape == (d + 1, 2000)


@pytest.mark.parametrize("d", [2, 3])
def test_plain_inside_root_matches_reference(d):
    """The plain inside-root test equals the JAX `is_inside_root_ref`, with
    the level-0 rule: at level 0 only the root itself is inside."""
    anchor, level, stype = _elements(d, 3000, seed=20 + d)
    t, j = _both(anchor, level, stype)
    got = kref.inside_root(t.anchor, t.level, t.stype)
    want = np.asarray(jkref.is_inside_root_ref(d, *[j.anchor[:, k] for k in range(d)],
                                               j.level, j.stype))
    np.testing.assert_array_equal(got.numpy(), want)
    zero = level == 0
    root = zero & (anchor == 0).all(axis=1) & (stype == 0)
    np.testing.assert_array_equal(got.numpy()[zero], root[zero])
    assert got.numpy()[level == get_ops(d).L].any()


@pytest.mark.parametrize("d", [2, 3])
def test_plain_eval_route_matches_reference(d):
    """The plain routing eval equals the JAX `eval_route_ref` on span-aligned
    keys at levels 0..L (at d = 3, level 0, the end key is 2^63 - 1) and
    five markers with an empty rank."""
    L = get_ops(d).L
    rng = np.random.default_rng(30 + d)
    n, nf, P = 500, d + 1, 5
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:2] = (0, L)
    shift = (np.uint64(d) * (np.uint64(L) - level.astype(np.uint64)))[None, :]
    key = (rng.integers(0, 1 << (d * L), (nf, n), dtype=np.uint64) >> shift) << shift
    key[0, 0] = 0
    tgt = rng.integers(0, 4, (nf, n)).astype(np.int32)
    mt = np.array([0, 1, 1, 2, 3], np.int32)
    mk = np.sort(rng.integers(0, 1 << (d * L), P).astype(np.uint64))
    mk[2] = mk[1]
    kend, first, last = kref.eval_route(
        d, torch.from_numpy(tgt), torch.from_numpy(key.astype(np.int64)),
        torch.from_numpy(level), torch.from_numpy(mt), torch.from_numpy(mk.astype(np.int64)))
    mt_p, mk_p = _pad_markers(mt, mk)
    lvl2 = np.broadcast_to(level, (nf, n))
    hh, hl, jf, jl = jkref.eval_route_ref(
        d, jnp.asarray(tgt), jnp.asarray((key >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(key.astype(np.uint32)), jnp.asarray(lvl2), jnp.asarray(mt_p),
        jnp.asarray((mk_p >> np.uint64(32)).astype(np.uint32)), jnp.asarray(mk_p.astype(np.uint32)))
    jend = (np.asarray(hh).astype(np.uint64) << np.uint64(32)) | np.asarray(hl).astype(np.uint64)
    np.testing.assert_array_equal(kend.numpy().astype(np.uint64), jend)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jl))
    if d == 3:
        assert int(kend[0, 0]) == (1 << 63) - 1
    assert 1 not in set(first.numpy().ravel()) | set(last.numpy().ravel())
    assert (last.numpy() > first.numpy()).any()


# ----------------------------------------------------- the fused eval stage
def _corner_flags(d, deep):
    """The corner refinement of the set-up: anchor at the origin, below
    `deep`; one flag column per package."""
    def np_cb(tree, elems):
        a, lv = np.asarray(elems.anchor), np.asarray(elems.level)
        return ((a.sum(1) == 0) & (lv < deep)).astype(np.int32)

    def torch_cb(tree, elems):
        return ((elems.anchor.sum(1) == 0) & (elems.level < deep)).to(torch.int32)
    return np_cb, torch_cb


def _mk_forests(d, P, pattern, seed=0):
    """The JAX package's `tests/core/test_device_eval.py` set-up without a
    coarse mesh: two trees, base level 1 (d = 3) or 2 (d = 2), then a
    corner refinement or a random one; the JAX forests and the port's
    copies of them."""
    base, deep = (1, 3) if d == 3 else (2, 4)
    jc, tc = JF.SimComm(P), TF.SimComm(P)
    jfs = JF.new_uniform(d, 2, base, jc)
    if pattern == "corner":
        jfs = [JF.adapt(f, _corner_flags(d, deep)[0], recursive=True) for f in jfs]
    else:
        rng = np.random.default_rng(seed)
        jfs = [JF.adapt(f, lambda tree, e: (rng.random(e.level.shape[0]) < 0.3).astype(np.int32))
               for f in jfs]
    tfs = [convert.forest_from_reference({k: getattr(f, k) for k in convert.FIELDS},
                                         device="cpu") for f in jfs]
    return jfs, jc, tfs, tc


@pytest.mark.parametrize("d,pattern", [(3, "corner"), (3, "random"), (2, "corner"), (2, "random")])
def test_fused_eval_matches_reference(d, pattern):
    """eval_2to1 (need and boundary masks), eval_cache and the compacted
    eval_route rows equal the JAX jnp backend's on every rank, with a
    synthetic remote-leaf cache of every other rank's leaves."""
    with jbatch.use_backend("jnp"):
        jfs, jc, tfs, tc = _mk_forests(d, 3, pattern)
        mt, mk = JF.partition_markers(jfs, jc)
        tmt, tmk = TF.partition_markers(tfs, tc)
        np.testing.assert_array_equal(tmt, mt)
        np.testing.assert_array_equal(tmk, mk)
        jb, tb = jbatch.get_batch_ops(d), tbatch.get_batch_ops(d)
        for g, (jf, tf) in enumerate(zip(jfs, tfs)):
            others = [o for i, o in enumerate(jfs) if i != g and o.num_local]
            ct, ck, cl = (np.concatenate([getattr(o, a) for o in others])
                          for a in ("tree", "keys", "level"))
            order = np.lexsort((cl, ck, ct))
            ct, ck, cl = ct[order], ck[order], cl[order]
            jsw = jb.sweep_full(jf.simplices(), jf.tree)
            tsw = tb.sweep_full(tf.simplices(), tf.tree)
            jtab = jb.upload_table(jf.tree, jf.keys, jf.level)
            ttab = tb.upload_table(tf.tree, tf.keys, tf.level)
            jcache = jb.upload_table(ct, ck, cl)
            tcache = tb.upload_table(ct, ck.astype(np.int64), cl, device="cpu")
            for got, want in zip(tb.eval_2to1(tsw, ttab, mt, mk, g),
                                 jb.eval_2to1(jsw, jtab, mt, mk, g)):
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(tb.eval_cache(tsw, tcache, mt, mk, g),
                                          jb.eval_cache(jsw, jcache, mt, mk, g))
            got, want = tb.eval_route(tsw, mt, mk, g), jb.eval_route(jsw, mt, mk, g)
            for name in ("tree", "level", "dual", "first", "last"):
                np.testing.assert_array_equal(getattr(got, name), getattr(want, name), name)
            np.testing.assert_array_equal(got.key.astype(np.uint64), want.key)
        # the face-sweep layer and its face kinds (no coarse mesh: interior
        # or domain boundary), one face at a time as well
        tl = TF.face_sweep_layer(tf, tf.tree, tf.simplices())
        jl = JF.face_sweep_layer(jf, jf.tree, jf.simplices())
        np.testing.assert_array_equal(TF.face_kinds(tf, tf.simplices()).numpy(),
                                      JF.face_kinds(jf, jf.simplices()))
        for name in ("tgt", "valid", "anchor", "stype", "dual", "kind"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(), getattr(jl, name), name)
        v = tl.valid.numpy()
        np.testing.assert_array_equal(tl.nkey.numpy()[v], jl.nkey.astype(np.int64)[v])
        tgt, nkey, valid, nb, dual, kind = tl.face(1)
        assert torch.equal(kind, TF.face_kind(tf, tf.simplices(), 1))
        assert torch.equal(nb.anchor, tl.anchor[1]) and torch.equal(valid, tl.valid[1])


def test_fused_eval_empty_and_missing_inputs():
    """Empty ranks (no sweep) and empty tables short-circuit as in the JAX
    package."""
    bops = tbatch.get_batch_ops(2)
    mt, mk = np.array([0, 1], np.int32), np.array([0, 0], np.uint64)
    need, bm = bops.eval_2to1(None, None, mt, mk, 0)
    assert need.shape == (0,) and bm.shape == (0,)
    assert bops.eval_cache(None, None, mt, mk, 0).shape == (0,)
    assert len(bops.eval_route(None, mt, mk, 0).tree) == 0
    z = torch.zeros(0, dtype=torch.int32)
    assert bops.upload_table(z, z.long(), z) is None
    assert bops.sweep_full(Simplex(torch.zeros((0, 2), dtype=torch.int32), z, z), z) is None


def test_lex_search_and_range_max_match_numpy():
    """The written-out lex binary search equals a per-tree numpy
    searchsorted, both sides, across tree boundaries; the range maximum
    equals numpy's, first maximum included."""
    rng = np.random.default_rng(5)
    n = 3000
    tree = np.sort(rng.integers(0, 5, n)).astype(np.int32)
    key = np.concatenate([np.sort(rng.choice(1 << 62, (tree == t).sum(), replace=False))
                          for t in range(5)]).astype(np.int64)
    qt = rng.integers(0, 6, 4000).astype(np.int32)
    qk = rng.integers(0, 1 << 62, 4000).astype(np.int64)
    qk[:100] = key[rng.integers(0, n, 100)]
    for right in (False, True):
        got = tbatch.lex_search(torch.from_numpy(tree), torch.from_numpy(key),
                                torch.from_numpy(qt), torch.from_numpy(qk), right=right)
        side = "right" if right else "left"
        want = [np.searchsorted(tree, t) + np.searchsorted(key[tree == t], k, side=side)
                for t, k in zip(qt, qk)]
        np.testing.assert_array_equal(got.numpy(), want)
    lv = rng.integers(0, 22, n).astype(np.int32)
    rm = tbatch.RangeMax(torch.from_numpy(lv))
    lo = rng.integers(0, n + 1, 2000)
    hi = np.minimum(lo + rng.integers(0, 700, 2000), n)
    got = rm.query(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    want = [lv[a:b].max() if b > a else -1 for a, b in zip(lo, hi)]
    np.testing.assert_array_equal(got, want)
    ok = hi > lo
    first = rm.first_at_least(torch.from_numpy(lo[ok]), torch.from_numpy(hi[ok]),
                              torch.from_numpy(got[ok]))
    np.testing.assert_array_equal(first.numpy(),
                                  [a + int(np.argmax(lv[a:b])) for a, b in zip(lo[ok], hi[ok])])


@pytest.mark.parametrize("d", [2, 3])
def test_balance_round_dispatch_and_fetch_budget(d):
    """A balanced no-op round issues one face_sweep + one eval_route + one
    eval_2to1 per non-empty rank, no eval_cache, no per-face
    face_neighbor or is_inside_root dispatch, and at most two host fetches
    of the eval stage per rank (the routing rows and the 2:1 masks)."""
    base, deep = (1, 3) if d == 3 else (2, 4)
    tc = TF.SimComm(2)
    tfs = TF.new_uniform(d, 2, base, tc, device="cpu")
    tfs = [TF.adapt(f, _corner_flags(d, deep)[1], recursive=True) for f in tfs]
    tfs = TF.balance(tfs, tc)
    nonempty = sum(1 for f in tfs if f.num_local)
    tbatch.reset_dispatch_counts()
    tbatch.reset_host_fetch_counts()
    TF.balance(tfs, tc)
    counts = tbatch.dispatch_counts()
    fetches = tbatch.host_fetch_counts()
    assert counts.get("face_sweep", 0) == nonempty, counts
    assert counts.get("eval_route", 0) == nonempty, counts
    assert counts.get("eval_2to1", 0) == nonempty, counts
    assert counts.get("eval_cache", 0) == 0, counts
    for banned in ("face_neighbor", "is_inside_root", "owner_rank"):
        assert counts.get(banned, 0) == 0, counts
    assert fetches == {"eval_route": nonempty, "eval_2to1": nonempty}, fetches
    assert sum(fetches.values()) <= 2 * nonempty


def test_sweep_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the three new wrappers run their plain versions (the
    plain counters move, the launch counters do not) and check inputs."""
    anchor, level, stype = (torch.from_numpy(x) for x in _elements(3, 64, seed=1))
    kref.reset_call_counts()
    kops.reset_launch_counts()
    kops.face_sweep(anchor, level, stype)
    kops.inside_root(anchor, level, stype)
    tgt = torch.zeros((4, 64), dtype=torch.int32)
    kops.eval_route(3, tgt, tgt.long(), level, tgt[0, :1], tgt[0, :1].long())
    assert {k: kref.call_counts[k] for k in ("face_sweep", "inside_root", "eval_route")} == {
        "face_sweep": 1, "inside_root": 1, "eval_route": 1}
    assert not any(kops.launch_counts.values())
    with pytest.raises(ValueError):
        kops.eval_route(3, tgt[:3], tgt.long(), level, tgt[0, :1], tgt[0, :1].long())
    _kend, first, last = kops.eval_route(3, tgt, tgt.long(), level, tgt[0, :0],
                                         tgt[0, :0].long())
    assert not first.any() and not last.any()         # no markers: every rank 0
    with pytest.raises(TypeError):
        kops.face_sweep(anchor, level.long(), stype)


def test_port_sources_import_neither_jax_nor_the_reference():
    """The import rule, read off the sources: no module of the port and not
    `chip_smoke.py` has an import of `jax` or of the JAX package `repro`."""
    rule = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro(\.| ))", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [str(p) for p in files if rule.search(p.read_text())]
    assert not bad, bad
