"""The port's forest over a coarse mesh against the JAX package, on the CPU:
New -> Adapt -> (Partition) -> Balance -> Ghost -> validate across glued
tree faces, element for element and byte for byte.

Fixtures, those of the JAX package's `tests/core/test_forest_multitree.py`
and one more: the 2-tree unit square (d = 2) and the 6-tree unit cube
(d = 3) with a corner of tree 0 refined so Balance ripples across the tree
faces; the same 6-tree cube uniform; the fully periodic unit cube (d = 3);
a periodic 2 x 2 brick of 8 triangles (d = 2), whose wrap translations
reach 2^31 in the transform; and the rotated pair (sigma = -1).  Each is
balanced and ghosted by
both — the port with `overlap` both ways — and every forest field, ghost
field, per-phase counter and payload posted must be equal.  The port
builds each fixture (New over a coarse mesh is held against the JAX
package's here; Adapt and Partition do not read the coarse mesh and are
held equal by `test_torch_pipeline_d*.py`) and carries it into the JAX
package, which runs under `use_backend("jnp")`.  A forest over
`cmesh_disconnected` must equal the cmesh-free forest.  This file runs the
d = 3 fixtures; `test_torch_multitree_d2.py` the d = 2 ones."""

import functools

import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.core import cmesh as JC
from repro.core import forest as JF
from repro_torch import convert
from repro_torch.core import batch as tbatch
from repro_torch.core import cmesh as TC
from repro_torch.core import forest as TF
from repro_torch.kernels import ref as kref
from test_torch_balance import assert_same_traffic
from test_torch_forest import _assert_same_forests, _recording

# name: (cmesh constructor and arguments, d, base level, corner depth of
# tree 0 (None: uniform), ranks, partition after Adapt).  The d = 2 fixtures
# run from `test_torch_multitree_d2.py`, so that each file's JAX programs
# compile for one dimension.
FIXTURES = {
    "cube_d3": (("cmesh_unit_cube", (3,), {}), 3, 1, 3, 3, True),
    "uniform_cube_d3": (("cmesh_unit_cube", (3,), {}), 3, 1, None, 3, False),
    "periodic_cube_d3": (("cmesh_unit_cube", (3,), {"periodic": (True,) * 3}), 3, 1, 3, 2, False),
    "cube_d2": (("cmesh_unit_cube", (2,), {}), 2, 2, 4, 2, False),
    "periodic_brick_d2": (("cmesh_brick", (2, (2, 2)), {"periodic": (True, True)}), 2, 1, 4, 3,
                          True),
    "rotated_pair": (("cmesh_rotated_pair", (), {}), 2, 2, 4, 2, False),
}
D3 = [k for k, v in FIXTURES.items() if v[1] == 3]


def _corner(deep):
    def cb(tree, e):
        return ((tree == 0) & (e.anchor.sum(1) == 0) & (e.level < deep)).to(torch.int32)
    return cb


def _jax_forests(tfs, jcm):
    """The port's forests as JAX Forests over the JAX coarse mesh."""
    return [JF.Forest(**dict(convert.forest_to_reference(f), cmesh=jcm)) for f in tfs]


@functools.lru_cache(maxsize=None)
def reference(name):
    """The fixture before Balance, built by the port and carried into JAX
    Forests over the JAX package's own coarse mesh, and the JAX package's
    Balance -> Ghost -> validate of it on a recording communicator:
    (tfs, jfs, jb, jg, jc)."""
    (fn, args, kw), d, base, deep, P, part = FIXTURES[name]
    tcm, jcm = getattr(TC, fn)(*args, **kw), getattr(JC, fn)(*args, **kw)
    tc = TF.SimComm(P)
    tfs = TF.new_uniform(d, tcm.num_trees, base, tc, cmesh=tcm, device="cpu")
    if deep is not None:
        tfs = [TF.adapt(f, _corner(deep), recursive=True) for f in tfs]
    if part:
        tfs = TF.partition(tfs, tc)
    assert all(f.cmesh is tcm for f in tfs)
    jfs = _jax_forests(tfs, jcm)
    jc = _recording(JF.SimComm, P)
    with jbatch.use_backend("jnp"):
        jb = JF.balance(jfs, jc)
        jg = JF.ghost(jb, jc)
        assert JF.validate(jb, jg)
    return tfs, jfs, jb, jg, jc


def check_pipeline(name):
    """The port's Balance -> Ghost -> validate of the fixture, with
    `overlap` both ways, against the JAX package's: every forest and ghost
    field, every payload posted and every byte."""
    tfs, _jfs, jb, jg, jc = reference(name)
    P = FIXTURES[name][4]
    for overlap in (True, False):
        tc = _recording(TF.SimComm, P)
        tb = TF.balance(tfs, tc, overlap=overlap)
        tg = TF.ghost(tb, tc, overlap=overlap)
        assert TF.validate(tb, tg)
        _assert_same_forests(tb, jb)
        for a, b in zip(tg, jg, strict=True):
            for k in convert.GHOST_FIELDS:
                assert a[k].dtype == torch.int32
                np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
        for phase in ("balance", "ghost"):
            assert_same_traffic(tc, jc, phase)
            assert tc.bytes_for(phase) == jc.bytes_for(phase)
    # ghosts across tree faces: entries of trees their rank holds nothing of
    cross = sum(int((~torch.isin(g["tree"], f.tree)).sum()) for f, g in zip(tb, tg))
    assert cross > 0
    if FIXTURES[name][3] is not None:
        assert TF.count_global(tb) > TF.count_global(tfs)


def check_sweep_layer(name):
    """Every field of the fixed-up sweep layer of every rank, crossings
    included, against the JAX package's `face_sweep_layer`, and one
    `tree_transform` call per layer whatever its connections."""
    tfs, jfs, *_ = reference(name)
    crossed = 0
    for tf, jf in zip(tfs, jfs):
        if not tf.num_local:
            continue
        kref.reset_call_counts()
        lay = TF.face_sweep_layer(tf, tf.tree, tf.simplices())
        with jbatch.use_backend("jnp"):
            jlay = JF.face_sweep_layer(jf, jf.tree, jf.simplices())
        inter = int((lay.kind == TF.FACE_INTER_TREE).sum())
        assert kref.call_counts["tree_transform"] == (1 if inter else 0)
        crossed += inter
        for k in ("tgt", "valid", "anchor", "stype", "dual", "kind"):
            np.testing.assert_array_equal(getattr(lay, k).numpy(), np.asarray(getattr(jlay, k)),
                                          err_msg=k)
        np.testing.assert_array_equal(lay.nkey.numpy().astype(np.uint64), jlay.nkey)
    assert crossed > 0


@pytest.mark.parametrize("name", D3)
def test_balance_ghost_validate_match_reference(name):
    check_pipeline(name)


@pytest.mark.parametrize("name", ["cube_d3", "periodic_cube_d3"])
def test_face_sweep_layer_matches_reference(name):
    check_sweep_layer(name)


def test_new_uniform_over_a_cmesh_matches_reference():
    """New over a coarse mesh, every rank, as the JAX package builds it."""
    comm = JF.SimComm(3)
    with jbatch.use_backend("jnp"):
        jfs = JF.new_uniform(3, 6, 1, comm, cmesh=JC.cmesh_unit_cube(3))
    tfs = TF.new_uniform(3, 6, 1, TF.SimComm(3), cmesh=TC.cmesh_unit_cube(3), device="cpu")
    _assert_same_forests(tfs, jfs)


def test_disconnected_cmesh_equals_no_cmesh():
    check_disconnected(3)


def check_disconnected(d):
    """Over `cmesh_disconnected` every tree face is domain boundary: the
    forest, its ghosts and every byte equal the cmesh-free run's (and the
    JAX package's)."""
    runs = []
    for cm in (None, TC.cmesh_disconnected(d, 2)):
        comm = TF.SimComm(2)
        fs = TF.new_uniform(d, 2, 1, comm, cmesh=cm, device="cpu")
        fs = [TF.adapt(f, lambda t, e: ((e.anchor.sum(1) == 0) & (e.level < 3)).int(),
                       recursive=True) for f in fs]
        fs = TF.balance(fs, comm)
        gh = TF.ghost(fs, comm)
        assert TF.validate(fs, gh)
        runs.append((fs, gh, comm.counters))
    (fa, ga, ca), (fb, gb, cb) = runs
    assert ca == cb
    for a, b in zip(fa, fb):
        assert b.cmesh is not None and a.cmesh is None
        for k in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(a, k), getattr(b, k))
    for a, b in zip(ga, gb):
        for k in convert.GHOST_FIELDS:
            assert torch.equal(a[k], b[k])
    jcm = JC.cmesh_disconnected(d, 2)
    with jbatch.use_backend("jnp"):
        jg = JF.ghost(_jax_forests(fa, jcm), JF.SimComm(2))
    for a, b in zip(gb, jg):
        for k in convert.GHOST_FIELDS:
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_forest_with_cmesh_crosses_to_the_reference_and_back():
    """`forest_to_reference` carries the coarse mesh as its tables;
    `forest_from_reference` takes them (or the JAX `Cmesh`) back, and the
    carried forest balances like the original."""
    tfs, jfs, *_ = reference("periodic_cube_d3")
    P = FIXTURES["periodic_cube_d3"][4]
    for f, jf in zip(tfs, jfs):
        arrays = convert.forest_to_reference(f)
        assert set(arrays["cmesh"]) == set(TC.CMESH_FIELDS)
        for src in (arrays, {**arrays, "cmesh": jf.cmesh}):
            back = convert.forest_from_reference(src, device="cpu")
            assert isinstance(back.cmesh, TC.Cmesh)
            for k in TC.CMESH_FIELDS:
                np.testing.assert_array_equal(getattr(back.cmesh, k), getattr(f.cmesh, k))
            for k in ("anchor", "level", "stype", "tree", "keys"):
                assert torch.equal(getattr(back, k), getattr(f, k))
    back = [convert.forest_from_reference(dict(convert.forest_to_reference(f), cmesh=jf.cmesh),
                                          device="cpu") for f, jf in zip(tfs, jfs)]
    a, b = TF.balance(tfs, TF.SimComm(P)), TF.balance(back, TF.SimComm(P))
    for x, y in zip(a, b):
        assert torch.equal(x.keys, y.keys) and torch.equal(x.tree, y.tree)


def test_crossings_dispatch_one_transform_and_one_key_per_layer():
    """A cross-tree sweep layer costs one face sweep, one tree transform and
    one key recompute, whatever the number of connections it uses."""
    tfs, *_ = reference("periodic_cube_d3")
    f = tfs[0]
    tbatch.reset_dispatch_counts()
    lay = TF.face_sweep_layer(f, f.tree, f.simplices())
    assert int((lay.kind == TF.FACE_INTER_TREE).sum()) > 0
    assert not bool((lay.kind == TF.FACE_DOMAIN_BOUNDARY).any())   # fully periodic
    assert tbatch.dispatch_counts() == {"face_sweep": 1, "tree_transform": 1, "morton_key": 1}
