"""The port's Iterate against the JAX package's, on the CPU.

Each case's forest is built by the port on `device="cpu"` and carried into
a JAX Forest over the JAX package's own coarse mesh; both packages'
`iterate` run with an `elem_fn` and a `face_fn`.  The pair arrays must be
equal row for row, order included, and `elem_fn` must see the same trees
and elements.  Cases: those of the JAX package's iterate tests
(`tests/core/test_forest.py::test_iterate_faces`,
`test_forest_multitree.py`'s periodic cube, hanging and cross-tree pairs
and cross-tree pair count, `test_forest_eclass.py`'s periodic hex brick),
an adapted and balanced forest with hanging faces at d = 2 and d = 3, the
hybrid hex|tet pair, and a `SimComm(3)` forest with an empty rank.  The JAX
package runs under `use_backend("jnp")`, once a case (cached)."""

import functools

import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.core import cmesh as JC
from repro.core import forest as JF
from repro_torch import convert
from repro_torch.core import cmesh as TC
from repro_torch.core import forest as TF


def _corner(cap, tree0_only=True):
    def cb(tree, e):
        m = (e.anchor.sum(1) == 0) & (e.level < cap)
        return ((m & (tree == 0)) if tree0_only else m).to(torch.int32)
    return cb


# name: (cmesh constructor and arguments or None, d, trees, level, corner
# refinement cap (None: uniform), Balance after it, ranks)
CASES = {
    "uniform_d3": (None, 3, 1, 2, None, False, 1),
    "periodic_cube_d2": (("cmesh_unit_cube", (2,), {"periodic": (True, True)}), 2, 2, 2, None,
                         False, 1),
    "periodic_cube_d3": (("cmesh_unit_cube", (3,), {"periodic": (True,) * 3}), 3, 6, 1, None,
                         False, 1),
    "hanging_cross_tree_d2": (("cmesh_unit_cube", (2,), {}), 2, 2, 2, 4, True, 1),
    "cross_tree_d2": (("cmesh_unit_cube", (2,), {}), 2, 2, 2, None, False, 1),
    "no_cmesh_d2": (None, 2, 2, 2, None, False, 1),
    "hex_periodic_d2": (("cmesh_hex_brick", (2, (2, 2)), {"periodic": (True, True)}), 2, 4, 2,
                        None, False, 1),
    "balanced_d2": (None, 2, 2, 1, 5, True, 1),
    "balanced_d3": (None, 3, 2, 1, 3, True, 1),
    "periodic_brick_d3": (("cmesh_brick", (3, (2, 1, 1)), {"periodic": (True, False, False)}), 3,
                          12, 0, 2, True, 1),
    "hybrid_d2": (("cmesh_hybrid_pair", (2,), {}), 2, 3, 1, 4, True, 2),
    "hybrid_d3": (("cmesh_hybrid_pair", (3,), {}), 3, 7, 1, 3, True, 1),
    "empty_rank_d2": (None, 2, 1, 0, 1, False, 3),
}


def build(name):
    """The case's port forests on the CPU and the same as JAX Forests."""
    spec, d, trees, level, cap, bal, P = CASES[name]
    tcm = jcm = None
    if spec is not None:
        fn, args, kw = spec
        tcm, jcm = getattr(TC, fn)(*args, **kw), getattr(JC, fn)(*args, **kw)
        assert tcm.num_trees == trees
    comm = TF.SimComm(P)
    fs = TF.new_uniform(d, trees, level, comm, cmesh=tcm, device="cpu")
    if cap is not None:
        fs = [TF.adapt(f, _corner(cap), recursive=True) for f in fs]
    if bal:
        fs = TF.balance(fs, comm)
    jfs = [JF.Forest(**dict(convert.forest_to_reference(f), cmesh=jcm)) for f in fs]
    return fs, jfs


def _elem(tree, e):
    return tuple(np.asarray(x).copy() for x in (tree, e.anchor, e.level, e.stype))


def _face(f, pairs):
    return pairs


@functools.lru_cache(maxsize=None)
def reference(name):
    """The port's forests and the JAX package's iterate results, per rank."""
    fs, jfs = build(name)
    with jbatch.use_backend("jnp"):
        want = [JF.iterate(jf, elem_fn=_elem, face_fn=_face) for jf in jfs]
    return fs, want


@pytest.mark.parametrize("name", list(CASES))
def test_iterate_matches_reference(name):
    fs, want = reference(name)
    for f, (welem, wpairs) in zip(fs, want, strict=True):
        elem, pairs = TF.iterate(f, elem_fn=_elem, face_fn=_face)
        assert pairs.dtype == torch.int64 and pairs.device.type == "cpu"
        assert pairs.shape == (len(wpairs), 4)
        np.testing.assert_array_equal(pairs.numpy(), wpairs)
        for a, b in zip(elem, welem, strict=True):
            np.testing.assert_array_equal(a, b)


def _hanging(f, pairs):
    return int((f.level[pairs[:, 0]] != f.level[pairs[:, 1]]).sum())


def test_pair_counts_of_the_reference_tests():
    """The closed forms the JAX package's tests hold: interior faces of one
    uniform tet, (d + 1) n / 2 on the periodic cube, 2n on the periodic hex
    brick, the 2-tree square's diagonal pairs, and hanging pairs one level
    apart, fine side first."""
    def count(name):
        f = reference(name)[0][0]
        pairs = TF.iterate(f, face_fn=_face)[0]
        return f, pairs

    f, p = count("uniform_d3")
    assert len(p) == (4 * f.num_local - 4 * 16) // 2
    for name, nf in (("periodic_cube_d2", 3), ("periodic_cube_d3", 4), ("hex_periodic_d2", 4)):
        f, p = count(name)
        assert len(p) == nf * f.num_local // 2
    f, p = count("cross_tree_d2")
    assert len(p) == (3 * f.num_local - 4 * 4) // 2
    assert len(p) - len(count("no_cmesh_d2")[1]) == 4
    for name in ("hanging_cross_tree_d2", "balanced_d3", "hybrid_d2"):
        fs = reference(name)[0]
        for f in fs:
            p = TF.iterate(f, face_fn=_face)[0]
            fine, coarse = f.level[p[:, 0]], f.level[p[:, 1]]
            assert bool(((fine == coarse) | (fine == coarse + 1)).all())
        assert sum(_hanging(f, TF.iterate(f, face_fn=_face)[0]) for f in fs) > 0


def test_hanging_face_without_coarse_facet_raises():
    """A coarse leaf whose key covers the neighbor but none of whose facets
    holds the shared face (a forest whose anchors were moved, keys kept)
    is refused, by both packages alike."""
    import dataclasses

    f = reference("balanced_d2")[0][0]
    p = TF.iterate(f, face_fn=_face)[0]
    j = int(p[f.level[p[:, 0]] != f.level[p[:, 1]]][0, 1])
    anchor = f.anchor.clone()
    anchor[j] += torch.tensor([1, 2], dtype=torch.int32) << (f.ops.L - int(f.level[j]))
    bad = dataclasses.replace(f, anchor=anchor)
    with pytest.raises(AssertionError, match="hanging face without coarse facet"):
        TF.iterate(bad, face_fn=_face)
    with jbatch.use_backend("jnp"), pytest.raises(AssertionError, match="without coarse facet"):
        JF.iterate(JF.Forest(**convert.forest_to_reference(bad)), face_fn=_face)
