"""The port's Balance against the JAX package, element for element and byte
for byte, on the CPU.

Fixtures, each on `SimComm(P)`: the cmesh-free `single_tree_d3` of the JAX
package's `tests/core/test_forest_messages.py` (2 trees, corner refinement
of tree 0 from level 1 to 3); a d = 2 patch of tree 0 refined from level 1
to 6 and partitioned, so that the ripple takes several rounds across
ranks; the slice-1 forest (fractal refinement and coarsening of the upper
trees, then Partition) at d = 2 and d = 3; a single level-0 leaf refined on
one of four ranks (three empty ranks); and d = 3 forests that start at
level 0 and level 1, whose level-0 spans (2^63) do not fit an int64.  P runs over 1 to 4.  Each case runs
with `overlap` both ways in both packages; forests, per-phase counters and
every payload posted must be equal.  The port builds each fixture and
carries it into the JAX package (their New -> Adapt -> Partition are held
equal by `test_torch_pipeline_d*.py`); the JAX package balances under
`use_backend("jnp")`."""

import pytest
import torch

from repro.core import batch as jbatch
from repro.core import comm as jcomm
from repro.core import forest as JF
from repro_torch import convert
from repro_torch.core import comm as tcomm
from repro_torch.core import forest as TF
from repro_torch.core.ops import get_ops
from test_torch_forest import (_assert_same_forests, _coarsen_upper_torch, _fractal_torch,
                               _recording)


def _corner(deep, tree0_only):
    """Refine elements anchored at the origin (of tree 0 only, or of every
    tree) below `deep`."""
    def cb(tree, e):
        m = (e.anchor.sum(1) == 0) & (e.level < deep)
        if tree0_only:
            m &= tree == 0
        return m.to(torch.int32)
    return cb


def _cube(d, region, deep):
    """Refine every element of tree 0 inside the origin cube of level
    `region` down to level `deep`: a patch whose outside neighbors stay
    coarse, so Balance ripples outwards over several rounds."""
    side = 1 << (get_ops(d).L - region)

    def cb(tree, e):
        m = (e.anchor < side).all(1) & (e.level < deep)
        return (m & (tree == 0)).to(torch.int32)
    return cb


# name: (d, trees, base level, refinement, partition after it)
FIXTURES = {
    "single_tree_d3": (3, 2, 1, ("corner", 3, True), False),
    "ripple_d2": (2, 2, 1, ("cube", 2, 6), True),
    "fractal_d3": (3, 4, 1, ("fractal", 3), True),
    "fractal_d2": (2, 4, 1, ("fractal", 3), True),
    "single_leaf_d2": (2, 1, 0, ("corner", 6, False), False),
    "level0_d3": (3, 2, 0, ("cube", 1, 3), True),
    "level1_d3": (3, 1, 1, ("cube", 2, 4), True),
}
CASES = [("single_tree_d3", 4), ("single_tree_d3", 1), ("ripple_d2", 2), ("fractal_d3", 3),
         ("fractal_d2", 4), ("single_leaf_d2", 4), ("level0_d3", 2), ("level1_d3", 3)]


def build(name, P):
    """The fixture's forests before Balance, built by the port and carried
    into JAX Forests (the two packages' New -> Adapt -> Partition are held
    equal by `test_torch_pipeline_d*.py`), on recording communicators:
    (jfs, jc, tfs, tc)."""
    d, trees, base, how, part = FIXTURES[name]
    jc, tc = _recording(JF.SimComm, P), _recording(TF.SimComm, P)
    tfs = TF.new_uniform(d, trees, base, tc, device="cpu")
    if how[0] == "fractal":
        tfs = [TF.adapt(f, _fractal_torch(d, how[1]), recursive=True) for f in tfs]
        tfs = [TF.adapt(f, _coarsen_upper_torch(trees, how[1])) for f in tfs]
    else:
        cb = _corner(*how[1:]) if how[0] == "corner" else _cube(d, *how[1:])
        tfs = [TF.adapt(f, cb, recursive=True) for f in tfs]
    if part:
        tfs = TF.partition(tfs, tc)
    jfs = [JF.Forest(**convert.forest_to_reference(f)) for f in tfs]
    return jfs, jc, tfs, tc


def assert_same_traffic(tc, jc, phase):
    """Equal counters of `phase`, and every payload posted in it encodes to
    the reference's bytes, in the same order."""
    assert tc.counters[phase] == jc.counters[phase]
    got, want = ([x for ph, x in c.posted if ph == phase] for c in (tc, jc))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert tcomm.encode_payload(g) == jcomm.encode_payload(w)


@pytest.mark.parametrize("name,P", CASES)
def test_balance_matches_reference(name, P):
    jfs, _jc, tfs, _tc = build(name, P)
    for overlap in (True, False):
        jc, tc = _recording(JF.SimComm, P), _recording(TF.SimComm, P)
        with jbatch.use_backend("jnp"):
            jb = JF.balance(jfs, jc, overlap=overlap)
        tb = TF.balance(tfs, tc, overlap=overlap)
        _assert_same_forests(tb, jb)
        assert_same_traffic(tc, jc, "balance")
        assert tc.bytes_for("balance") == jc.bytes_for("balance")
        assert TF.validate(tb)
    assert TF.count_global(tb) > TF.count_global(tfs)
    if P > 1 and name != "single_leaf_d2":
        assert tc.counters["balance"]["alltoallv_bytes"] > 0


def test_balance_fixtures_cover_what_they_claim():
    """Empty ranks, several refining rounds and level-0 elements are in the
    fixtures above."""
    _jfs, _jc, tfs, _tc = build("single_leaf_d2", 4)
    assert [f.num_local == 0 for f in tfs].count(True) == 3
    _jfs, _jc, tfs, _tc = build("level0_d3", 2)
    assert (torch.cat([f.level for f in tfs]) == 0).any()
    _jfs, _jc, tfs, tc = build("ripple_d2", 2)
    TF.balance(tfs, tc)
    assert tc.counters["balance"]["allgather_calls"] - 1 >= 3   # evaluation rounds


def test_balance_non_convergence_matches_reference():
    """With max_rounds=1 a ripple that needs more rounds raises
    BalanceNonConvergence in both packages, with the same diagnostics."""
    jfs, jc, tfs, tc = build("ripple_d2", 2)
    with jbatch.use_backend("jnp"), pytest.raises(JF.BalanceNonConvergence) as je:
        JF.balance(jfs, jc, max_rounds=1)
    with pytest.raises(TF.BalanceNonConvergence) as te:
        TF.balance(tfs, tc, max_rounds=1)
    assert te.value.rounds == je.value.rounds == 1
    assert te.value.dirty_per_rank == je.value.dirty_per_rank
    assert sum(te.value.dirty_per_rank) > 0
    with pytest.raises(ValueError):
        TF.balance(tfs, tc, max_rounds=0)


def test_balance_result_crosses_back_into_the_reference():
    """A forest balanced by the port is balanced for the JAX package too:
    carried into JAX Forests, a JAX Balance changes nothing."""
    _jfs, _jc, tfs, tc = build("fractal_d3", 3)
    tb = TF.balance(tfs, tc)
    back = [JF.Forest(**convert.forest_to_reference(f)) for f in tb]
    with jbatch.use_backend("jnp"):
        again = JF.balance(back, JF.SimComm(3))
    _assert_same_forests(tb, again)
