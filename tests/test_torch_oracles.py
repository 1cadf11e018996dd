"""The port's global-table oracles against the JAX package's, on the CPU.

Each case's forests are built by the port on `device="cpu"` (New -> corner
Adapt -> Partition) and carried into JAX Forests over the JAX package's own
coarse mesh.  `balance_oracle` must give the JAX package's forests and
`bytes_for("balance_oracle")`; `ghost_oracle` of the balanced forests its
layers and `bytes_for("ghost_oracle")`; and each port oracle must equal the
port's own message-based `balance` and `ghost`.  Cases: simplex forests at
d = 2 without a coarse mesh (one with empty ranks), a periodic brick of
tetrahedral trees (d = 3, faces crossed by `tree_transform`), a periodic
hex brick and the hybrid hex|tet pair.  `max_rounds=1` on a ripple raises `BalanceNonConvergence` with the
JAX package's dirty counts, and `max_rounds=0` a ValueError.  The JAX
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
from test_torch_forest import _assert_same_forests


def _corner(cap):
    def cb(tree, e):
        return ((tree == 0) & (e.anchor.sum(1) == 0) & (e.level < cap)).to(torch.int32)
    return cb


# name: (cmesh constructor and arguments or None, d, trees, base level,
# corner refinement cap, ranks)
CASES = {
    "simplex_d2": (None, 2, 2, 1, 5, 4),
    "empty_rank_d2": (None, 2, 1, 0, 4, 3),
    "brick_d3": (("cmesh_brick", (3, (2, 1, 1)), {"periodic": (True, False, False)}), 3, 12, 0,
                 2, 3),
    "hex_brick_d2": (("cmesh_hex_brick", (2, (2, 2)), {"periodic": (True, True)}), 2, 4, 1, 4,
                     3),
    "hybrid_d2": (("cmesh_hybrid_pair", (2,), {}), 2, 3, 1, 4, 2),
}


def build(name):
    """The case's port forests before Balance on SimComm(P), the same as
    JAX Forests, and P."""
    spec, d, trees, level, cap, P = CASES[name]
    tcm = jcm = None
    if spec is not None:
        fn, args, kw = spec
        tcm, jcm = getattr(TC, fn)(*args, **kw), getattr(JC, fn)(*args, **kw)
        assert tcm.num_trees == trees
    comm = TF.SimComm(P)
    fs = TF.new_uniform(d, trees, level, comm, cmesh=tcm, device="cpu")
    fs = TF.partition([TF.adapt(f, _corner(cap), recursive=True) for f in fs], comm)
    jfs = [JF.Forest(**dict(convert.forest_to_reference(f), cmesh=jcm)) for f in fs]
    return fs, jfs, jcm, P


@functools.lru_cache(maxsize=None)
def reference(name):
    """The JAX package's oracles on the case: (port forests, JAX balanced
    forests, JAX ghost layers, bytes_for of both oracle phases, JAX cmesh, P)."""
    fs, jfs, jcm, P = build(name)
    jc = JF.SimComm(P)
    with jbatch.use_backend("jnp"):
        jb = JF.balance_oracle(jfs, jc)
        jg = JF.ghost_oracle(jb, jc)
    return fs, jb, jg, (jc.bytes_for("balance_oracle"), jc.bytes_for("ghost_oracle")), jcm, P


def _assert_same_layers(tg, jg):
    for a, b in zip(tg, jg, strict=True):
        for k in convert.GHOST_FIELDS:
            assert a[k].dtype == torch.int32 and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_oracles_match_reference(name):
    fs, jb, jg, jbytes, _jcm, P = reference(name)
    tc = TF.SimComm(P)
    tb = TF.balance_oracle(fs, tc)
    _assert_same_forests(tb, jb)
    tg = TF.ghost_oracle(tb, tc)
    _assert_same_layers(tg, jg)
    assert (tc.bytes_for("balance_oracle"), tc.bytes_for("ghost_oracle")) == jbytes
    assert TF.count_global(tb) > TF.count_global(fs)
    assert (sum(len(g["level"]) for g in tg) > 0) == (P > 1)


@pytest.mark.parametrize("name", list(CASES))
def test_oracles_equal_message_based_balance_and_ghost(name):
    fs, _jb, _jg, _bytes, _jcm, P = reference(name)
    oc, mc = TF.SimComm(P), TF.SimComm(P)
    ob, mb = TF.balance_oracle(fs, oc), TF.balance(fs, mc)
    for a, b in zip(ob, mb, strict=True):
        for k in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    for a, b in zip(TF.ghost_oracle(ob, oc), TF.ghost(mb, mc), strict=True):
        for k in convert.GHOST_FIELDS:
            assert torch.equal(a[k], b[k]), k
    assert TF.validate(ob, TF.ghost_oracle(ob, TF.SimComm(P)))


def test_balance_oracle_budget_errors_match_reference():
    """One round cannot settle the d = 2 ripple: both packages raise
    BalanceNonConvergence with the same rounds and per-rank dirty counts;
    zero rounds is a ValueError in both."""
    fs, jfs, _jcm, P = build("simplex_d2")
    with jbatch.use_backend("jnp"), pytest.raises(JF.BalanceNonConvergence) as want:
        JF.balance_oracle(jfs, JF.SimComm(P), max_rounds=1)
    with pytest.raises(TF.BalanceNonConvergence) as got:
        TF.balance_oracle(fs, TF.SimComm(P), max_rounds=1)
    assert got.value.rounds == want.value.rounds == 1
    assert got.value.dirty_per_rank == want.value.dirty_per_rank
    assert sum(got.value.dirty_per_rank) > 0
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="max_rounds"):
        JF.balance_oracle(jfs, JF.SimComm(P), max_rounds=0)
    with pytest.raises(ValueError, match="max_rounds"):
        TF.balance_oracle(fs, TF.SimComm(P), max_rounds=0)
