"""The port's forest over the mixed-class mesh `cmesh_hybrid_pair(d)` (a
hex tree beside a Kuhn cube of simplex trees, their shared face a domain
boundary) against the JAX package on the CPU, as its
`test_mixed_class_pipeline_p2` runs it: New, a corner refined by a
recursive Adapt (in both classes), Partition, a weighted repartition,
Balance and Ghost per class group, merged back into stored order, and
validate — every forest field, ghost field, counter and payload digest
equal.  And the per-class functions' cost: one fused face sweep and one
routing eval per class per eval layer, the mixed run's count the sum of
the class groups' own runs (`test_mixed_class_dispatch_is_per_class_sum`),
read off the plain versions' per-class call counts.  This file runs d = 2;
`test_torch_hybrid_d3.py` d = 3."""

import functools

import numpy as np

from repro.core import batch as jbatch
from repro.core import cmesh as JC
from repro.core import forest as JF
from repro_torch import convert
from repro_torch.core import batch as tbatch
from repro_torch.core import cmesh as TC
from repro_torch.core import forest as TF
from repro_torch.core.types import ECLASS_HEX, ECLASS_SIMPLEX
from repro_torch.kernels import ref as kref
from test_torch_forest import _assert_same_forests, _recording
from test_torch_hex_forest import _digests, _pipeline

P = 2


def _level(d):
    return 2 if d == 2 else 1


@functools.lru_cache(maxsize=None)
def reference(d):
    """The JAX package's pipeline over the hybrid pair, with its dispatch
    counts of Balance and Ghost."""
    jcm = JC.cmesh_hybrid_pair(d)
    jc = _recording(JF.SimComm, P)
    with jbatch.use_backend("jnp"):
        out = _pipeline(JF, jc, jcm, d, _level(d), _level(d) + 2, as_tensor=False,
                        before_balance=jbatch.reset_dispatch_counts)
        counts = jbatch.dispatch_counts()
        assert JF.validate(out["balance"], out["ghost"])
    return out, jc, counts


def check_pipeline(d):
    want, jc, _counts = reference(d)
    tcm = TC.cmesh_hybrid_pair(d)
    tc = _recording(TF.SimComm, P)
    got = _pipeline(TF, tc, tcm, d, _level(d), _level(d) + 2, as_tensor=True, device="cpu")
    for stage in ("new", "adapt", "partition", "repartition", "balance"):
        _assert_same_forests(got[stage], want[stage])
    # both classes refined
    for ec in (ECLASS_HEX, ECLASS_SIMPLEX):
        lv = np.concatenate([f.level.numpy()[tcm.tree_eclass[f.tree.numpy()] == ec]
                             for f in got["adapt"]])
        assert lv.max() > _level(d)
    for a, b in zip(got["ghost"], want["ghost"], strict=True):
        for k in convert.GHOST_FIELDS:
            np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
    assert TF.validate(got["balance"], got["ghost"])
    assert tc.counters == jc.counters
    assert _digests(tc) == _digests(jc)


def check_dispatch_is_per_class_sum(d):
    """Balance and then Ghost over the hybrid pair: the mixed run's face
    sweeps and routing evals, per class, equal the sums over the class
    groups run through the one-class functions directly; the batched meters
    equal the JAX package's."""
    want, _jc, jcounts = reference(d)
    tcm = TC.cmesh_hybrid_pair(d)
    fs = [convert.forest_from_reference(dict({k: getattr(f, k) for k in convert.FIELDS},
                                             cmesh=tcm), device="cpu")
          for f in want["repartition"]]
    names = ("face_sweep", "eval_route")

    def meter(fn):
        kref.reset_call_counts()
        out = fn()
        return out, {k: dict(kref.class_call_counts[k]) for k in names}

    tbatch.reset_dispatch_counts()
    bal, mixed_b = meter(lambda: TF.balance(fs, TF.SimComm(P)))
    _g, mixed_g = meter(lambda: TF.ghost(bal, TF.SimComm(P)))
    tcounts = tbatch.dispatch_counts()
    for k in names:
        assert tcounts[k] == jcounts[k]
    per_b = {k: {"simplex": 0, "hex": 0} for k in names}
    per_g = {k: {"simplex": 0, "hex": 0} for k in names}
    for ec in tcm.eclasses:
        _b, cb = meter(lambda: TF._balance_impl(TF._class_subforests(fs, ec), TF.SimComm(P),
                                                64, True, ec))
        _x, cg = meter(lambda: TF._ghost_impl(TF._class_subforests(bal, ec), TF.SimComm(P),
                                              True, ec))
        for k in names:
            for cls in ("simplex", "hex"):
                per_b[k][cls] += cb[k][cls]
                per_g[k][cls] += cg[k][cls]
    assert mixed_b == per_b and mixed_g == per_g
    assert all(v > 0 for k in names for v in mixed_b[k].values())


def test_hybrid_pipeline_matches_reference():
    check_pipeline(2)


def test_mixed_class_dispatch_is_per_class_sum():
    check_dispatch_is_per_class_sum(2)
