"""The port's pure-hex forest against the JAX package, on the CPU: the
cases of the JAX package's `tests/core/test_forest_eclass.py` (a brick of
hex trees, a corner refined by a recursive Adapt), through New -> Adapt ->
Partition -> weighted repartition -> Balance -> Ghost -> validate, and the
forests carried between the packages by `convert`.  This file runs the
d = 3 case; `test_torch_hex_forest_d2.py` the d = 2 ones, so that each
file's JAX programs compile for one dimension.

Every forest field and key, every ghost field, every per-phase byte count
and every payload posted (by its SHA-256, in order) must be equal.  The JAX
package runs under `use_backend("jnp")`, once per case (cached: its
multitree programs take seconds to compile).  Also: the at-rest and wire
bytes of the hex leaves."""

import functools
import hashlib

import numpy as np
import torch

from repro.core import batch as jbatch
from repro.core import cmesh as JC
from repro.core import comm as jcomm
from repro.core import forest as JF
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import cmesh as TC
from repro_torch.core import comm as tcomm
from repro_torch.core import forest as TF
from repro_torch.core import types as ttypes
from repro_torch.core.types import ECLASS_HEX
from test_torch_forest import _assert_same_forests, _recording

# name: (d, brick shape, periodic axes, base level, corner cap, ranks): the
# JAX package's hex cases (test_hex_pipeline_vs_oracles: d = 2 at level 2,
# d = 3 at level 1, corner refined two levels deeper), and a periodic
# 2 x 2 brick whose Balance crosses the wrapped faces.
CASES = {
    "brick_d2": (2, (2, 1), None, 2, 4, 2),
    "brick_d3": (3, (2, 1, 1), None, 1, 3, 2),
    "periodic_d2": (2, (2, 2), (True, True), 1, 4, 3),
}


def _corner_np(cap):
    return lambda t, e: ((np.asarray(e.anchor).sum(axis=1) == 0)
                         & (np.asarray(e.level) < cap)).astype(np.int32)


def _corner_torch(cap):
    return lambda t, e: ((e.anchor.sum(1) == 0) & (e.level < cap)).to(torch.int32)


def _weights(fs, cap, as_tensor):
    if as_tensor:
        return [1.0 + (f.level == cap).double() for f in fs]
    return [1.0 + (f.level == cap).astype(np.float64) for f in fs]


def _digests(comm):
    """Per phase, the SHA-256 of every payload posted, in order."""
    out = {}
    codec = jcomm if isinstance(comm, JF.SimComm) else tcomm
    for phase, payload in comm.posted:
        out.setdefault(phase, hashlib.sha256()).update(codec.encode_payload(payload))
    return {k: v.hexdigest() for k, v in out.items()}


def _pipeline(F, comm, cm, d, level, cap, as_tensor, device=None, before_balance=None):
    """New -> corner Adapt -> Partition -> weighted repartition -> Balance
    -> Ghost of one package (`before_balance()` called just before
    Balance); every stage's forests."""
    kw = {} if device is None else {"device": device}
    out = {"new": F.new_uniform(d, cm.num_trees, level, comm, cmesh=cm, **kw)}
    cb = _corner_torch(cap) if as_tensor else _corner_np(cap)
    out["adapt"] = [F.adapt(f, cb, recursive=True) for f in out["new"]]
    out["partition"] = F.partition(out["adapt"], comm)
    out["repartition"] = F.repartition(out["partition"], comm,
                                       weights=_weights(out["partition"], cap, as_tensor))
    if before_balance is not None:
        before_balance()
    out["balance"] = F.balance(out["repartition"], comm)
    out["ghost"] = F.ghost(out["balance"], comm)
    return out


@functools.lru_cache(maxsize=None)
def reference(name):
    d, shape, periodic, level, cap, P = CASES[name]
    jcm = JC.cmesh_hex_brick(d, shape, periodic=periodic)
    jc = _recording(JF.SimComm, P)
    with jbatch.use_backend("jnp"):
        out = _pipeline(JF, jc, jcm, d, level, cap, as_tensor=False)
        assert JF.validate(out["balance"], out["ghost"])
    return out, jc


def check_pipeline(name):
    """The port's pipeline of case `name` against the JAX package's, stage
    by stage: forests, ghosts, counters and payload digests."""
    d, shape, periodic, level, cap, P = CASES[name]
    want, jc = reference(name)
    tcm = TC.cmesh_hex_brick(d, shape, periodic=periodic)
    tc = _recording(TF.SimComm, P)
    got = _pipeline(TF, tc, tcm, d, level, cap, as_tensor=True, device="cpu")
    for stage in ("new", "adapt", "partition", "repartition", "balance"):
        _assert_same_forests(got[stage], want[stage])
        assert all(f.eclass == ECLASS_HEX for f in got[stage])
    assert TF.count_global(got["balance"]) > TF.count_global(got["repartition"])
    for a, b in zip(got["ghost"], want["ghost"], strict=True):
        for k in convert.GHOST_FIELDS:
            np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
    assert sum(len(g["level"]) for g in got["ghost"]) > 0
    assert TF.validate(got["balance"], got["ghost"])
    assert tc.counters == jc.counters
    for phase in ("partition", "repartition", "balance", "ghost"):
        assert tc.bytes_for(phase) == jc.bytes_for(phase)
    assert _digests(tc) == _digests(jc)


def check_crossing(name):
    """The JAX package's partitioned hex forests, carried into the port by
    `convert` (with their `eclass`), balance and ghost like the JAX
    package's own; and back, they equal the JAX forests field for field."""
    d, shape, periodic, level, cap, P = CASES[name]
    want, jc = reference(name)
    tfs = []
    for jf in want["repartition"]:
        arrays = {k: getattr(jf, k) for k in convert.FIELDS}
        tf = convert.forest_from_reference(dict(arrays, eclass=jf.eclass), device="cpu")
        back = convert.forest_to_reference(tf)
        for k in ("anchor", "level", "stype", "tree", "keys"):
            np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
        tfs.append(tf)
    tc = TF.SimComm(P)
    tb = TF.balance(tfs, tc)
    _assert_same_forests(tb, want["balance"])
    tg = TF.ghost(tb, tc)
    for a, b in zip(tg, want["ghost"], strict=True):
        for k in convert.GHOST_FIELDS:
            np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
    for phase in ("balance", "ghost"):
        assert tc.bytes_for(phase) == jc.bytes_for(phase)


def test_hex_pipeline_matches_reference():
    check_pipeline("brick_d3")


def test_hex_forests_cross_between_the_packages():
    check_crossing("brick_d3")


def test_hex_leaves_at_rest_and_on_the_wire():
    """The balanced hex leaves at rest (13 bytes a hexahedron, no type
    column) and as wire triples tagged with the hex class, as the JAX
    package encodes them."""
    want, _jc = reference("brick_d3")
    tfs = [convert.forest_from_reference(
        {k: getattr(jf, k) for k in convert.FIELDS}, device="cpu") for jf in want["balance"]]
    for tf, jf in zip(tfs, want["balance"], strict=True):
        ts, js = tf.simplices(), jf.simplices()
        assert ttypes.nbytes_at_rest(ts, ECLASS_HEX) == jtypes.nbytes_at_rest(js, ECLASS_HEX)
        assert ttypes.nbytes_at_rest(ts, ECLASS_HEX) == 13 * tf.num_local
        got, ref = ttypes.pack(ts, ECLASS_HEX), jtypes.pack(js, ECLASS_HEX)
        assert set(got) == set(ref) == {"anchor", "level"}
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        wire = ttypes.pack_wire(tf.tree, tf.keys, tf.level, eclass=ECLASS_HEX)
        assert wire.tobytes() == jtypes.pack_wire(jf.tree, jf.keys, jf.level,
                                                  eclass=ECLASS_HEX).tobytes()
        cols = ttypes.unpack_wire(wire, with_eclass=True)
        assert (cols[3] == ECLASS_HEX).all() and (cols[1] == jf.keys).all()
