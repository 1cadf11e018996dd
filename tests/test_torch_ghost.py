"""The port's Ghost and `validate` against the JAX package, on the CPU.

Each Balance fixture of `test_torch_balance.py` is balanced by the port,
carried into JAX Forests, and given to both packages' `ghost` with
`overlap` both ways: every ghost field, the per-phase counters and every
payload posted must be equal.  The JAX package runs under
`use_backend("jnp")`.  `validate` must agree with the JAX package's on the
balanced forests with their ghosts (True) and on hand-broken copies (False):
stored order broken, an overlap, a ghost on a wrong owner, a ghost that
names its own rank.  The 14-byte wire quads that carry Ghost's queries
must be byte for byte the JAX package's."""

import hashlib

import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.core import forest as JF
from repro.core.types import pack_wire as jpack_wire
from repro_torch import convert
from repro_torch.core import forest as TF
from repro_torch.core import types as ttypes
from repro_torch.core.errors import WireFormatError
from test_torch_balance import CASES, _recording, assert_same_traffic, build


def _balanced(name, P):
    """The fixture balanced by the port, in both packages' forms."""
    _jfs, _jc, tfs, tc = build(name, P)
    tb = TF.balance(tfs, tc)
    return [JF.Forest(**convert.forest_to_reference(f)) for f in tb], tb


def _assert_same_ghosts(tg, jg):
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        for k in convert.GHOST_FIELDS:
            assert a[k].dtype == torch.int32 and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)


@pytest.mark.parametrize("name,P", CASES)
def test_ghost_matches_reference(name, P):
    jb, tb = _balanced(name, P)
    for overlap in (True, False):
        jc, tc = _recording(JF.SimComm, P), _recording(TF.SimComm, P)
        with jbatch.use_backend("jnp"):
            jg = JF.ghost(jb, jc, overlap=overlap)
            assert JF.validate(jb, jg)
        tg = TF.ghost(tb, tc, overlap=overlap)
        _assert_same_ghosts(tg, jg)
        assert_same_traffic(tc, jc, "ghost")
        assert tc.bytes_for("ghost") == jc.bytes_for("ghost")
        assert TF.validate(tb, tg)
    layers = sum(len(g["level"]) for g in tg)
    assert (layers > 0) == (P > 1 and name != "single_leaf_d2")


def test_ghost_layers_cross_to_the_reference_and_back():
    jb, tb = _balanced("fractal_d3", 3)
    tg = TF.ghost(tb, TF.SimComm(3))
    assert sum(len(g["level"]) for g in tg) > 0
    for g in tg:
        ref = convert.ghost_to_reference(g)
        assert all(ref[k].dtype == np.int32 for k in convert.GHOST_FIELDS)
        back = convert.ghost_from_reference(ref, device="cpu")
        for k in convert.GHOST_FIELDS:
            assert torch.equal(back[k], g[k])
    with jbatch.use_backend("jnp"):
        assert JF.validate(jb, [convert.ghost_to_reference(g) for g in tg])
    empty = convert.ghost_from_reference(JF._empty_ghost(3), device="cpu")
    assert empty["anchor"].shape == (0, 3)
    with pytest.raises(ValueError):
        convert.ghost_from_reference(dict(convert.ghost_to_reference(tg[0]),
                                          owner=np.zeros(1, np.int32)), device="cpu")


def _with(f, **cols):
    """A copy of a port forest with some element columns replaced (keys
    kept as given, not recomputed)."""
    import dataclasses

    return dataclasses.replace(f, **cols)


def _both_validate(tb, tg):
    jb = [JF.Forest(**convert.forest_to_reference(f)) for f in tb]
    jg = None if tg is None else [convert.ghost_to_reference(g) for g in tg]
    with jbatch.use_backend("jnp"):
        want = JF.validate(jb, jg)
    assert TF.validate(tb, tg) == want
    return want


def test_validate_agrees_with_reference_on_broken_forests():
    _jb, tb = _balanced("fractal_d2", 4)
    tg = TF.ghost(tb, TF.SimComm(4))
    assert _both_validate(tb, tg) is True
    # stored order: the first element of rank 1 moved to the end of rank 0
    a, b = tb[0], tb[1]
    cols = {k: torch.cat([getattr(a, k), getattr(b, k)[:1]]) for k in
            ("anchor", "level", "stype", "tree", "keys")}
    moved = [_with(a, **{k: v[[*range(a.num_local - 1), a.num_local, a.num_local - 1]]
                         for k, v in cols.items()}),
             _with(b, **{k: getattr(b, k)[1:] for k in cols})] + tb[2:]
    assert _both_validate(moved, None) is False
    # an overlap: the first child of a family replaced by its parent
    f = tb[2]
    o = f.ops
    _par, iloc = f.bops.parent_and_local_index(f.simplices())
    j = int(torch.nonzero((iloc == 0) & (f.level > 0))[0])
    p = o.parent(TF.Simplex(f.anchor[j:j + 1], f.level[j:j + 1], f.stype[j:j + 1]))
    over = _with(f, anchor=f.anchor.index_put((torch.tensor([j]),), p.anchor),
                 level=f.level.index_put((torch.tensor([j]),), p.level),
                 stype=f.stype.index_put((torch.tensor([j]),), p.stype),
                 keys=f.keys.index_put((torch.tensor([j]),), o.morton_key(p)))
    assert _both_validate(tb[:2] + [over] + tb[3:], None) is False
    # a ghost on the wrong owner, and one naming its own rank
    r = next(i for i, g in enumerate(tg) if len(g["level"]))
    for bad in ((tg[r]["owner"][0] + 1) % 4, torch.tensor(r, dtype=torch.int32)):
        if int(bad) == int(tg[r]["owner"][0]):
            bad = (bad + 1) % 4
        wrong = dict(tg[r], owner=tg[r]["owner"].index_put((torch.tensor([0]),), bad))
        assert _both_validate(tb, tg[:r] + [wrong] + tg[r + 1:]) is False


def test_wire_quads_match_reference_bytes():
    """pack_wire with a dual-face byte gives the JAX package's 14-byte quads
    on the rows of its wire digest test (tests/core/test_forest_messages.py),
    and unpack_wire(with_extra=True) inverts it."""
    rng = np.random.default_rng(42)
    t = rng.integers(0, 5, 200)
    k = rng.integers(0, 1 << 60, 200, dtype=np.uint64)
    lv = rng.integers(0, 21, 200)
    du = rng.integers(0, 4, 200)
    want = jpack_wire(t.astype(np.int32), k, lv.astype(np.int32), extra=du.astype(np.int32))
    got = ttypes.pack_wire(torch.from_numpy(t.astype(np.int32)),
                           torch.from_numpy(k.astype(np.int64)),
                           torch.from_numpy(lv.astype(np.int32)),
                           extra=torch.from_numpy(du.astype(np.int32)))
    assert got.size == 200 * ttypes.WIRE_QUAD_BYTES
    np.testing.assert_array_equal(got, want)
    assert (hashlib.sha256(got.tobytes()).hexdigest()
            == hashlib.sha256(want.tobytes()).hexdigest())
    tt, kk, ll, dd = ttypes.unpack_wire(got, with_extra=True)
    np.testing.assert_array_equal(tt, t)
    np.testing.assert_array_equal(kk, k)
    np.testing.assert_array_equal(ll, lv)
    np.testing.assert_array_equal(dd, du)
    with pytest.raises(WireFormatError):
        ttypes.unpack_wire(got[:-1], with_extra=True)
