"""The PyTorch port's foundations against the JAX package, exactly:
SFC tables, element byte encodings (at rest and on the wire), int64 keys,
the payload codec with its byte meters, and the partition rule.

Inputs are made from numpy seeds and handed to both packages."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import placement as jplacement
from repro.core import tables as jtables
from repro.core import types as jtypes
from repro.core import u64 as u64m
from repro_torch.core import comm as tcomm
from repro_torch.core import keys as tkeys
from repro_torch.core import placement as tplacement
from repro_torch.core import tables as ttables
from repro_torch.core import types as ttypes
from repro_torch.core.errors import WireFormatError


def _elements(d, n, seed):
    """Random (anchor, level, stype) numpy columns of in-domain elements."""
    rng = np.random.default_rng(seed)
    L = ttables.MAXLEVEL[d]
    anchor = rng.integers(0, 1 << L, size=(n, d)).astype(np.int32)
    level = rng.integers(0, L + 1, size=n).astype(np.int32)
    stype = rng.integers(0, 2 if d == 2 else 6, size=n).astype(np.int32)
    return anchor, level, stype


def _wire_columns(n, seed):
    rng = np.random.default_rng(seed)
    tree = rng.integers(0, 1 << 20, n).astype(np.int32)
    key = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    level = rng.integers(0, 22, n).astype(np.int32)
    extra = rng.integers(0, 4, n).astype(np.int32)
    return tree, key, level, extra


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("d", [2, 3])
def test_tables_equal_reference(d):
    got, want = ttables.get_tables(d), jtables.get_tables(d)
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, field.name
        np.testing.assert_array_equal(g, w, err_msg=field.name)
    assert ttables.MAXLEVEL == jtables.MAXLEVEL == {2: 30, 3: 21}


# ------------------------------------------------------------- at rest
def test_simplex_pack_blob_golden_bytes():
    """The at-rest blob is pinned byte for byte (the JAX package's golden
    blob): int32 LE anchor rows, int8 level, int8 type."""
    s = ttypes.Simplex(torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
                       torch.tensor([7, 8], dtype=torch.int32),
                       torch.tensor([0, 5], dtype=torch.int32))
    blob = ttypes.pack(s)
    assert sorted(blob.keys()) == ["anchor", "level", "stype"]
    assert blob["anchor"].tobytes() == (
        b"\x01\x00\x00\x00\x02\x00\x00\x00\x03\x00\x00\x00"
        b"\x04\x00\x00\x00\x05\x00\x00\x00\x06\x00\x00\x00")
    assert blob["level"].tobytes() == b"\x07\x08"
    assert blob["stype"].tobytes() == b"\x00\x05"
    ref = jtypes.pack(jtypes.simplex(np.array([[1, 2, 3], [4, 5, 6]], np.int32), [7, 8], [0, 5]))
    for k in ref:
        assert blob[k].tobytes() == ref[k].tobytes()


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 257])
def test_pack_unpack_match_reference(d, n):
    a, lv, b = _elements(d, n, seed=10 * d + n)
    blob = ttypes.pack(ttypes.Simplex(*(torch.from_numpy(x) for x in (a, lv, b))))
    ref = jtypes.pack(jtypes.simplex(a, lv, b))
    assert sorted(blob) == sorted(ref)
    for k in ref:
        assert blob[k].dtype == ref[k].dtype and blob[k].tobytes() == ref[k].tobytes()
    assert sum(x.nbytes for x in blob.values()) == n * (4 * d + 2)  # 10 B/tri, 14 B/tet
    back = ttypes.unpack(ref, device="cpu")
    for got, want in zip(back, (a, lv, b)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ wire
@pytest.mark.parametrize("n", [0, 1, 300])
def test_pack_wire_bytes_match_reference(n):
    tree, key, level, _ = _wire_columns(n, seed=n)
    want = jtypes.pack_wire(tree, key, level)
    got = ttypes.pack_wire(torch.from_numpy(tree), torch.from_numpy(key.astype(np.int64)),
                           torch.from_numpy(level))
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert got.size == n * ttypes.WIRE_TRIPLE_BYTES
    for g, w in zip(ttypes.unpack_wire(want), jtypes.unpack_wire(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("extra", [False, True])
def test_wire_hex_entries_match_reference(extra):
    """Entries tagged with the hex class (bits 6-7 of the level byte), one
    class for all or a column of both: the bytes the JAX package packs, and
    its columns, class column included, when unpacked."""
    tree, key, level, ex = _wire_columns(9, seed=3)
    ex = ex if extra else None
    for ec in (ttypes.ECLASS_HEX, np.arange(9) % 2):
        want = jtypes.pack_wire(tree, key, level, extra=ex, eclass=ec)
        got = ttypes.pack_wire(torch.from_numpy(tree), torch.from_numpy(key.astype(np.int64)),
                               torch.from_numpy(level), extra=ex, eclass=ec)
        assert got.tobytes() == want.tobytes()
        for g, w in zip(ttypes.unpack_wire(want, with_extra=extra, with_eclass=True),
                        jtypes.unpack_wire(want, with_extra=extra, with_eclass=True),
                        strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        ttypes.pack_wire(tree, key, level, eclass=2)


@pytest.mark.parametrize("mutate", ["truncate", "negative_tree", "eclass", "not_bytes"])
def test_unpack_wire_rejects_malformed(mutate):
    tree, key, level, _ = _wire_columns(5, seed=4)
    buf = jtypes.pack_wire(tree, key, level).copy()
    if mutate == "truncate":
        buf = buf[:-1]
    elif mutate == "negative_tree":
        buf[8:12] = np.frombuffer(np.int32(-1).tobytes(), np.uint8)
    elif mutate == "eclass":
        buf[12] |= 3 << ttypes.WIRE_ECLASS_SHIFT
    else:
        buf = np.array(["x"])
    with pytest.raises(WireFormatError):
        ttypes.unpack_wire(buf)
    with pytest.raises(ValueError):   # the reference rejects it too
        jtypes.unpack_wire(buf)


# ------------------------------------------------------------------ keys
def test_int64_keys_convert_to_reference_forms():
    rng = np.random.default_rng(5)
    k = rng.integers(0, 1 << 63, 1000, dtype=np.uint64)
    t = tkeys.from_u64(k, "cpu")
    assert t.dtype == torch.int64 and bool((t >= 0).all())
    np.testing.assert_array_equal(tkeys.to_u64(t), k)
    hi, lo = tkeys.to_pair(t)
    ref = u64m.from_int(k)
    np.testing.assert_array_equal(hi, np.asarray(ref.hi))
    np.testing.assert_array_equal(lo, np.asarray(ref.lo))
    assert torch.equal(tkeys.from_pair(np.asarray(ref.hi), np.asarray(ref.lo), "cpu"), t)
    with pytest.raises(ValueError):
        tkeys.from_u64(np.array([1 << 63], np.uint64), "cpu")


# ------------------------------------------------------------------ codec
def _payloads():
    tree, key, level, extra = _wire_columns(37, seed=6)
    return [
        [1.5, 2.0, 0.0],                                    # weight totals
        [(0, 123456789), (1, 0), (2, (1 << 63) - 1)],       # marker pairs
        jtypes.pack_wire(tree, key, level),                 # migration triples
        jtypes.pack_wire(tree, key, level, extra=extra),
        np.zeros(0, np.uint8),
        {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": [None, True, -5, "s", b"y"]},
        (1 << 70, -(1 << 70), np.float64(0.25), np.int64(-3)),
    ]


@pytest.mark.parametrize("i", range(7))
def test_encode_payload_bytes_match_reference(i):
    obj = _payloads()[i]
    blob = tcomm.encode_payload(obj)
    assert blob == jcomm.encode_payload(obj)
    assert tcomm.payload_nbytes(obj) == jcomm.payload_nbytes(obj)
    back = tcomm.decode_payload(blob)
    assert tcomm.encode_payload(back) == blob


@pytest.mark.parametrize("cut", [1, 5, 17])
def test_decode_payload_rejects_truncation_and_trailing_bytes(cut):
    blob = tcomm.encode_payload(_payloads()[3])
    with pytest.raises(WireFormatError):
        tcomm.decode_payload(blob[:-cut])
    with pytest.raises(WireFormatError):
        tcomm.decode_payload(blob + b"\x00" * cut)


def test_simcomm_meters_match_reference():
    """Per-phase byte and call counters equal the reference's for the same
    collectives, and the in-process results are the same shuffles."""
    P = 4
    counters = []
    for mod in (tcomm, jcomm):
        c = mod.SimComm(P)
        with c.phase("partition"):
            tot = c.iallgather([float(p) for p in range(P)]).wait()
            send = [[np.zeros(13 * q * (p + 1), np.uint8) for q in range(P)] for p in range(P)]
            recv = c.alltoallv(send)
        assert tot == [0.0, 1.0, 2.0, 3.0]
        assert [[x.size for x in row] for row in recv] == [
            [13 * q * (p + 1) for p in range(P)] for q in range(P)]
        c.allgather([(p, 7) for p in range(P)])
        counters.append((c.counters, c.bytes_for("partition"), c.bytes_for()))
    assert counters[0] == counters[1]
    lc = tcomm.LocalComm()
    assert lc.alltoallv([[np.arange(3)]])[0][0].tolist() == [0, 1, 2] and lc.bytes_for() == 0
    with pytest.raises(ValueError):
        tcomm.SimComm(2).allgather([1])


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("seed", range(4))
def test_target_ranks_match_reference(seed):
    rng = np.random.default_rng(seed)
    w = rng.exponential(1.0, 500) * (rng.random(500) > 0.2)  # zero-weight runs too
    cum = np.cumsum(w) - w / 2.0
    for P in (1, 3, 7):
        got = tplacement.target_ranks_np(cum, P, float(w.sum()))
        np.testing.assert_array_equal(got, jplacement.target_ranks_np(cum, P, float(w.sum())))
        assert (np.diff(got) >= 0).all()


# ---------------------------------------------------------- package surface
# Names of `repro.core.__all__` that `repro_torch.core` leaves out, and why.
CORE_OMISSIONS = {
    "u64": "keys are native int64; the uint32-pair emulation is not ported",
    "get_backend": "no backend knob: a tensor's device picks kernel or plain version",
    "set_backend": "no backend knob",
    "use_backend": "no backend knob",
    "DistComm": "the multi-process comm is not ported yet",
}


def test_core_exports_the_reference_names_but_the_listed_omissions():
    """`repro_torch.core` exports what `repro.core` does, less
    CORE_OMISSIONS, and each name resolves; the singletons are those
    `get_ops` returns."""
    import repro.core as jcore
    import repro_torch.core as tcore
    from repro_torch.core import ops as tops
    from repro_torch.core.types import ECLASS_HEX

    assert set(CORE_OMISSIONS) <= set(jcore.__all__)
    assert sorted(tcore.__all__) == sorted(set(jcore.__all__) - set(CORE_OMISSIONS))
    assert all(hasattr(tcore, name) for name in tcore.__all__)
    assert tcore.ops2d is tcore.get_ops(2) and tcore.ops3d is tcore.get_ops(3)
    assert tops.hexops2d is tcore.get_ops(2, ECLASS_HEX)
    assert tops.hexops3d is tcore.get_ops(3, ECLASS_HEX)
    with pytest.raises(ValueError):
        tcore.get_ops(4)


def test_checkpoint_and_forest_export_the_reference_names():
    """`repro_torch.checkpoint` exports what `repro.checkpoint` does, each
    name resolving, and the port's forest module has Iterate and the
    global-table oracles in its `__all__`, as the JAX package's has."""
    import repro.checkpoint as jckpt
    import repro.core.forest as jforest
    import repro_torch.checkpoint as tckpt
    import repro_torch.core.forest as tforest

    assert sorted(tckpt.__all__) == sorted(jckpt.__all__)
    assert all(callable(getattr(tckpt, name)) for name in tckpt.__all__)
    for name in ("iterate", "balance_oracle", "ghost_oracle"):
        assert name in tforest.__all__ and name in jforest.__all__
        assert callable(getattr(tforest, name))
    assert set(jforest.__all__) - set(tforest.__all__) == {"LatencyComm", "DistComm"}


def test_every_module_of_the_port_imports_first():
    """Whichever module a program imports first, the package loads whole
    (`core` imports `batch`, which imports `kernels.ops`, whose `build`
    imports `core.tables`): each in a fresh interpreter state."""
    import subprocess
    import sys
    from pathlib import Path

    import repro_torch

    mods = ["repro_torch", "repro_torch.core", "repro_torch.core.tables",
            "repro_torch.core.batch", "repro_torch.core.forest", "repro_torch.kernels",
            "repro_torch.kernels.build", "repro_torch.kernels.ops", "repro_torch.kernels.ref",
            "repro_torch.convert", "repro_torch.launch.serve", "repro_torch.checkpoint",
            "repro_torch.checkpoint.forest_io"]
    code = f"""
import importlib, sys
for m in {mods!r}:
    for k in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
        del sys.modules[k]
    importlib.import_module(m)
    from repro_torch.core import ops3d, SimComm, cmesh_brick, get_tables
    from repro_torch.kernels.build import library
"""
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    subprocess.run([sys.executable, "-c", code], check=True, cwd=src, timeout=300)
