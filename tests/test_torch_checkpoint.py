"""The port's checkpoints against the JAX package's, on the CPU.

Forests built by the port on `device="cpu"` are saved by the port and, as
JAX Forests, by the JAX package: `manifest.json` must be equal as JSON and
every `.npy` byte for byte, and each package must restore the other's
checkpoint to the same forests.  The cases of the JAX package's
`tests/core/test_checkpoint_forest.py` (exact restore, elastic restore
across rank counts, empty ranks, restore then repartition, the weighted
restore, a coarse mesh carried through) and `test_forest_eclass.py`'s hex
and hybrid round trips run on the port.  Integrity: a flipped byte, a
truncated column, a hex checkpoint without its coarse mesh and a mixed one
against the wrong mesh raise `CheckpointIntegrityError`; a manifest
without "eclass" is read as simplex.  `checkpoint.store` writes the JAX
package's gathered layout for any tree of dicts, lists and tuples."""

import json

import numpy as np
import pytest
import torch

from repro.checkpoint import load_forest as jload_forest
from repro.checkpoint import save_forest as jsave_forest
from repro.checkpoint import store as jstore
from repro.core import cmesh as JC
from repro.core import forest as JF
from repro_torch import convert
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, load_forest,
                                    restore_checkpoint, save_checkpoint, save_forest)
from repro_torch.core import cmesh as TC
from repro_torch.core import forest as TF
from repro_torch.core.errors import CheckpointIntegrityError
from test_torch_forest import _assert_same_forests


def _forests(P, d=3, trees=2, level=2, cmesh=None, cap=None):
    """New at `level`, elements anchored at the origin refined once (or, with
    `cap`, recursively below `cap`), on SimComm(P) on the CPU."""
    comm = TF.SimComm(P)
    fs = TF.new_uniform(d, trees, level, comm, cmesh=cmesh, device="cpu")
    if cap is None:
        return [TF.adapt(f, lambda t, e: (e.anchor.sum(1) == 0).int()) for f in fs], comm
    return [TF.adapt(f, lambda t, e: ((e.anchor.sum(1) == 0) & (e.level < cap)).int(),
                     recursive=True) for f in fs], comm


def _jax(fs, jcm=None):
    return [JF.Forest(**dict(convert.forest_to_reference(f), cmesh=jcm)) for f in fs]


def _same(tfs, ufs):
    """Two lists of port forests equal field for field."""
    assert len(tfs) == len(ufs)
    for a, b in zip(tfs, ufs):
        assert (a.rank, a.num_ranks, a.d, a.num_trees) == (b.rank, b.num_ranks, b.d, b.num_trees)
        for k in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def _assert_same_files(a, b):
    """Two checkpoint step directories: manifests equal as JSON, and every
    array file byte for byte."""
    assert json.loads((a / "manifest.json").read_text()) == json.loads(
        (b / "manifest.json").read_text())
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


# name: (mesh: (port, JAX) constructors or None, d, trees, level, P)
MESHES = {
    "simplex_d3": (None, 3, 2, 2, 4),
    "unit_cube_d2": ((TC.cmesh_unit_cube, JC.cmesh_unit_cube, (2,)), 2, 2, 2, 2),
    "hex_brick_d2": ((TC.cmesh_hex_brick, JC.cmesh_hex_brick, (2, (2, 1))), 2, 2, 2, 2),
    "hybrid_d2": ((TC.cmesh_hybrid_pair, JC.cmesh_hybrid_pair, (2,)), 2, 3, 2, 2),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_checkpoints_are_byte_identical_and_cross_restore(tmp_path, name):
    spec, d, trees, level, P = MESHES[name]
    tcm = jcm = None
    if spec is not None:
        tcm, jcm = spec[0](*spec[2]), spec[1](*spec[2])
    fs, comm = _forests(P, d, trees, level, cmesh=tcm, cap=level + 2)
    fs = TF.balance(fs, comm)
    jc = JF.SimComm(P)
    assert save_forest(tmp_path / "port", fs, comm, step=3) == tmp_path / "port" / "step_3"
    jsave_forest(tmp_path / "jax", _jax(fs, jcm), jc, step=3)
    _assert_same_files(tmp_path / "port" / "step_3", tmp_path / "jax" / "step_3")
    assert comm.counters["checkpoint"] == jc.counters["checkpoint"]
    # each package restores the other's, exactly and elastically
    for p_load in (P, P + 1):
        got = load_forest(tmp_path / "jax", TF.SimComm(p_load), cmesh=tcm, device="cpu")
        want = jload_forest(tmp_path / "port", JF.SimComm(p_load), cmesh=jcm)
        _assert_same_forests(got, want)
        assert TF.validate(got)
        if p_load == P:
            _same(got, fs)


def test_save_restore_same_rank_count_is_exact(tmp_path):
    fs, comm = _forests(4)
    save_forest(tmp_path, fs, comm, step=7)
    assert latest_step(tmp_path) == 7
    out = load_forest(tmp_path, TF.SimComm(4), device="cpu")
    _same(out, fs)
    assert TF.validate(out)


@pytest.mark.parametrize("p_save,p_load", [(4, 2), (2, 4)])
def test_elastic_restore_across_rank_counts(tmp_path, p_save, p_load):
    fs, comm = _forests(p_save)
    save_forest(tmp_path, fs, comm)
    comm2 = TF.SimComm(p_load)
    out = load_forest(tmp_path, comm2, device="cpu")
    assert len(out) == p_load and TF.count_global(out) == TF.count_global(fs)
    counts = [f.num_local for f in out]
    assert max(counts) - min(counts) <= 1
    for k in ("keys", "tree"):
        assert torch.equal(torch.cat([getattr(f, k) for f in out]),
                           torch.cat([getattr(f, k) for f in fs]))
    out = TF.balance(out, comm2)
    assert TF.validate(out, TF.ghost(out, comm2))


def test_restore_with_empty_ranks_reproduces_markers(tmp_path):
    comm = TF.SimComm(4)
    fs = TF.new_uniform(2, 1, 2, comm, device="cpu")
    ws = [torch.zeros(f.num_local, dtype=torch.float64) for f in fs]
    ws[0][0] = 1.0
    fs = TF.partition(fs, comm, weights=ws)
    assert any(f.num_local == 0 for f in fs)
    save_forest(tmp_path, fs, comm, step=1)
    _same(load_forest(tmp_path, TF.SimComm(4), device="cpu"), fs)


@pytest.mark.parametrize("p_save,p_load", [(4, 2), (2, 4), (4, 4)])
def test_restore_then_repartition_round_trip(tmp_path, p_save, p_load):
    fs, comm = _forests(p_save)
    save_forest(tmp_path, fs, comm)
    comm2 = TF.SimComm(p_load)
    out = load_forest(tmp_path, comm2, device="cpu")
    out = TF.repartition(out, comm2, weights=[1.0 + (f.keys % 5).double() for f in out])
    assert torch.equal(torch.cat([f.keys for f in out]), torch.cat([f.keys for f in fs]))
    loads = [float((1.0 + (f.keys % 5).double()).sum()) for f in out]
    assert max(loads) / (sum(loads) / p_load) < 1.5
    out = TF.balance(out, comm2)
    assert TF.validate(out, TF.ghost(out, comm2))


def test_weighted_restore_matches_repartition(tmp_path):
    fs, comm = _forests(4)
    save_forest(tmp_path, fs, comm)
    comm2 = TF.SimComm(2)
    plain = load_forest(tmp_path, comm2, device="cpu")
    w = 1.0 + (torch.cat([f.keys for f in plain]) % 7).double()
    direct = load_forest(tmp_path, TF.SimComm(2), weights=w, device="cpu")
    bounds = np.cumsum([0] + [f.num_local for f in plain])
    _same(direct, TF.repartition(plain, comm2,
                                 weights=[w[a:b] for a, b in zip(bounds[:-1], bounds[1:])]))
    assert TF.validate(direct)
    with pytest.raises(ValueError, match="one weight per saved element"):
        load_forest(tmp_path, TF.SimComm(2), weights=w[1:], device="cpu")


def test_restore_carries_cmesh(tmp_path):
    cm = TC.cmesh_unit_cube(2)
    fs, comm = _forests(2, d=2, trees=cm.num_trees, cmesh=cm)
    fs = TF.balance(fs, comm)
    save_forest(tmp_path, fs, comm)
    out = load_forest(tmp_path, TF.SimComm(2), cmesh=cm, device="cpu")
    assert all(f.cmesh is cm for f in out)
    for a, b in zip(TF.ghost(fs, TF.SimComm(2)), TF.ghost(out, TF.SimComm(2))):
        for k in convert.GHOST_FIELDS:
            assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("mesh", ["hex", "mixed"])
def test_class_checkpoints_roundtrip_elastic_and_need_their_cmesh(tmp_path, mesh):
    """Hex rows at rest without a type column and mixed ones with the class
    column restore bit for bit at the same P and re-split at another P; a
    missing or wrong coarse mesh is refused."""
    cm = TC.cmesh_hex_brick(2, (2, 1)) if mesh == "hex" else TC.cmesh_hybrid_pair(2)
    wrong = TC.cmesh_hybrid_pair(2) if mesh == "hex" else TC.cmesh_hex_brick(2, (3, 1))
    fs, comm = _forests(2, d=2, trees=cm.num_trees, cmesh=cm, cap=4)
    fs = TF.balance(fs, comm)
    save_forest(tmp_path, fs, comm, step=3)
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert manifest["meta"]["eclass"] == (1 if mesh == "hex" else "mixed")
    assert ("stype" in manifest["meta"]["crc32"]) == (mesh == "mixed")
    _same(load_forest(tmp_path, TF.SimComm(2), cmesh=cm, device="cpu"), fs)
    elastic = load_forest(tmp_path, TF.SimComm(3), cmesh=cm, device="cpu")
    assert TF.validate(elastic) and TF.count_global(elastic) == TF.count_global(fs)
    for bad in (None, wrong):
        with pytest.raises(CheckpointIntegrityError):
            load_forest(tmp_path, TF.SimComm(2), cmesh=bad, device="cpu")


def _leaf_file(step_dir, name):
    """The .npy file of payload column `name` (leaves in sorted key order)."""
    manifest = json.loads((step_dir / "manifest.json").read_text())
    return step_dir / manifest["leaves"][sorted(manifest["meta"]["crc32"]).index(name)]["file"]


@pytest.mark.parametrize("fault", ["flip", "truncate", "manifest", "reorder"])
def test_integrity_failures_raise(tmp_path, fault):
    fs, comm = _forests(2)
    step = save_forest(tmp_path, fs, comm)
    f = _leaf_file(step, "anchor")
    raw = bytearray(f.read_bytes())
    if fault == "flip":
        raw[-3] ^= 0x10
        f.write_bytes(bytes(raw))
    elif fault == "truncate":
        f.write_bytes(bytes(raw[:-7]))
    elif fault == "manifest":
        (step / "manifest.json").write_text("{not json")
    else:
        # a checksum-consistent but reordered sequence fails validate
        a = np.load(f)
        a[[0, 1]] = a[[1, 0]]
        np.save(f, a)
        manifest = json.loads((step / "manifest.json").read_text())
        manifest["meta"]["crc32"]["anchor"] = int(__import__("zlib").crc32(a.tobytes()))
        (step / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(CheckpointIntegrityError):
        load_forest(tmp_path, TF.SimComm(2), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_forest(tmp_path / "nothing", TF.SimComm(2), device="cpu")


def test_manifest_without_eclass_reads_as_simplex(tmp_path):
    fs, comm = _forests(2)
    step = save_forest(tmp_path, fs, comm)
    manifest = json.loads((step / "manifest.json").read_text())
    del manifest["meta"]["eclass"]
    (step / "manifest.json").write_text(json.dumps(manifest))
    _same(load_forest(tmp_path, TF.SimComm(2), device="cpu"), fs)


def test_store_writes_the_reference_layout_for_any_tree(tmp_path):
    """Nested dicts, lists, tuples and None: the same manifest (JAX's
    structure string included) and bytes as the JAX package's store, both
    restores of either checkpoint, host numpy out; `sharded=True` on the
    port's single-device tensors writes what the JAX package writes for
    arrays of one shard."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"z": np.arange(5, dtype=np.int64), "a": [np.zeros(2, np.uint8), None,
                                                         (np.ones((1, 2), np.int16),)]},
            "t": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    host = {**tree, "t": tree["t"].numpy()}
    save_checkpoint(tmp_path / "port", tree, step=2, extra_meta={"k": 1})
    jstore.save_checkpoint(tmp_path / "jax", host, step=2, extra_meta={"k": 1})
    _assert_same_files(tmp_path / "port" / "step_2", tmp_path / "jax" / "step_2")
    got, manifest = restore_checkpoint(tmp_path / "jax", host)
    assert manifest["meta"] == {"k": 1} and got["b"]["a"][1] is None
    for a, b in zip(*(jstore._flatten(x)[0] for x in (got, host))):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError, match="tree structure changed"):
        restore_checkpoint(tmp_path / "port", {"w": host["w"]})
    save_checkpoint(tmp_path / "s", tree, step=0, sharded=True)
    jstore.save_checkpoint(tmp_path / "js", host, step=0, sharded=True)
    _assert_same_files(tmp_path / "s" / "step_0", tmp_path / "js" / "step_0")
    assert json.loads((tmp_path / "s" / "step_0" / "manifest.json").read_text())["sharded"]
    assert latest_step(tmp_path / "none") is None


def test_async_checkpointer_round_trip_and_writer_error(tmp_path):
    """`AsyncCheckpointer` snapshots the tree to the host at `save` (later
    changes to the tensors do not reach the file), writes the JAX package's
    bytes on a thread, and `wait` raises the error a write met."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tree = {"t": t, "b": torch.ones(5, dtype=torch.bfloat16) / 3, "n": None}
    ck = AsyncCheckpointer(tmp_path / "a")
    ck.save(tree, step=4)
    t.add_(100.0)
    ck.wait()
    host = {"t": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": __import__("ml_dtypes").bfloat16(1 / 3) * np.ones(5, "bfloat16"), "n": None}
    jstore.save_checkpoint(tmp_path / "j", host, step=4)
    _assert_same_files(tmp_path / "a" / "step_4", tmp_path / "j" / "step_4")
    got, _ = restore_checkpoint(tmp_path / "a", tree)
    np.testing.assert_array_equal(got["t"], host["t"])
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], tree["b"])
    (tmp_path / "file").write_text("")
    bad = AsyncCheckpointer(tmp_path / "file")       # a file where the directory goes
    bad.save(tree, step=0)
    with pytest.raises(OSError):
        bad.wait()


def test_restore_reassembles_shard_files_as_the_reference_does(tmp_path):
    """A manifest entry of per-shard "files" (what the JAX package writes
    for an array over several devices), bf16 included: the port restores
    the same arrays as the JAX package's restore."""
    tree = {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
            "b": torch.arange(8, dtype=torch.float32).bfloat16()}
    step = save_checkpoint(tmp_path, tree, step=0)
    manifest = json.loads((step / "manifest.json").read_text())
    for entry in manifest["leaves"]:
        arr = np.load(step / entry["file"])
        half = arr.shape[0] // 2
        entry["files"] = []
        for j, (a, b) in enumerate(((0, half), (half, arr.shape[0]))):
            fn = f"arr_{entry['index']}.shard0_{a}.npy"
            np.save(step / fn, arr[a:b])
            entry["files"].append({"file": fn, "index": [[a, b]] + [[0, n] for n in
                                                                    arr.shape[1:]]})
        (step / entry.pop("file")).unlink()
    (step / "manifest.json").write_text(json.dumps(manifest))
    got, _ = restore_checkpoint(tmp_path, tree)
    want, _ = jstore.restore_checkpoint(tmp_path, {"w": tree["w"], "b": tree["w"]})
    np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], tree["b"])
    np.testing.assert_array_equal(got["b"].float().numpy(), np.asarray(want["b"], np.float32))
