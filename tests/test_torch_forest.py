"""The port's New -> Adapt -> Partition against the JAX package, element for
element, on the CPU; the state carried between the packages; and the
port's import and device rules.

The JAX package runs under `use_backend("jnp")` (its own suite holds jnp
bit-identical to pallas); the port runs on `device="cpu"`, where every
kernel wrapper takes its plain version.  Sizes are small: four trees, level
1 refined to level 3, and the trees of the upper half coarsened back, so
that Partition has to move elements."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.core import comm as jcomm
from repro.core import forest as JF
from repro_torch import convert
from repro_torch.core import batch as tbatch
from repro_torch.core import comm as tcomm
from repro_torch.core import forest as TF
from repro_torch.core.cmesh import cmesh_unit_cube
from repro_torch.core.ops import get_ops
from repro_torch.core.types import ECLASS_HEX

ROOT = Path(__file__).resolve().parents[1]


def _refine_types(d):
    return (0, 3) if d == 3 else (0,)


def _fractal_np(d, max_level):
    def cb(tree, e):
        b, lv = np.asarray(e.stype), np.asarray(e.level)
        return (np.isin(b, _refine_types(d)) & (lv < max_level)).astype(np.int32)
    return cb


def _coarsen_upper_np(num_trees, max_level):
    def cb(tree, e):
        hit = (np.asarray(e.level) == max_level) & (np.asarray(tree) >= num_trees // 2)
        return np.where(hit, -1, 0).astype(np.int32)
    return cb


def _fractal_torch(d, max_level):
    def cb(tree, e):
        hit = torch.zeros_like(e.stype, dtype=torch.bool)
        for b in _refine_types(d):
            hit |= e.stype == b
        return (hit & (e.level < max_level)).to(torch.int32)
    return cb


def _coarsen_upper_torch(num_trees, max_level):
    def cb(tree, e):
        hit = (e.level == max_level) & (tree >= num_trees // 2)
        return torch.where(hit, -1, 0).to(torch.int32)
    return cb


def _assert_same_forests(tfs, jfs):
    assert len(tfs) == len(jfs)
    for t, j in zip(tfs, jfs):
        assert (t.d, t.num_trees, t.rank, t.num_ranks) == (j.d, j.num_trees, j.rank, j.num_ranks)
        for name in ("anchor", "level", "stype", "tree"):
            got = getattr(t, name)
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), getattr(j, name), err_msg=name)
        assert t.keys.dtype == torch.int64
        np.testing.assert_array_equal(t.keys.numpy().astype(np.uint64), j.keys)


def _level_weights(fs, max_level, as_tensor):
    """Weights 1 + (level == max_level)."""
    if as_tensor:
        return [1.0 + (f.level == max_level).double() for f in fs]
    return [1.0 + (f.level == max_level).astype(np.float64) for f in fs]


def check_pipeline_against_reference(d, P):
    """New -> fractal Adapt -> upper-half coarsening Adapt -> Partition ->
    weighted repartition on SimComm(P), the port against the JAX package
    step by step.  Run per dimension from `test_torch_pipeline_d2.py` and
    `test_torch_pipeline_d3.py`, whose JAX compiles take most of a minute
    together."""
    trees, level, max_level = 4, 1, 3
    jc, tc = _recording(JF.SimComm, P), _recording(TF.SimComm, P)
    tfs = TF.new_uniform(d, trees, level, tc, device="cpu")
    with jbatch.use_backend("jnp"):
        jfs = JF.new_uniform(d, trees, level, jc)
        _assert_same_forests(tfs, jfs)
        jfs = [JF.adapt(f, _fractal_np(d, max_level), recursive=True) for f in jfs]
        tfs = [TF.adapt(f, _fractal_torch(d, max_level), recursive=True) for f in tfs]
        _assert_same_forests(tfs, jfs)
        jfs = [JF.adapt(f, _coarsen_upper_np(trees, max_level)) for f in jfs]
        tfs = [TF.adapt(f, _coarsen_upper_torch(trees, max_level)) for f in tfs]
        _assert_same_forests(tfs, jfs)
        assert TF.load_imbalance(tfs, tc) == JF.load_imbalance(jfs, jc)
        if P > 1:
            assert TF.load_imbalance(tfs, tc) > 1.2
        jfs = JF.partition(jfs, jc)
        tfs = TF.partition(tfs, tc)
        _assert_same_forests(tfs, jfs)
        assert TF.load_imbalance(tfs, tc) == JF.load_imbalance(jfs, jc)
        jw, tw = _level_weights(jfs, max_level, False), _level_weights(tfs, max_level, True)
        assert TF.load_imbalance(tfs, tc, weights=tw) == JF.load_imbalance(jfs, jc, weights=jw)
        jfs = JF.repartition(jfs, jc, weights=jw, overlap=False)
        tfs = TF.repartition(tfs, tc, weights=tw, overlap=False)
        _assert_same_forests(tfs, jfs)
    assert TF.count_global(tfs, tc) == JF.count_global(jfs, jc) > 0
    for phase in ("partition", "repartition"):
        assert tc.bytes_for(phase) == jc.bytes_for(phase)
        assert tc.counters[phase] == jc.counters[phase]
    # one rank has nothing to send; with more, the coarsened half must move
    assert (tc.counters["partition"]["alltoallv_bytes"] > 0) == (P > 1)
    # every payload Partition and repartition posted (weight totals,
    # per-destination wire triples) encodes to the reference's bytes
    got, want = ([(ph, x) for ph, x in c.posted if ph in ("partition", "repartition")]
                 for c in (tc, jc))
    assert [ph for ph, _ in got] == [ph for ph, _ in want] == ["partition"] * 2 + ["repartition"] * 2
    for (phase, g), (_, w) in zip(got, want):
        assert tcomm.encode_payload(g) == jcomm.encode_payload(w), phase
    for mt, mj in zip(TF.partition_markers(tfs, tc), JF.partition_markers(jfs, jc)):
        np.testing.assert_array_equal(mt, mj)


def test_overlap_both_ways_gives_the_same_forest_and_bytes():
    comm_a, comm_b = TF.SimComm(3), TF.SimComm(3)
    fs = TF.new_uniform(3, 2, 2, comm_a, device="cpu")
    fs = [TF.adapt(f, _fractal_torch(3, 3), recursive=True) for f in fs]
    a = TF.repartition(fs, comm_a, weights=_level_weights(fs, 3, True), overlap=True)
    b = TF.repartition(fs, comm_b, weights=_level_weights(fs, 3, True), overlap=False)
    for x, y in zip(a, b):
        for name in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(x, name), getattr(y, name))
    assert comm_a.counters == comm_b.counters


def _recording(comm_cls, P):
    """A SimComm that keeps every payload posted, with its phase."""
    class Recording(comm_cls):
        def __init__(self):
            super().__init__(P)
            self.posted = []

        def _allgather(self, per_local):
            self.posted.append((self._phases[-1] if self._phases else None, per_local))
            return super()._allgather(per_local)

        def _alltoallv(self, send):
            self.posted.append((self._phases[-1] if self._phases else None, send))
            return super()._alltoallv(send)
    return Recording()


def test_forest_dispatches_through_batched_ops():
    """New, Adapt and Partition reach the element math only through the
    four batched ops that the kernels serve."""
    tbatch.reset_dispatch_counts()
    comm = TF.SimComm(2)
    fs = TF.new_uniform(2, 2, 2, comm, device="cpu")
    fs = [TF.adapt(f, _fractal_torch(2, 4), recursive=True) for f in fs]
    fs = [TF.adapt(f, _coarsen_upper_torch(2, 4)) for f in fs]
    TF.partition(fs, comm)
    counts = tbatch.dispatch_counts()
    assert set(counts) == {"decode", "morton_key", "parent_and_local_index", "children",
                           "parent"}
    assert all(v > 0 for v in counts.values())


def test_convert_round_trip():
    fs = TF.new_uniform(3, 3, 1, TF.SimComm(2), device="cpu")
    for f in fs:
        arrays = convert.forest_to_reference(f)
        assert arrays["keys"].dtype == np.uint64 and arrays["anchor"].dtype == np.int32
        back = convert.forest_from_reference(arrays, device="cpu")
        for name in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(back, name), getattr(f, name))
        assert (back.d, back.num_trees, back.rank, back.num_ranks) == (
            f.d, f.num_trees, f.rank, f.num_ranks)


@pytest.mark.parametrize("d", [2, 3])
def test_reference_forest_carried_into_the_port_and_adapted(d):
    """A forest built and adapted by the JAX package crosses into the port,
    adapts and partitions there, and equals the JAX package doing the same;
    the result crosses back into a JAX Forest."""
    comm = JF.SimComm(2)
    with jbatch.use_backend("jnp"):
        jfs = JF.new_uniform(d, 2, 2, comm)
        jfs = [JF.adapt(f, _fractal_np(d, 3), recursive=True) for f in jfs]
        fields = [{k: getattr(f, k) for k in convert.FIELDS} for f in jfs]
        tfs = [convert.forest_from_reference(a, device="cpu") for a in fields]
        _assert_same_forests(tfs, jfs)
        jfs = JF.partition([JF.adapt(f, _coarsen_upper_np(2, 3)) for f in jfs], comm)
    tc = TF.SimComm(2)
    tfs = TF.partition([TF.adapt(f, _coarsen_upper_torch(2, 3)) for f in tfs], tc)
    _assert_same_forests(tfs, jfs)
    back = [JF.Forest(**convert.forest_to_reference(f)) for f in tfs]
    for b, j in zip(back, jfs):
        np.testing.assert_array_equal(b.keys, j.keys)
        np.testing.assert_array_equal(b.anchor, j.anchor)


def test_import_leaves_jax_and_reference_out():
    """Importing every module of the port pulls in neither JAX nor the
    JAX package."""
    pkg = ROOT / "src" / "repro_torch"
    mods = sorted(".".join(("repro_torch",) + p.relative_to(pkg).with_suffix("").parts)
                  .removesuffix(".__init__") for p in pkg.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "repro_torch.core.forest" in mods and "repro_torch.kernels.build" in mods


def test_entry_points_default_to_the_card():
    """Without `device=`, New runs on the card, and raises where there is
    none — it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.new_uniform(3, 1, 1, TF.SimComm(1))
    with pytest.raises(RuntimeError):
        convert.forest_from_reference(
            convert.forest_to_reference(TF.new_uniform_rank(2, 1, 1, 0, 1, device="cpu")))


def test_unported_features_and_bad_input_raise():
    """Features of later slices raise NotImplementedError naming the slice
    (ROADMAP.md's queue); bad input raises ValueError."""
    with pytest.raises(ValueError, match="does not match"):   # a cmesh of other trees
        TF.new_uniform(3, 1, 1, TF.SimComm(1), cmesh=cmesh_unit_cube(3), device="cpu")
    with pytest.raises(ValueError):
        TF.new_uniform(3, 1, 1, TF.SimComm(1), method="bogus", device="cpu")
    with pytest.raises(NotImplementedError, match="slice 4"):
        get_ops(3, ECLASS_HEX)
    f = TF.new_uniform_rank(3, 1, 1, 0, 1, device="cpu")
    tables = convert.cmesh_to_reference(cmesh_unit_cube(3))
    tables["tree_eclass"][0] = ECLASS_HEX
    with pytest.raises(NotImplementedError, match="slice 4"):
        convert.cmesh_from_reference(tables)
    arrays = convert.forest_to_reference(f)
    with pytest.raises(NotImplementedError, match="slice 4"):
        convert.forest_from_reference(dict(arrays, eclass=ECLASS_HEX), device="cpu")
    with pytest.raises(ValueError):
        TF.adapt(f, lambda tree, e: torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        TF.repartition([f], TF.LocalComm(), weights=[np.ones(2)])
    with pytest.raises(ValueError):
        TF.repartition([f], TF.LocalComm(), weights=[-np.ones(f.num_local)])
    with pytest.raises(ValueError):
        TF.new_uniform_rank(3, 1, 22, 0, 1, device="cpu")


def test_more_ranks_than_elements_and_empty_ranks():
    comm = TF.SimComm(5)
    fs = TF.new_uniform(2, 1, 1, comm, device="cpu")   # 4 elements, 5 ranks
    assert [f.num_local for f in fs].count(0) == 1
    out = TF.partition(fs, comm)
    assert TF.count_global(out) == 4
    mt, mk = TF.partition_markers(out, comm)
    assert list(mt) == sorted(mt)
    jc = JF.SimComm(5)
    with jbatch.use_backend("jnp"):
        ref = JF.partition(JF.new_uniform(2, 1, 1, jc), jc)
    _assert_same_forests(out, ref)
    assert comm.counters["partition"] == jc.counters["partition"]
