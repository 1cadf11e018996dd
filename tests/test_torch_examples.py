"""The twins of the four AMR examples (`repro_torch.examples`) against the
JAX package's examples, on the CPU.

Each twin's `main(device="cpu")` must print the JAX example's lines as
`untimed` leaves them (times, the kernels' device and the conservation
error's digits left out; `fem_diffusion`'s max u to its printed 4
decimals), recorded in `tests/_torch_example_lines.py`.  Where the JAX side
costs about 10-20 s (the fractal's k = 1 forest, `fem_diffusion`'s mesh and
pairs) the forests and pairs are also held live against the JAX package,
computed once a module.  The slow-marked test reruns each JAX example in a
subprocess and holds it to the recorded lines, so that the record stays
tied to the frozen reference (about 2-4 min for all six);
`sfc_expert_placement` under another numpy than the record's draws other
loads, and is held to the twin's lines on the same draws instead.
"""

import contextlib
import functools
import importlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_example_lines import EXAMPLE_LINES, RECORDED_NUMPY
from repro.core import forest as JF
from repro.core import ops3d as jops3d
from repro.core.tables import get_tables as jget_tables
from repro_torch.core import forest as TF
from repro_torch.examples import amr_fractal, fem_diffusion, untimed

ROOT = Path(__file__).resolve().parents[1]
AMR_TWINS = ["quickstart", "amr_fractal", "multitree_cube", "fem_diffusion"]
FIELDS = ("anchor", "level", "stype", "tree")


@pytest.fixture(autouse=True)
def one_thread():
    """The twins' tensors are small: one thread a worker runs them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _printed(name: str):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = mod.main(device="cpu")
    return buf.getvalue(), r


@pytest.mark.parametrize("name", AMR_TWINS)
def test_twin_prints_the_jax_examples_lines(name):
    text, r = _printed(name)
    assert untimed(text) == EXAMPLE_LINES[name]
    if name == "fem_diffusion":
        assert r["conservation_error"] < 1e-12 and r["max_u"] < 1.0
        assert all(err < 1e-12 for _step, _u, err in r["shown"])
    if name == "amr_fractal":
        assert [row["level"] for row in r["fig11"]] == [4, 5, 6]
        assert all(row["wall_s"] > 0 for row in r["fig11"])


def test_untimed_leaves_out_only_times_device_and_small_conservation_errors():
    text = ("== CUDA kernels on NVIDIA H100 80GB HBM3 ==\n"
            "   level 8: 16,777,216 elements    0.004s      0.2 ns/element\n"
            "served 10 requests, 160 decode steps in 1.4s (113.1 tok/s on the CPU)\n"
            "step   0: max u = 0.9520, conservation error = 3.00e-17\n"
            "step  20: max u = 0.6554, conservation error = 2.00e-09\n")
    assert untimed(text) == ["== kernels ==", "   level 8: 16,777,216 elements",
                             "served 10 requests, 160 decode steps",
                             "step   0: max u = 0.9520, conservation error < 1e-12",
                             "step  20: max u = 0.6554, conservation error = 2.00e-09"]


def test_twins_raise_without_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in (*AMR_TWINS, "sfc_expert_placement", "serve_lm"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.run()


def test_twin_runs_as_a_module_with_device_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.multitree_cube",
                          "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert untimed(out.stdout) == EXAMPLE_LINES["multitree_cube"]


# -------------------------------------------------------------- amr_fractal
@pytest.mark.parametrize("trees,k,depth", [(512, 7, 5), (4, 1, 2), (4, 3, 2), (1, 0, 0),
                                           (3, 5, 4), (7, 2, 9)])
def test_analytic_fractal_count_equals_the_jax_examples(trees, k, depth):
    """The JAX example's transfer matrix (numpy object dtype) transcribed
    here, against the twin's Python-int one."""
    t = jget_tables(3)
    M = np.zeros((6, 6), dtype=object)
    for b in range(6):
        for i in range(8):
            M[b, t.child_type[b, i]] += 1
    c = np.zeros(6, dtype=object)
    c[0] = trees
    for _ in range(k):
        c = c @ M
    Fj = 1
    for _ in range(depth):
        Fj = 4 * Fj + 4
    refin = c[0] + c[3]
    assert amr_fractal.analytic_fractal_count(trees, k, depth) == int(refin * Fj
                                                                        + (c.sum() - refin))


def _jax_fractal_cb(max_level):
    def cb(tree, elems):
        b, lv = np.asarray(elems.stype), np.asarray(elems.level)
        return (((b == 0) | (b == 3)) & (lv < max_level)).astype(np.int32)
    return cb


@functools.lru_cache(maxsize=None)
def _jax_fractal(trees, k):
    fs = JF.new_uniform(3, trees, k, JF.SimComm(4))
    return [JF.adapt(f, _jax_fractal_cb(k + 2), recursive=True) for f in fs]


def test_fractal_forest_equals_the_jax_packages():
    """k = 1 of the example's count loop: every rank's leaves, field for
    field, and the count the analytic formula gives."""
    want = _jax_fractal(4, 1)
    fs = TF.new_uniform(3, 4, 1, TF.SimComm(4), device="cpu")
    got = [TF.adapt(f, amr_fractal.fractal_cb(3), recursive=True) for f in fs]
    for g, w in zip(got, want):
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(w, name)))
    assert TF.count_global(got) == JF.count_global(want) == 592


# ------------------------------------------------------------ fem_diffusion
CENTER = np.array(fem_diffusion.CENTER)


@functools.lru_cache(maxsize=None)
def _jax_fem():
    """The JAX example's mesh and pairs (its callback transcribed), and its
    numpy solve's max u at steps 0, 20 and 40 and after 60."""
    L = jops3d.L

    def near_corner(tree, elems):
        c = np.asarray(jops3d.coordinates(elems)).mean(axis=1) / (1 << L)
        lv = np.asarray(elems.level)
        return ((np.linalg.norm(c - CENTER, axis=1) < 0.25) & (lv < 4)).astype(np.int32)

    comm = JF.SimComm(1)
    fs = [JF.adapt(f, near_corner, recursive=True) for f in JF.new_uniform(3, 1, 2, comm)]
    f = JF.balance(fs, comm)[0]
    pairs = {}
    JF.iterate(f, face_fn=lambda ff, pp: pairs.setdefault("p", pp))
    p = np.asarray(pairs["p"])
    cent = np.asarray(jops3d.coordinates(f.simplices())).mean(axis=1) / (1 << L)
    u = np.exp(-40 * np.linalg.norm(cent - CENTER, axis=1) ** 2)
    vol = (1.0 / 6.0) * (8.0 ** -f.level.astype(np.float64))
    i, j = p[:, 0], p[:, 1]
    area = np.minimum(vol[i], vol[j]) ** (2 / 3)
    rowsum = np.zeros(len(u))
    np.add.at(rowsum, i, area / vol[i])
    np.add.at(rowsum, j, area / vol[j])
    dt_k = 0.9 / rowsum.max()
    shown = []
    for step in range(60):
        flux = dt_k * (u[j] - u[i]) * area
        du = np.zeros_like(u)
        np.add.at(du, i, flux / vol[i])
        np.add.at(du, j, -flux / vol[j])
        u = u + du
        if step % 20 == 0:
            shown.append(u.max())
    return {name: np.asarray(getattr(f, name)) for name in FIELDS}, p, shown + [u.max()]


def test_fem_mesh_pairs_and_field_equal_the_jax_examples():
    """The twin's mesh (every leaf) and Iterate's pairs (row for row) equal
    the JAX example's; its max u at each shown step and after the 60 steps
    within 1e-12 relative of the JAX example's numpy solve."""
    want, want_pairs, want_max = _jax_fem()
    comm = TF.SimComm(1)
    fs = [TF.adapt(f, fem_diffusion.near_corner_cb(4), recursive=True)
          for f in TF.new_uniform(3, 1, 2, comm, device="cpu")]
    f = TF.balance(fs, comm)[0]
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(f, name).numpy(), want[name])
    pairs = TF.iterate(f, face_fn=lambda ff, pp: pp)[0]
    np.testing.assert_array_equal(pairs.numpy(), want_pairs)
    r = fem_diffusion.run(device="cpu")
    got_max = [u for _step, u, _err in r["shown"]] + [r["max_u"]]
    np.testing.assert_allclose(got_max, want_max, rtol=1e-12, atol=0)
    assert r["leaves"] == len(want["level"]) and r["pairs"] == len(want_pairs)


# ------------------------------------------------- the JAX examples themselves
@pytest.mark.slow
@pytest.mark.parametrize("name", list(EXAMPLE_LINES))
def test_jax_example_still_prints_the_recorded_lines(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py")], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    if name == "sfc_expert_placement" and np.__version__ != RECORDED_NUMPY:
        # other `rng.zipf` draws: the twin on the CPU, on the same draws
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(f"repro_torch.examples.{name}").main(device="cpu")
        assert untimed(out.stdout) == untimed(buf.getvalue())
    else:
        assert untimed(out.stdout) == EXAMPLE_LINES[name]
