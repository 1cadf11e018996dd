"""The port's launch tooling against the JAX package's, as pure functions of
shapes (no device, no process group).

For every leaf of all 10 configs at full size, on the single (16, 16),
multi (2, 16, 16) and host (2, 4) meshes: `param_pspec`,
`opt_state_pspecs` (AdamW and Adafactor), `batch_pspecs` and
`cache_pspecs` equal the JAX package's, the JAX spec of a stacked leaf
being the port's with a leading None.  The JAX functions read only
`mesh.shape` and `mesh.axis_names`, so they get a stand-in mesh; the JAX
shapes come from `jax.eval_shape`, the port's from the `meta` device.
Also `input_specs` and `all_cells` for all 40 cells, `model_flops`,
`roofline_terms` against its formula on the H100 model,
`default_num_micro` with a mesh, and the report's tables on synthetic
cells.  The JAX side is computed once a config.
"""

import functools

import jax
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import report as jreport
from repro.launch import sharding as jsh
from repro.launch.roofline import model_flops as j_model_flops
from repro.launch.serve import abstract_cache as j_abstract_cache
from repro.launch.train import abstract_train_state as j_abstract_state
from repro.launch.train import default_num_micro as j_default_num_micro
import repro_torch.configs as tconfigs
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as troof
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import MeshShape, batch_spec_axes, dp_axes
from repro_torch.launch.serve import abstract_cache
from repro_torch.launch.train import default_num_micro
from repro_torch.models import init_params
from repro_torch.models.lm import STACKED
from repro_torch.optim import init_opt_state

MESHES = {"single": MeshShape(("data", "model"), (16, 16)),
          "multi": MeshShape(("pod", "data", "model"), (2, 16, 16)),
          "host": MeshShape(("data", "model"), (2, 4))}


class JMesh:
    """What the JAX functions read of a mesh."""

    def __init__(self, m: MeshShape):
        self.axis_names = tuple(m.mesh_dim_names)
        self.shape = dict(zip(m.mesh_dim_names, m.shape))


def _jkey(path) -> str:
    parts = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            parts.append(str(p.key))
        elif isinstance(p, jax.tree_util.SequenceKey):
            parts.append(str(p.idx))
        else:
            parts.append(str(getattr(p, "name", p)))
    return "/".join(parts)


def _jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_jkey(path): leaf for path, leaf in flat}


def _jspec(p) -> tuple:
    return tuple(p)


def _port_key(name: str) -> str:
    """A port parameter / state name as the JAX tree's path."""
    parts = name.split(".")
    if parts[0] in STACKED and len(parts) > 2 and (parts[1].isdigit() or parts[1] == "*"):
        parts = [parts[0], *parts[2:]]
    return "/".join(parts)


def _stacked(name: str) -> bool:
    parts = name.split(".")
    return parts[0] in STACKED and len(parts) > 2 and (parts[1].isdigit() or parts[1] == "*")


@functools.lru_cache(maxsize=None)
def _jax_state(arch: str):
    return j_abstract_state(jconfigs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    return init_params(tconfigs.get_config(arch), device="meta")


def _compare(port: dict, jax_flat: dict, what: str):
    """Every port entry against the JAX leaf at its path (a stacked port
    entry with the JAX spec's leading None dropped)."""
    seen = set()
    for name, spec in port.items():
        key = _port_key(name)
        want = _jspec(jax_flat[key])
        if _stacked(name) and want:
            assert want[0] is None, (what, name, want)
            want = want[1:]
        assert spec == want, (what, name, spec, want)
        seen.add(key)
    assert seen == set(jax_flat), (what, set(jax_flat) ^ seen)


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_param_and_opt_state_specs_equal_the_jax_package(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    jparams, _ = _jax_state(arch)
    model = _port_params(arch)
    for mname, m in MESHES.items():
        jm = JMesh(m)
        jps = jsh.params_pspecs(jcfg, jm, jparams)
        ps = tsh.params_pspecs(cfg, m, model)
        _compare(ps, _jflat(jps), f"params {mname}")
        for opt in ("adamw", "adafactor"):
            jst = jsh.opt_state_pspecs(jcfg, jm, jps, jparams, opt)
            st = tsh.opt_state_pspecs(cfg, m, ps, model, opt)
            assert st.step == tuple(jst.step) == ()
            _compare(st.mu, _jflat(jst.mu), f"{opt} mu {mname}")
            if opt == "adamw":
                _compare(st.nu, _jflat(jst.nu), f"adamw nu {mname}")
            else:
                # a stacked group's key names the stacked leaf: its specs are the JAX ones
                nu = {f"{_port_key(k)}/{i}": spec for k, pair in st.nu.items()
                      for i, spec in enumerate(pair)}
                assert nu == {k: _jspec(v) for k, v in _jflat(jst.nu).items()}, mname
        # the state the port's optimizer makes has the structure the specs name
        state = init_opt_state(model, "adafactor", cfg.opt_state_dtype)
        assert set(state.nu) == set(tsh.opt_state_pspecs(cfg, m, ps, model, "adafactor").nu)


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_batch_and_cache_specs_equal_the_jax_package(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for shape in tconfigs.SHAPES.values():
        ok, _ = tconfigs.cell_supported(cfg, shape)
        specs, jspecs = tconfigs.input_specs(cfg, shape), jconfigs.input_specs(jcfg, shape)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in specs.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()}
        for mname, m in MESHES.items():
            jm = JMesh(m)
            want = {k: _jspec(v) for k, v in jsh.batch_pspecs(jm, jspecs).items()}
            assert tsh.batch_pspecs(m, specs) == want, (arch, shape.name, mname)
            if shape.mode != "decode" or not ok:
                continue
            B, S = shape.global_batch, shape.seq_len
            jc = _jflat(jsh.cache_pspecs(jcfg, jm, j_abstract_cache(jcfg, B, S)))
            pc = tsh.cache_pspecs(cfg, m, abstract_cache(cfg, B, S))
            flat = {}

            def walk(tree, prefix):
                for k, v in tree.items():
                    if isinstance(v, dict):
                        walk(v, prefix + k + "/")
                    else:
                        flat[prefix + k] = v
            walk(pc, "")
            assert flat == {k: _jspec(v) for k, v in jc.items()}, (arch, shape.name, mname)


def test_all_cells_and_model_flops_equal_the_jax_package():
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert len(tconfigs.all_cells()) == 40
    for arch in tconfigs.ARCH_NAMES:
        for shape in tconfigs.SHAPES.values():
            assert troof.model_flops(tconfigs.get_config(arch), shape) == \
                j_model_flops(jconfigs.get_config(arch), shape)


def test_mesh_axes_and_default_num_micro_with_a_mesh():
    for m in MESHES.values():
        jm = JMesh(m)
        assert dp_axes(m) == jsh.dp_axes(jm)
        for b in (1, 8, 32, 128, 256, 512):
            assert batch_spec_axes(m, b) == jsh.batch_spec_axes(jm, b)
        for arch in tconfigs.ARCH_NAMES:
            for shape in tconfigs.SHAPES.values():
                if shape.mode == "train":
                    assert default_num_micro(tconfigs.get_config(arch), shape, m) == \
                        j_default_num_micro(jconfigs.get_config(arch), shape, jm)


def test_roofline_terms_follow_the_h100_model():
    t = troof.roofline_terms(989e12, 3.35e12, 450e9 + 50e9, cross_pod_bytes=10e9,
                             network_bytes=50e9)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(2.0)        # 450 GB over NVLink + 50 over the network
    assert t["collective_nvlink_bytes"] == int(450e9) and t["collective_network_bytes"] == int(50e9)
    assert t["collective_cross_pod_bytes"] == int(10e9)
    assert t["collective_intra_bytes"] == int(490e9)
    assert t["bottleneck"] == "collective" and t["roofline_fraction"] == pytest.approx(0.5)
    only_pod = troof.roofline_terms(0.0, 0.0, 100e9, cross_pod_bytes=50e9)
    assert only_pod["collective_s"] == pytest.approx(50e9 / 450e9 + 50e9 / 50e9)
    assert troof.roofline_terms(0.0, 0.0, 0.0)["roofline_fraction"] == 0.0


def _synthetic_cells():
    ok = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "single", "status": "ok",
          "compile_s": 12.5, "memory": {"peak_bytes_per_device": 3 * 2**30},
          "analytic_param_bytes_per_device": 2**28,
          "hlo_cost": {"collective_counts": {"all-gather": 10, "reduce-scatter": 4,
                                             "all-to-all": 2}, "collective_total_bytes": 4e7},
          "roofline": {"compute_s": 0.5, "memory_s": 0.25, "collective_s": 1.5,
                       "bottleneck": "collective", "roofline_fraction": 1 / 3},
          "roofline_fused_attention": {"roofline_fraction": 0.4},
          "model_flops_global": 1.08e16, "useful_flops_ratio": 0.66}
    multi = dict(ok, mesh="multi")
    skip = {"arch": "qwen3-1.7b", "shape": "long_500k", "mesh": "single", "status": "skip",
            "why": "long_500k requires sub-quadratic attention (skip: full attention)"}
    err = {"arch": "olmo-1b", "shape": "decode_32k", "mesh": "multi", "status": "error",
           "why": "boom"}
    return [ok, multi, skip, dict(skip, mesh="multi"), err]


def test_report_tables_equal_the_jax_package():
    cells = _synthetic_cells()
    assert treport.dryrun_table(cells) == jreport.dryrun_table(cells)
    assert treport.skip_table(cells) == jreport.skip_table(cells)
    assert treport.roofline_table(cells, hints=jreport.HINTS) == jreport.roofline_table(cells)
    rows = treport.cell_table(cells).splitlines()
    assert rows[2] == ("| qwen3-1.7b | train_4k | 3.22 (4 %) | 0.0 | 3.22 (4 %) | 0.0 | 0.268 "
                       "| 0.5 / 0.25 / 1.5 | collective |")
    assert rows[3] == "| qwen3-1.7b | long_500k | skip |  | skip |  |  |  |  |"
    assert rows[4] == "| olmo-1b | decode_32k | not run |  | ERROR |  |  |  |  |"


def test_report_marks_cells_traced_on_other_sources():
    ok, multi, skip, skip_multi, err = _synthetic_cells()
    cells = [dict(ok, source="a"), dict(multi, source="b"), dict(skip, source="a"),
             dict(skip_multi, source="b"), dict(err, source="a")]
    rows = treport.cell_table(cells, source="a").splitlines()
    assert rows[2].startswith("| qwen3-1.7b | train_4k | 3.22 (4 %) | 0.0 | 3.22 (4 %) (stale) |")
    assert rows[3] == "| qwen3-1.7b | long_500k | skip |  | skip (stale) |  |  |  |  |"
    assert rows[4] == "| olmo-1b | decode_32k | not run |  | ERROR |  |  |  |  |"
    assert treport.cell_table(cells) == treport.cell_table(
        [{k: v for k, v in c.items() if k != "source"} for c in cells])


def test_input_specs_are_meta_stand_ins():
    cfg = tconfigs.get_config("pixtral-12b")
    specs = tconfigs.input_specs(cfg, tconfigs.get_shape("train_4k"))
    assert all(v.device.type == "meta" for v in specs.values())
    P = min(cfg.num_patches, 4096 // 2)
    assert specs["patches"].shape == (256, P, cfg.d_model)
    assert specs["tokens"].shape == (256, 4096 - P) and specs["tokens"].dtype == torch.int32
