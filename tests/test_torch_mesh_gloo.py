"""The port on a (2, 2) DeviceMesh of 4 CPU processes over gloo
(`tests/_torch_mesh_ranks.py`'s rank script, which imports no JAX, through
`repro_torch.launch.multiproc.run_ranks`), against the unsharded port and
the JAX package.

- reduced qwen3, mixtral (fsdp: ZeRO gathers) and mamba2 in fp32: the
  sharded loss (and mixtral's aux) within 1e-5 of the unsharded port's,
  every gradient within 1e-5 in relative L2; qwen3's sharded loss also
  within 1e-5 of the JAX package's `loss_fn` on the same weights
  (`convert.lm_params_to_reference`);
- reduced mixtral at capacity factor 1, where the experts drop pairs: the
  same, and the sharded run drops the unsharded one's pairs, layer by
  layer, and its loss and aux equal the JAX package's;
- two train steps of reduced mixtral sharded (2 micro-batches) against the
  unsharded steps: losses within 1e-5, parameters within 1e-4 (relative
  L2, as `test_torch_train_step.py` holds steps);
- `moe_layer_a2a` against `moe_layer` within 2e-5, the aux loss within
  rtol 0.25 (the per-shard estimator, as `tests/models/test_moe_a2a.py`
  holds the JAX pair), and the gradients of sum(out w) within 2e-5;
- three error-feedback steps of `compressed_psum` against the JAX
  package's under `jax.vmap(..., axis_name=...)` on the same per-rank
  inputs: exact (the same fp32 operations in the same order);
- a sharded checkpoint saved on (2, 2) and restored onto (1, 4): equal
  byte for byte, and its manifest in the JAX package's sharded layout.
"""

import functools
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace

from repro.models import loss_fn as j_loss_fn
from repro.optim import compressed_psum as j_compressed_psum
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.launch.multiproc import run_ranks
from repro_torch.models import init_params

from _torch_mesh_ranks import MESH_SCRIPT


# one fleet of 4 processes runs every case in turn
CASES = "qwen3,mixtral,mamba2,mixtral_drop,train,a2a,psum,ckpt"


@functools.lru_cache(maxsize=None)
def _fleet(tmp: str) -> None:
    run_ranks(MESH_SCRIPT, 4, extra_args=(tmp, "cpu", CASES), timeout=300)


def _run(case: str, tmp: str) -> dict:
    _fleet(tmp)
    return json.loads((Path(tmp) / f"{case}.json").read_text())


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("case", ["qwen3", "mixtral", "mamba2", "mixtral_drop"])
def test_sharded_loss_and_gradients_equal_the_unsharded_port(case, outdir):
    r = _run(case, outdir)
    assert r["loss_mesh"] == pytest.approx(r["loss"], rel=1e-5)
    assert r["aux_mesh"] == pytest.approx(r["aux"], rel=1e-5, abs=1e-7)
    assert r["grad_err"] < 1e-5
    # the weights really are split: TP over 'model', and ZeRO over 'data' with fsdp
    pl = r["placements"]
    if case == "mamba2":
        assert pl["layers.0.ssm.out_proj"] == ["R", "S(0)"] and pl["tok_embed"] == ["R", "S(0)"]
        return
    assert pl["layers.0.attn.wq"][1] == "S(1)"
    if case.startswith("mixtral"):
        assert pl["layers.0.attn.wq"][0] == "S(0)"
        assert pl["layers.0.moe.experts_gate"] == ["S(1)", "S(0)"]
    else:
        assert pl["layers.0.attn.wq"][0] == "R"


def test_sharded_loss_equals_the_jax_package(outdir):
    r = _run("qwen3", outdir)
    cfg = replace(tconfigs.reduced(tconfigs.get_config("qwen3-1.7b")), dtype="float32")
    tree = convert.lm_params_to_reference(init_params(cfg, seed=0, device="cpu"))
    tree = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (4, 32), generator=g, dtype=torch.int32)
    jloss, _ = j_loss_fn(cfg, tree, {"tokens": jnp.asarray(tok.numpy())})
    assert r["loss_mesh"] == pytest.approx(float(jloss), rel=1e-5)


def test_sharded_moe_drops_what_the_unsharded_layer_drops(outdir):
    """At capacity factor 1 the experts drop pairs; each data shard keeps
    and drops what the whole batch's route would (the batch's capacity,
    positions counted from the shards ahead), so the loss equals the
    unsharded port's and the JAX package's `loss_fn`, whose layer routes
    the whole batch."""
    r = _run("mixtral_drop", outdir)
    assert len(r["dropped"]) == 2 and all(n > 0 for n in r["dropped"])
    assert r["dropped_mesh"] == r["dropped"]
    cfg = replace(tconfigs.reduced(tconfigs.get_config("mixtral-8x7b")), dtype="float32")
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=1.0))
    tree = convert.lm_params_to_reference(init_params(cfg, seed=0, device="cpu"))
    tree = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (4, 32), generator=g, dtype=torch.int32)
    jloss, jm = j_loss_fn(cfg, tree, {"tokens": jnp.asarray(tok.numpy())})
    assert r["loss_mesh"] == pytest.approx(float(jloss), rel=1e-5)
    assert r["aux_mesh"] == pytest.approx(float(jm["aux"]), rel=1e-5)


def test_sharded_train_steps_equal_the_unsharded_port(outdir):
    r = _run("train", outdir)
    for unsharded, sharded in r["losses"]:
        assert sharded == pytest.approx(unsharded, rel=1e-5)
    assert r["param_err"] < 1e-4


def test_moe_layer_a2a_equals_moe_layer(outdir):
    r = _run("a2a", outdir)
    assert r["out_err"] < 2e-5
    assert r["aux_a2a"] == pytest.approx(r["aux"], rel=0.25)
    assert max(r["grad_err"].values()) < 2e-5 and r["x_grad_err"] < 2e-5
    assert r["a2a_placements"] == ["S(0)", "S(1)"]        # batch over data, tokens over model


def test_compressed_psum_equals_the_jax_package(outdir):
    _run("psum", outdir)
    got = np.load(Path(outdir) / "psum.npz")
    xs = jnp.asarray(got["x"])

    def step(x, r):
        return j_compressed_psum(x, "i", residual=r)

    res = jnp.zeros_like(xs)
    for k in range(3):
        out, res = jax.vmap(step, axis_name="i")(xs, res)
        np.testing.assert_array_equal(got["out"][:, k], np.asarray(out))
        np.testing.assert_array_equal(got["res"][:, k], np.asarray(res))
    # the four ranks agree, and the mean is near the exact one
    assert np.all(got["out"][:, 0] == got["out"][0, 0])
    want = got["x"].mean(0)
    assert np.abs(got["out"][0, 0] - want).max() < 0.02 * np.abs(want).max()


def test_sharded_checkpoint_restores_onto_another_mesh(outdir):
    r = _run("ckpt", outdir)
    assert r["w_equal"] and r["r_equal"] and r["b"] == [0, 1, 2]
    assert r["mesh2"] == [1, 4] and r["w_local"] == [8, 2]
    m = r["manifest"]
    assert m["sharded"] and m["num_leaves"] == 3
    assert m["treedef"] == "PyTreeDef({'b': *, 'r': *, 'w': *})"
    w = m["leaves"][2]
    assert list(w) == ["index", "dtype", "shape", "files"] and w["shape"] == [8, 8]
    # the JAX package's names: arr_<i>.shard<replica>_<starts>.npy, one per block
    names = sorted(f["file"] for f in w["files"])
    assert names == [f"arr_2.shard0_{a}_{b}.npy" for a in (0, 4) for b in (0, 4)]
    for f in w["files"]:
        a, b = map(int, re.match(r"arr_2\.shard0_(\d+)_(\d+)\.npy", f["file"]).groups())
        assert f["index"] == [[a, a + 4], [b, b + 4]]
    assert all("file" in e for e in m["leaves"][:2])      # unsplit leaves are gathered
