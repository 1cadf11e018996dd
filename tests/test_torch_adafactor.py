"""Adafactor over the JAX package's stacked layers, its state and its
trainer, the port against the JAX package on the CPU.

The JAX package's Adafactor runs on its stacked tree: a leaf of a layer
stack has a leading layer axis L, so its row and column statistics and
its RMS clip span the layers, and a per-layer norm weight (D,) is a
factored (L, D) leaf.  On the reduced deepseek-v3 tree (MLA, routed and
shared experts, the MTP head), fp32 and bf16 states, three steps from
zero state with the same gradients: the port's updates of its per-layer
parameters within 1e-6 of the JAX package's (relative L2; fp32 in another
order), and its state, carried into the JAX tree, in the same shapes and
dtypes within 1e-6 (fp32) or one bf16 rounding (2^-8).  Adafactor a
parameter each (its state made from the dict of the named parameters, not
from the LM) gives other updates, so the check bites.
The state converts to the JAX tree and back exactly, and a checkpoint of
(params, opt) is the JAX package's byte for byte.  A `Trainer` run with
Adafactor, stopped at step 5 and restarted, gives the uninterrupted run's
losses within rtol 1e-5 (the reference's restart test).  The JAX side is
computed once a state dtype.
"""

import functools
import json
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.optim as jopt
from repro.checkpoint import save_checkpoint as j_save
from repro.models import init_params as j_init_params
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import save_checkpoint
from repro_torch.launch.train import abstract_train_state, make_train_step
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adafactor_update, init_opt_state
from repro_torch.runtime import Trainer, TrainerConfig

ARCH = "deepseek-v3-671b"
TOL = 1e-6
BF16_TOL = 2 ** -8
STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (replace(jconfigs.reduced(jconfigs.get_config(ARCH)), dtype="float32"),
            replace(tconfigs.reduced(tconfigs.get_config(ARCH)), dtype="float32"))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


def _grads(params, i: int):
    rng = np.random.default_rng(100 + i)
    return jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


@functools.lru_cache(maxsize=None)
def _jax_run(dtype: str):
    """Three steps of the JAX package's Adafactor on its stacked tree: the
    weights, each step's updates, and the state after them."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(6)))
    state = jopt.init_opt_state(params, "adafactor", dtype)
    ups = []
    for i in range(STEPS):
        u, state = jopt.adafactor_update(_grads(params, i), state, params, 1e-3 * (i + 1))
        ups.append(jax.tree.map(np.asarray, u))
    return params, ups, state


def _port_run(dtype: str, per_layer: bool = False):
    """The port's three steps from the same weights and gradients, its
    state made from the LM (stacked groups) or, `per_layer`, from the dict
    of its named parameters (a state a parameter each)."""
    params, _, _ = _jax_run(dtype)
    _, cfg = _cfgs()
    model = convert.lm_params_from_reference(cfg, params, device="cpu")
    state = init_opt_state(dict(model.named_parameters()) if per_layer else model, "adafactor",
                           dtype)
    ups = []
    for i in range(STEPS):
        g = _grads(params, i)
        grads = {n: torch.from_numpy(convert._ref_leaf(g, n)) for n, _ in model.named_parameters()}
        u, state = adafactor_update(grads, state, model, 1e-3 * (i + 1))
        ups.append(u)
    return model, ups, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_on_per_layer_leaves_equals_the_stacked_reference(dtype):
    _params, want_ups, want_state = _jax_run(dtype)
    model, ups, state = _port_run(dtype)
    assert state.nu["layers.*.attn_norm"][0].shape == (2,)              # (L,) and (D,)
    assert state.nu["layers.*.attn_norm"][1].shape == (128,)
    assert state.nu["mtp_norm"][1].shape == ()                           # unstacked: unfactored
    for i in range(STEPS):
        assert set(ups[i]) == {n for n, _ in model.named_parameters()}
        for name, u in ups[i].items():
            want = convert._ref_leaf(want_ups[i], name)
            assert u.dtype == torch.float32 and _rel(u, want) <= TOL, (i, name, _rel(u, want))
    got = convert.opt_state_to_reference(model, state)
    assert int(got.step) == int(want_state.step) == STEPS
    tol = TOL if dtype == "float32" else BF16_TOL
    want_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    got_leaves, want_leaves = jax.tree.leaves(got[1:]), jax.tree.leaves(want_state[1:])
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == want_dt and tuple(a.shape) == b.shape
        assert _rel(a.float(), b) <= tol


def test_adafactor_a_parameter_each_is_another_function():
    """Without the stacked groups the 1-D norm weights go unfactored and the
    clip is taken a layer at a time: the updates move away from the
    reference's."""
    _params, want_ups, _ = _jax_run("float32")
    model, ups, state = _port_run("float32", per_layer=True)
    assert "layers.0.attn_norm" in state.nu and not any("*" in k for k in state.nu)
    worst = max(_rel(u, convert._ref_leaf(want_ups[-1], n)) for n, u in ups[-1].items())
    assert worst > 1e-2


def test_adafactor_state_round_trips_exactly_and_checkpoints_as_the_reference(tmp_path):
    params, _, want = _jax_run("bfloat16")
    _, cfg = _cfgs()
    model = convert.lm_params_from_reference(cfg, params, device="cpu")
    to_np = lambda t: jax.tree.map(np.asarray, t)       # noqa: E731
    opt = convert.opt_state_from_reference(model, to_np(want))
    assert opt.nu["layers.*.moe.experts_gate"][0].dtype == torch.bfloat16
    back = convert.opt_state_to_reference(model, opt)
    got_leaves, want_leaves = jax.tree.leaves(back), jax.tree.leaves(want)
    assert jax.tree.structure(tuple(back)) == jax.tree.structure(tuple(want))
    for a, b in zip(got_leaves, want_leaves):
        assert tuple(a.shape) == b.shape and str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert torch.equal(a.float(), torch.from_numpy(np.asarray(b, np.float32)))
    j_save(tmp_path / "jax", (params, want), step=3)
    save_checkpoint(tmp_path / "port", (convert.lm_params_to_reference(model), back), step=3)
    a, b = tmp_path / "port" / "step_3", tmp_path / "jax" / "step_3"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    manifest = json.loads((a / "manifest.json").read_text())
    assert "bfloat16" in {e["dtype"] for e in manifest["leaves"]}


def test_abstract_train_state_holds_adafactor_in_stacked_shapes():
    cfg = tconfigs.get_config(ARCH)
    params, opt = abstract_train_state(cfg)
    L, E, D, F = cfg.num_layers, cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    vr, vc = opt.nu["layers.*.moe.experts_gate"]
    assert (tuple(vr.shape), tuple(vc.shape)) == ((L, E, D), (L, E, F))
    assert vr.device.type == "meta" and vr.dtype == torch.bfloat16
    assert [tuple(t.shape) for t in opt.nu["layers.*.attn_norm"]] == [(L,), (D,)]
    assert [tuple(t.shape) for t in opt.nu["mtp_norm"]] == [(D,), ()]
    assert opt.mu["layers.*.moe.experts_gate"].shape == ()
    assert not any(k.startswith("layers.0.") for k in opt.nu)


SEQ, GB, SEED = 32, 4, 3


def _trainer(ckpt: Path, max_steps: int):
    _, cfg = _cfgs()
    shape = ShapeConfig("test", SEQ, GB, "train")
    return Trainer(cfg, shape, TrainerConfig(ckpt_dir=str(ckpt), ckpt_every=5,
                                             max_steps=max_steps),
                   step_fn=make_train_step(cfg, num_micro=cfg.num_micro_override, lr=1e-3),
                   seed=SEED, device="cpu")


def test_adafactor_trainer_restart_is_identical(tmp_path):
    _, _, full = _trainer(tmp_path / "full", 10).run(seed=1)
    want = {r["step"]: r["loss"] for r in full}
    _trainer(tmp_path / "resume", 5).run(seed=1)
    ckpt = json.loads((tmp_path / "resume" / "step_4" / "manifest.json").read_text())
    assert "bfloat16" in {e["dtype"] for e in ckpt["leaves"]}       # the factored moments
    params, opt, resumed = _trainer(tmp_path / "resume", 10).run(seed=1)
    assert [r["step"] for r in resumed] == list(range(5, 10))
    for r in resumed:
        assert abs(r["loss"] - want[r["step"]]) <= 1e-5 * abs(want[r["step"]]), r
    assert int(opt.step) == 10 and "layers.*.attn.q_up" in opt.nu
