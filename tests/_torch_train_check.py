"""Shared checks of training a model of any family, the port against the
JAX package on the CPU (`tests/test_torch_train_{mixtral,deepseek,ssm,
hybrid,encdec,vlm}.py` run them a case each).

A case (`CASES`) is a reduced config in fp32, with `num_layers` where
given, the (B, S) of its gradient check, the (B, S, num_micro) of its
train steps and their count.  A batch is numpy from a seed: tokens, and
for encdec frames (B, encoder_seq, D), for vlm patches (B, num_patches,
D), each 0.1 times a standard normal (as `tests/_torch_family.py` draws
them).
- `check_loss_and_grads`: from the same weights (the JAX package's,
  carried over by `convert`) and batch: loss, ce, aux (and mtp with the
  multi-token-prediction head) within TOL relative, and every gradient
  leaf within TOL of `jax.value_and_grad(loss_fn)` in relative L2, under
  remat "block".
- `check_remat`: remat "none" and "block" give equal losses and gradients
  within 1e-6 (for MoE: the recompute in the backward routes every token
  as the forward did; the (E, C, D) buffer has one shape whatever the
  routing, so a routing that moved would change the gradients, not the
  shapes).
- `check_train_steps`: the case's steps of `make_train_step` against the
  JAX package's jitted step from the same weights and batches, at the
  config's own optimizer, state dtype, accumulation dtype and the case's
  `num_micro`: each step's metrics within STEP_TOL relative, and every
  parameter and moment after the last step in the JAX package's shape and
  dtype, within STEP_TOL in relative L2 (fp32 state and accumulation), or
  BF16_TOL with bf16 state or accumulation (one bf16 rounding: a gradient
  summed in another order may round to the neighbouring bf16 value, and
  Adafactor's update is of the gradient's relative size, so a parameter
  that starts at zero, a norm scale, carries that rounding whole).
The JAX side of each case is computed once a process.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.launch.train import make_train_step as j_make_step
from repro.models import init_params as j_init_params, loss_fn as j_loss_fn
from repro.optim import init_opt_state as j_init_opt
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ref as kref
from repro_torch.launch.train import make_train_step
from repro_torch.models import loss_fn
from repro_torch.models.lm import STACKED
from repro_torch.optim import init_opt_state

TOL = 1e-5
STEP_TOL = 1e-4
BF16_TOL = 2 ** -8
KW = dict(lr=1e-2, warmup=2, total_steps=6, clip_norm=0.5)


@dataclass(frozen=True)
class TrainCase:
    arch: str
    grad: tuple                 # (B, S) of the gradient check
    step: tuple                 # (B, S, num_micro) of the train steps
    steps: int                  # how many train steps
    num_layers: int | None = None


# S past reduced mixtral's and recurrentgemma's window of 64; deepseek-v3
# at its own 4 micro-batches; mamba2's S a multiple of its chunk of 32;
# whisper's S not its 32 frames (the cross attention plain, Sq != Sk);
# pixtral's S the tokens after its 16 patches; recurrentgemma with a tail
# (5 = one super-block of 3 and 2 rec blocks, as 38 = 12 x 3 + 2)
CASES = {
    "mixtral-8x7b": TrainCase("mixtral-8x7b", (2, 96), (4, 96, 2), 3),
    "deepseek-v3-671b": TrainCase("deepseek-v3-671b", (2, 32), (4, 32, 4), 3),
    "mamba2-130m": TrainCase("mamba2-130m", (2, 64), (4, 64, 2), 2),
    "recurrentgemma-9b": TrainCase("recurrentgemma-9b", (2, 96), (4, 96, 2), 2),
    "recurrentgemma-9b tail": TrainCase("recurrentgemma-9b", (2, 40), (4, 40, 2), 2, 5),
    "whisper-medium": TrainCase("whisper-medium", (2, 40), (4, 40, 2), 2),
    "pixtral-12b": TrainCase("pixtral-12b", (2, 32), (4, 32, 2), 2),
}


def cfgs(name: str, remat: str = "block"):
    """(the JAX package's, the port's) reduced config of case `name` in
    fp32."""
    case = CASES[name]
    out = []
    for pkg in (jconfigs, tconfigs):
        cfg = replace(pkg.reduced(pkg.get_config(case.arch)), dtype="float32", remat=remat)
        out.append(cfg if case.num_layers is None else replace(cfg, num_layers=case.num_layers))
    return tuple(out)


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


def _to_np(tree):
    return jax.tree.map(lambda a: np.array(jnp.asarray(a, jnp.float32)), tree)


def batch(name: str, B: int, S: int, seed: int) -> dict:
    """The numpy batch of case `name`: tokens (B, S), and the family's
    frames or patches."""
    cfg = cfgs(name)[1]
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = 0.1 * rng.standard_normal((B, cfg.encoder_seq, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.family == "vlm":
        out["patches"] = 0.1 * rng.standard_normal((B, cfg.num_patches, cfg.d_model),
                                                   dtype=np.float32)
    return out


def _jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(name: str):
    jcfg, _ = cfgs(name)
    params = j_init_params(jcfg, jax.random.PRNGKey(11))
    b = _jax_batch(batch(name, *CASES[name].grad, 3))
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, p, b), has_aux=True))(params)
    return (jax.tree.map(np.asarray, params), float(loss), {k: float(v) for k, v in m.items()},
            jax.tree.map(np.asarray, grads))


def port_loss_and_grads(name: str, remat: str):
    """(cfg, model with its gradients, loss, metrics, plain attention calls)."""
    params = jax_loss_and_grads(name)[0]
    _, cfg = cfgs(name, remat)
    model = convert.lm_params_from_reference(cfg, params, device="cpu").requires_grad_()
    kref.reset_call_counts()
    loss, m = loss_fn(cfg, model, _torch_batch(batch(name, *CASES[name].grad, 3)))
    loss.backward()
    return cfg, model, loss, m, dict(kref.call_counts)


def check_loss_and_grads(name: str) -> dict:
    """Returns the port's plain attention calls, for the caller's count."""
    _params, jloss, jm, jgrads = jax_loss_and_grads(name)
    cfg, model, loss, m, calls = port_loss_and_grads(name, "block")
    assert set(m) == set(jm) == ({"ce", "aux", "mtp"} if cfg.mtp_depth else {"ce", "aux"})
    assert abs(loss.item() - jloss) <= TOL * abs(jloss), (loss.item(), jloss)
    for k, want in jm.items():
        assert abs(m[k].item() - want) <= TOL * abs(want), (k, m[k].item(), want)
    assert (m["aux"].item() > 0) == (cfg.moe is not None)
    named = dict(model.named_parameters())
    # every JAX leaf has its port parameter (a stacked leaf: layer 0's), and
    # every parameter, of every layer, its gradient
    firsts = [n for n in named if n.split(".")[0] not in STACKED or n.split(".")[1] == "0"]
    assert len(firsts) == len(jax.tree.leaves(jgrads))
    for name_, p in named.items():
        want = convert._ref_leaf(jgrads, name_)
        assert p.grad is not None and p.grad.shape == want.shape, name_
        assert rel(p.grad, want) <= TOL, (name_, rel(p.grad, want))
    return calls


def check_remat(name: str) -> None:
    _cfg, block, loss_b, m_b, _ = port_loss_and_grads(name, "block")
    _cfg, none, loss_n, m_n, _ = port_loss_and_grads(name, "none")
    torch.testing.assert_close(loss_b, loss_n, rtol=1e-6, atol=0)
    torch.testing.assert_close(m_b["aux"], m_n["aux"], rtol=1e-6, atol=0)
    for (n, a), (_, b) in zip(block.named_parameters(), none.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7, msg=n)


def _batches(name: str) -> list:
    case = CASES[name]
    B, S, _n = case.step
    return [batch(name, B, S, 21 + i) for i in range(case.steps)]


@functools.lru_cache(maxsize=None)
def jax_train_run(name: str):
    """The JAX package's steps: (start weights, each step's metrics,
    weights and state after them)."""
    jcfg, _ = cfgs(name)
    params = j_init_params(jcfg, jax.random.PRNGKey(5))
    start = jax.tree.map(np.asarray, params)
    opt = j_init_opt(params, jcfg.optimizer, jcfg.opt_state_dtype)
    step = jax.jit(j_make_step(jcfg, num_micro=CASES[name].step[2], **KW))
    metrics = []
    for i, b in enumerate(_batches(name)):
        params, opt, m = step(params, opt, _jax_batch(b), jnp.int32(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return start, metrics, _to_np(params), opt


def check_train_steps(name: str) -> None:
    start, want_metrics, want_params, want_opt = jax_train_run(name)
    _, cfg = cfgs(name)
    model = convert.lm_params_from_reference(cfg, start, device="cpu")
    opt = init_opt_state(model, cfg.optimizer, cfg.opt_state_dtype)
    step = make_train_step(cfg, num_micro=CASES[name].step[2], **KW)
    for i, b in enumerate(_batches(name)):
        model, opt, m = step(model, opt, _torch_batch(b), i)
        want = want_metrics[i]
        assert set(m) == set(want)
        for k in want:
            assert abs(float(m[k]) - want[k]) <= STEP_TOL * abs(want[k]), \
                (i, k, float(m[k]), want[k])
    got = convert.opt_state_to_reference(model, opt)
    assert int(got.step) == int(want_opt.step) == CASES[name].steps
    tol = BF16_TOL if "bfloat16" in (cfg.opt_state_dtype, cfg.grad_acc_dtype) else STEP_TOL
    for tree, want in ((convert.lm_params_to_reference(model), want_params),
                       (got.mu, want_opt.mu), (got.nu, want_opt.nu)):
        assert jax.tree.structure(jax.tree.map(lambda _: 0, tree)) == \
            jax.tree.structure(jax.tree.map(lambda _: 0, want))
        got_leaves, want_leaves = jax.tree.leaves(tree), jax.tree.leaves(want)
        assert len(got_leaves) == len(want_leaves)
        for a, b in zip(got_leaves, want_leaves):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), (a.dtype, b.dtype)
            assert rel(a.float(), np.asarray(jnp.asarray(b, jnp.float32))) <= tol
