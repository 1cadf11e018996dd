"""Shared checks of the moe family's training, the port against the JAX
package on the CPU (`tests/test_torch_train_mixtral.py` and
`tests/test_torch_train_deepseek.py` run them a model each).

- `check_loss_and_grads`: reduced configs in fp32 from the same weights
  (the JAX package's, carried over by `convert`) and tokens: loss, ce,
  aux (and mtp with the multi-token-prediction head) within TOL relative,
  and every gradient leaf within TOL of `jax.value_and_grad(loss_fn)` in
  relative L2, under remat "block".
- `check_remat`: remat "none" and "block" give equal losses and gradients
  within 1e-6, so the recompute in the backward routes every token as the
  forward did (the (E, C, D) buffer has one shape whatever the routing, so
  a routing that moved would change the gradients, not the shapes).
- `check_train_steps`: STEPS steps of `make_train_step` against the JAX
  package's jitted step from the same weights and batches, at the config's
  own optimizer, state dtype, accumulation dtype and `num_micro`: each
  step's metrics within STEP_TOL relative, and every parameter and moment
  after the last step in the JAX package's shape and dtype, within
  STEP_TOL in relative L2 (fp32 state and accumulation), or BF16_TOL with
  bf16 state or accumulation (one bf16 rounding: a gradient summed in
  another order may round to the neighbouring bf16 value, and Adafactor's
  update is of the gradient's relative size, so a parameter that starts at
  zero, a norm scale, carries that rounding whole).
The JAX side of each model is computed once a process.
"""

from __future__ import annotations

import functools
from dataclasses import replace

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
from repro_torch.optim import init_opt_state

TOL = 1e-5
STEP_TOL = 1e-4
BF16_TOL = 2 ** -8
STEPS = 3
KW = dict(lr=1e-2, warmup=2, total_steps=6, clip_norm=0.5)
# (B, S) of the gradient check and (B, S, num_micro) of the train steps: S
# past reduced mixtral's window of 64; deepseek-v3 at its own 4 micro-batches
GRAD_SHAPE = {"mixtral-8x7b": (2, 96), "deepseek-v3-671b": (2, 32)}
STEP_SHAPE = {"mixtral-8x7b": (4, 96, 2), "deepseek-v3-671b": (4, 32, 4)}


def cfgs(arch: str, remat: str = "block"):
    """(the JAX package's, the port's) reduced config of `arch` in fp32."""
    return (replace(jconfigs.reduced(jconfigs.get_config(arch)), dtype="float32", remat=remat),
            replace(tconfigs.reduced(tconfigs.get_config(arch)), dtype="float32", remat=remat))


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


def _to_np(tree):
    return jax.tree.map(lambda a: np.array(jnp.asarray(a, jnp.float32)), tree)


def _tokens(arch: str, shape, seed: int) -> np.ndarray:
    vocab = cfgs(arch)[1].vocab_size
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch: str):
    jcfg, _ = cfgs(arch)
    params = j_init_params(jcfg, jax.random.PRNGKey(11))
    toks = jnp.asarray(_tokens(arch, GRAD_SHAPE[arch], 3))
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, p, {"tokens": toks}), has_aux=True))(params)
    return (jax.tree.map(np.asarray, params), float(loss), {k: float(v) for k, v in m.items()},
            jax.tree.map(np.asarray, grads))


def port_loss_and_grads(arch: str, remat: str):
    """(cfg, model with its gradients, loss, metrics, plain attention calls)."""
    params = jax_loss_and_grads(arch)[0]
    _, cfg = cfgs(arch, remat)
    model = convert.lm_params_from_reference(cfg, params, device="cpu").requires_grad_()
    kref.reset_call_counts()
    loss, m = loss_fn(cfg, model, {"tokens": torch.from_numpy(_tokens(arch, GRAD_SHAPE[arch], 3))})
    loss.backward()
    return cfg, model, loss, m, dict(kref.call_counts)


def check_loss_and_grads(arch: str) -> dict:
    """Returns the port's plain attention calls, for the caller's count."""
    _params, jloss, jm, jgrads = jax_loss_and_grads(arch)
    cfg, model, loss, m, calls = port_loss_and_grads(arch, "block")
    assert set(m) == set(jm) == ({"ce", "aux", "mtp"} if cfg.mtp_depth else {"ce", "aux"})
    assert abs(loss.item() - jloss) <= TOL * abs(jloss), (loss.item(), jloss)
    for k, want in jm.items():
        assert abs(m[k].item() - want) <= TOL * abs(want), (k, m[k].item(), want)
    assert m["aux"].item() > 0
    named = dict(model.named_parameters())
    per_layer = sum(1 for n in named if n.startswith("layers.0."))
    assert len(named) == sum(1 for n in named if not n.startswith("layers.")) + \
        cfg.num_layers * per_layer
    for name, p in named.items():
        want = convert._ref_leaf(jgrads, name)
        assert p.grad is not None and p.grad.shape == want.shape, name
        assert rel(p.grad, want) <= TOL, (name, rel(p.grad, want))
    return calls


def check_remat(arch: str) -> None:
    _cfg, block, loss_b, m_b, _ = port_loss_and_grads(arch, "block")
    _cfg, none, loss_n, m_n, _ = port_loss_and_grads(arch, "none")
    torch.testing.assert_close(loss_b, loss_n, rtol=1e-6, atol=0)
    torch.testing.assert_close(m_b["aux"], m_n["aux"], rtol=1e-6, atol=0)
    for (name, a), (_, b) in zip(block.named_parameters(), none.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7, msg=name)


def _batches(arch: str) -> list:
    B, S, _n = STEP_SHAPE[arch]
    return [_tokens(arch, (B, S), 21 + i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def jax_train_run(arch: str):
    """The JAX package's STEPS steps: (start weights, each step's metrics,
    weights and state after them)."""
    jcfg, _ = cfgs(arch)
    params = j_init_params(jcfg, jax.random.PRNGKey(5))
    start = jax.tree.map(np.asarray, params)
    opt = j_init_opt(params, jcfg.optimizer, jcfg.opt_state_dtype)
    step = jax.jit(j_make_step(jcfg, num_micro=STEP_SHAPE[arch][2], **KW))
    metrics = []
    for i, toks in enumerate(_batches(arch)):
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(toks)}, jnp.int32(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return start, metrics, _to_np(params), opt


def check_train_steps(arch: str) -> None:
    start, want_metrics, want_params, want_opt = jax_train_run(arch)
    _, cfg = cfgs(arch)
    model = convert.lm_params_from_reference(cfg, start, device="cpu")
    opt = init_opt_state(model, cfg.optimizer, cfg.opt_state_dtype)
    step = make_train_step(cfg, num_micro=STEP_SHAPE[arch][2], **KW)
    for i, toks in enumerate(_batches(arch)):
        model, opt, m = step(model, opt, {"tokens": torch.from_numpy(toks)}, i)
        want = want_metrics[i]
        assert set(m) == set(want)
        for k in want:
            assert abs(float(m[k]) - want[k]) <= STEP_TOL * abs(want[k]), \
                (i, k, float(m[k]), want[k])
    got = convert.opt_state_to_reference(model, opt)
    assert int(got.step) == int(want_opt.step) == STEPS
    tol = BF16_TOL if "bfloat16" in (cfg.opt_state_dtype, cfg.grad_acc_dtype) else STEP_TOL
    for tree, want in ((convert.lm_params_to_reference(model), want_params),
                       (got.mu, want_opt.mu), (got.nu, want_opt.nu)):
        got_leaves, want_leaves = jax.tree.leaves(tree), jax.tree.leaves(want)
        assert len(got_leaves) == len(want_leaves)
        for a, b in zip(got_leaves, want_leaves):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), (a.dtype, b.dtype)
            assert rel(a.float(), np.asarray(jnp.asarray(b, jnp.float32))) <= tol
