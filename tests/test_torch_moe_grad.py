"""The gradients of the port's MoE layer (`repro_torch.models.moe.moe_layer`)
against `jax.grad` of the JAX package's, on the CPU.

The same parameters (the JAX package's `_moe_init`, as numpy) and inputs
(numpy, seeded) in fp32; the scalar is sum(out * dout) + 3 aux, so the
router gets the gradient of the aux loss (through `probs.mean(0)`) beside
the gates' (through the softmax, `topk` and the renormalisation), the
experts theirs through the three `bmm`s, and x its own through the
`index_copy_` dispatch, the k-order combine and the router.  Every
gradient, x's and each weight's, within 1e-5 of the reference in relative
L2.  Cases: reduced mixtral with no drops, and at a capacity factor of 0.5,
which drops routed pairs (a dropped pair passes no gradient: the JAX layer
adds a masked zero into slot (E - 1, C - 1), the port sends it to a spare
row it cuts off); reduced deepseek-v3's shared expert, with drops too.
The JAX side of each case is computed once.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as jmoe
from repro.models.lm import _moe_init
import repro_torch.configs as tconfigs
from repro_torch.models import moe

TOL = 1e-5
AUX_WEIGHT = 3.0
B, S = 2, 40
CASES = {
    "mixtral": ("mixtral-8x7b", {}),
    "mixtral-drops": ("mixtral-8x7b", {"capacity_factor": 0.5}),
    "deepseek-shared-drops": ("deepseek-v3-671b", {"num_experts": 8, "top_k": 4,
                                                    "capacity_factor": 0.5}),
}


def _cfgs(case):
    arch, over = CASES[case]
    j = jconfigs.reduced(jconfigs.get_config(arch))
    t = tconfigs.reduced(tconfigs.get_config(arch))
    return (replace(j, dtype="float32", moe=replace(j.moe, **over)),
            replace(t, dtype="float32", moe=replace(t.moe, **over)))


def _inputs(cfg):
    rng = np.random.default_rng(7)
    return [rng.standard_normal((B, S, cfg.d_model)).astype(np.float32) for _ in range(2)]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    jcfg, _ = _cfgs(case)
    p = jax.tree.map(lambda a: np.array(a, np.float32),
                     _moe_init(jcfg, jax.random.PRNGKey(4), jnp.float32))
    x, dout = _inputs(jcfg)

    def f(p, x):
        out, aux = jmoe.moe_layer(jcfg, p, x)
        return jnp.sum(out * dout) + AUX_WEIGHT * aux

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, x)
    return p, jax.tree.map(np.asarray, gp), np.asarray(gx)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_layer_gradients_match_jax_grad(case):
    p, want_p, want_x = _jax_grads(case)
    _, cfg = _cfgs(case)
    x, dout = (torch.from_numpy(a) for a in _inputs(cfg))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    x.requires_grad_(True)
    out, aux = moe.moe_layer(cfg, tp, x)
    (torch.sum(out * dout) + AUX_WEIGHT * aux).backward()
    assert set(tp) == set(want_p)
    assert (cfg.moe.num_shared > 0) == ("shared_gate" in tp)
    assert _rel(x.grad, want_x) <= TOL, ("x", _rel(x.grad, want_x))
    for k, t in tp.items():
        assert t.grad is not None and _rel(t.grad, want_p[k]) <= TOL, (k, _rel(t.grad, want_p[k]))


@pytest.mark.parametrize("case", ["mixtral-drops", "deepseek-shared-drops"])
def test_a_dropped_pair_passes_no_gradient(case):
    """With the shared experts zeroed and no aux term, a token whose every
    routed pair is dropped has an output row of zeros and gets a gradient
    of exactly zero (none through the dispatch, and none through its gates,
    whose rows are zero); a token with a kept pair gets one."""
    p, _, _ = _jax_grads(case)
    _, cfg = _cfgs(case)
    x, dout = (torch.from_numpy(a) for a in _inputs(cfg))
    T, D = B * S, cfg.d_model
    keep = moe.route(cfg, torch.from_numpy(p["router"]), x.reshape(T, D))[4]
    kept = keep.view(T, cfg.moe.top_k).any(1)
    assert bool((~kept).any()) and bool(kept.any())      # the case drops whole tokens
    tp = {k: torch.zeros_like(torch.from_numpy(v)) if k.startswith("shared_")
          else torch.from_numpy(v) for k, v in p.items()}
    x.requires_grad_(True)
    out, _aux = moe.moe_layer(cfg, tp, x)
    torch.sum(out * dout).backward()
    assert float(out.detach().reshape(T, D)[~kept].abs().max()) == 0.0
    assert float(x.grad.reshape(T, D)[~kept].abs().max()) == 0.0
    assert bool((x.grad.reshape(T, D)[kept].abs().amax(1) > 0).all())
