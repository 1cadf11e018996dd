"""The port's MoE layer (`repro_torch.models.moe`) against the JAX package's
`repro.models.moe`, on the CPU.

The same parameters (the JAX package's `_moe_init`, carried over as numpy)
and inputs (numpy, seeded) go through both `moe_layer`s.  The routing must
be equal, not close: each routed pair's expert (`ids`), its slot in the
expert's buffer (`pos`) and whether it is kept (`keep`), against a
transcription of the JAX layer's routing lines (`src/repro/models/moe.py`
:38-50) in jnp.  The aux loss within 1e-6.  The output in fp32 within
rtol 1e-5 and an atol of 1e-5 of the reference's max |value|: the experts
sum terms of the output's size (up to about 50 here, from the reference's
expert scale 1/sqrt(E)) in another order, so a value that cancels to
near 0 keeps an error of a few fp32 ulps of that size.  In bf16 max
|difference| within 2e-2 of the reference's max |value| (a scale-relative
bound, as `tests/test_torch_lm.py` states for bf16: both packages round the
expert matmuls to bf16 at the same places but sum in another order).
Cases: reduced mixtral (4 experts, top 2, no drops); a capacity factor of
0.5, which drops routed pairs; reduced deepseek's shared expert with top 8
over 16 experts.  The JAX side of each case is
computed once.
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

B, S = 2, 24
CASES = {
    "mixtral": ("mixtral-8x7b", {}),
    "mixtral-drops": ("mixtral-8x7b", {"capacity_factor": 0.5}),
    "deepseek-16x8": ("deepseek-v3-671b", {"num_experts": 16, "top_k": 8}),
}


def _cfgs(case, dtype):
    arch, over = CASES[case]
    j = jconfigs.reduced(jconfigs.get_config(arch))
    t = tconfigs.reduced(tconfigs.get_config(arch))
    return (replace(j, dtype=dtype, moe=replace(j.moe, **over)),
            replace(t, dtype=dtype, moe=replace(t.moe, **over)))


def _jax_routing(cfg, router, xt):
    """The JAX layer's routing, line for line: (probs, ids, pos, keep)."""
    m = cfg.moe
    T = xt.shape[0]
    E, K = m.num_experts, m.top_k
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _gate, ids = jax.lax.top_k(probs, K)
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    pos_sorted = jnp.arange(T * K) - seg_start[sorted_e]
    pos = jnp.zeros(T * K, jnp.int32).at[order].set(pos_sorted.astype(jnp.int32))
    return probs, ids, pos, pos < jmoe.moe_capacity(cfg, T)


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    """(numpy params, numpy x, out, aux, ids, pos, keep) of the JAX layer."""
    cfg, _ = _cfgs(case, dtype)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p = _moe_init(cfg, jax.random.PRNGKey(3), dt)
    x = np.random.default_rng(9).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x, dt)
    out, aux = jax.jit(lambda pp, xx: jmoe.moe_layer(cfg, pp, xx))(p, jx)
    _probs, ids, pos, keep = _jax_routing(cfg, p["router"], jx.reshape(B * S, -1))
    as_np = lambda a: np.asarray(a, np.float32)      # noqa: E731
    return ({n: as_np(a) for n, a in p.items()}, x, as_np(out), float(aux), np.asarray(ids),
            np.asarray(pos), np.asarray(keep))


def _port(case, dtype):
    _, cfg = _cfgs(case, dtype)
    jp, x, *_ = _reference(case, dtype)
    dt = getattr(torch, dtype)
    p = {n: torch.tensor(a).to(torch.float32 if n == "router" else dt) for n, a in jp.items()}
    return cfg, p, torch.from_numpy(x).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_layer_matches_reference(case, dtype):
    cfg, p, x = _port(case, dtype)
    _jp, _x, want, want_aux, ids, pos, keep = _reference(case, dtype)
    out, aux = moe.moe_layer(cfg, p, x)
    assert out.dtype == x.dtype and out.shape == x.shape and aux.dtype == torch.float32
    assert abs(float(aux) - want_aux) <= 1e-6
    _probs, _gate, tids, tpos, tkeep = moe.route(cfg, p["router"], x.reshape(B * S, -1))
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert tpos.dtype == torch.int32
    got = out.float().numpy()
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        err = float(np.abs(got - want).max())
        assert err <= 2e-2 * scale, (err, scale)


def test_capacity_drops_where_the_reference_drops():
    """The 0.5 capacity factor drops routed pairs (so the drop path is
    exercised), the reduced configs' E / k drops none, and `moe_capacity`
    equals the reference's at any token count."""
    *_, keep = _reference("mixtral-drops", "float32")
    assert 0 < (~keep).sum() < keep.size
    for case in ("mixtral", "deepseek-16x8"):
        assert _reference(case, "float32")[-1].all()
    for case in CASES:
        jcfg, tcfg = _cfgs(case, "float32")
        for t in (1, 2, 7, 48, 160, 4096, 16384):
            assert moe.moe_capacity(tcfg, t) == jmoe.moe_capacity(jcfg, t)


def test_dropped_pairs_leave_the_last_slot_to_its_token():
    """A dropped pair adds nothing at (E - 1, C - 1): with one expert and a
    capacity of 8, tokens 8.. are dropped, tokens 0..7 fill the buffer,
    and the output of token 7 (the last slot's) is its own expert output,
    not the dropped rows' zero."""
    _, cfg = _cfgs("mixtral", "float32")
    cfg = replace(cfg, moe=replace(cfg.moe, num_experts=1, top_k=1, capacity_factor=0.01))
    rng = np.random.default_rng(4)
    D, F = cfg.d_model, cfg.moe.d_ff_expert
    p = {"router": torch.from_numpy(rng.standard_normal((D, 1), dtype=np.float32)),
         "experts_gate": torch.from_numpy(rng.standard_normal((1, D, F), dtype=np.float32)),
         "experts_up": torch.from_numpy(rng.standard_normal((1, D, F), dtype=np.float32)),
         "experts_down": torch.from_numpy(rng.standard_normal((1, F, D), dtype=np.float32))}
    x = torch.from_numpy(rng.standard_normal((1, 20, D), dtype=np.float32)) / 8
    out, _ = moe.moe_layer(cfg, p, x)
    xt = x[0]
    h = torch.nn.functional.silu(xt @ p["experts_gate"][0]) * (xt @ p["experts_up"][0])
    want = h @ p["experts_down"][0]
    torch.testing.assert_close(out[0, :8], want[:8], rtol=1e-5, atol=1e-5)
    assert not out[0, 8:].any()
