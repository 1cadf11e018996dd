"""The port's optimizers (`repro_torch.optim`) against the JAX package's, on
the CPU.

AdamW and Adafactor over the same trees (2-D, 3-D and 1-D leaves, and a
None entry), fp32 and bf16 state, three steps with the state carried: the
updates and every moment within 1e-6 (relative L2; fp32 arithmetic in
another order), bf16 moments within one bf16 rounding.  The schedule, the
global norm and the clip within 1e-6, `apply_updates` in the parameters'
dtypes, int8 compression exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro.optim.optimizers import clip_by_global_norm as j_clip, global_norm as j_norm
import repro_torch.optim as topt

TOL = 1e-6
BF16_TOL = 2 ** -8      # one rounding of a bf16 moment


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "s": {"b": rng.standard_normal(7).astype(np.float32),
                  "stack": rng.standard_normal((3, 4, 5)).astype(np.float32), "none": None}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.array(tree, np.float32))


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [tree]


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_run(optimizer: str, dtype: str, steps: int = 3):
    """Three steps of the JAX optimizer from zero state: each step's
    updates, and the final state."""
    params = _jax(_tree(0))
    state = jopt.init_opt_state(params, optimizer, dtype)
    update = jopt.adamw_update if optimizer == "adamw" else jopt.adafactor_update
    ups = []
    for i in range(steps):
        grads = _jax(_tree(10 + i))
        u, state = update(grads, state, params, 1e-3 * (i + 1))
        ups.append(jax.tree.map(np.asarray, u))
    to_np = lambda x: np.asarray(jnp.asarray(x, jnp.float32))   # noqa: E731
    return ups, int(state.step), jax.tree.map(to_np, state.mu), jax.tree.map(to_np, state.nu)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_reference_over_three_steps(optimizer, dtype):
    want_ups, want_step, want_mu, want_nu = _jax_run(optimizer, dtype)
    params = _torch(_tree(0))
    state = topt.init_opt_state(params, optimizer, dtype)
    update = topt.adamw_update if optimizer == "adamw" else topt.adafactor_update
    for i in range(3):
        u, state = update(_torch(_tree(10 + i)), state, params, 1e-3 * (i + 1))
        assert u["s"]["none"] is None
        for got, want in zip(_flat(u), _flat(want_ups[i])):
            assert got.dtype == torch.float32 and _rel(got, want) <= TOL, (i, _rel(got, want))
    assert int(state.step) == want_step == 3 and state.step.dtype == torch.int32
    tol = TOL if dtype == "float32" else BF16_TOL
    want_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    for got, want in zip(_flat(state.mu) + _flat(state.nu), _flat(want_mu) + _flat(want_nu)):
        assert got.dtype == want_dt and tuple(got.shape) == want.shape
        assert _rel(got, want) <= tol


def test_adafactor_factors_two_or_more_dims_only():
    state = topt.init_opt_state(_torch(_tree(0)), "adafactor")
    assert [tuple(x.shape) for x in state.nu["w"]] == [(6,), (5,)]
    assert [tuple(x.shape) for x in state.nu["s"]["stack"]] == [(3, 4), (3, 5)]
    assert [tuple(x.shape) for x in state.nu["s"]["b"]] == [(7,), ()]
    assert all(m.shape == () for m in _flat(state.mu))
    with pytest.raises(ValueError):
        topt.init_opt_state(_torch(_tree(0)), "sgd")


@pytest.mark.parametrize("step", [0, 1, 7, 10, 11, 55, 99, 100, 130])
def test_cosine_schedule_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    got = topt.cosine_schedule(step, **kw)
    want = float(jopt.cosine_schedule(jnp.int32(step), **kw))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= TOL * max(abs(want), 1e-12)
    assert float(topt.cosine_schedule(torch.tensor(step), **kw)) == float(got)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = _tree(5)
    tree["h"] = tree["w"] * 3          # a bf16 leaf: scaled in fp32, cast back
    jt = {**_jax(tree), "h": jnp.asarray(tree["h"], jnp.bfloat16)}
    tt = {**_torch(tree), "h": torch.from_numpy(tree["h"]).bfloat16()}
    assert _rel(topt.global_norm(tt), j_norm(jt)) <= TOL
    got, n = topt.clip_by_global_norm(tt, max_norm)
    want, jn = j_clip(jt, max_norm)
    assert _rel(n, jn) <= TOL
    assert got["h"].dtype == torch.bfloat16 and got["s"]["none"] is None
    for a, b in zip(_flat(got), _flat(jax.tree.map(lambda x: np.asarray(x, np.float32), want))):
        assert _rel(a, b) <= (TOL if a.dtype == torch.float32 else BF16_TOL)


def test_apply_updates_in_place_in_the_parameters_dtype():
    tree = _tree(1)
    ups = _tree(2)
    want = jax.tree.map(np.asarray, jopt.apply_updates(
        {**_jax(tree), "w": jnp.asarray(tree["w"], jnp.bfloat16)}, _jax(ups)))
    params = {**_torch(tree), "w": torch.from_numpy(tree["w"]).bfloat16()}
    ptr = params["w"].data_ptr()
    out = topt.apply_updates(params, _torch(ups))
    assert out is params and params["w"].data_ptr() == ptr and params["w"].dtype == torch.bfloat16
    for a, b in zip(_flat(params), _flat(want)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 5)])
def test_int8_compression_matches_reference(shape):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    q, scale, pad = topt.compress_int8(torch.from_numpy(x))
    jq, jscale, jpad = jopt.compress_int8(jnp.asarray(x))
    assert pad == jpad and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = topt.decompress_int8(q, scale, pad, shape)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jopt.decompress_int8(jq, jscale, jpad, shape)))
    # the quantized mean over a group of one rank: the JAX package's over an
    # axis of one, exactly (residual fed back once)
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        res = None
        jres = jnp.zeros_like(jnp.asarray(x))
        for _ in range(2):
            out, res = topt.compressed_psum(torch.from_numpy(x), dist.group.WORLD, residual=res)
            jout, jres = jax.vmap(lambda a, r: jopt.compressed_psum(a, "i", residual=r),
                                  axis_name="i")(jnp.asarray(x)[None], jres[None])
            jout, jres = jout[0], jres[0]
            np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
            np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    finally:
        dist.destroy_process_group()
