"""The port's Multi-head Latent Attention (`layers.mla_attention`) against
the JAX package's, on the CPU.

Reduced deepseek-v3 in fp32 (q_lora 64, kv_lora 32, nope 32, rope 16, v
32, 4 heads): the JAX package's `_mla_init` weights, with random norm
scales, carried over as numpy, and seeded numpy inputs.  The expanded form
(no cache: per-head k and v from the latent; q and k 48 wide, v 32, so
outside the attention kernel's domain) and the absorbed form against the
latent cache (a prefill of 20 into 32 slots, then 3 decode steps), each
output within 2e-4 (rtol and atol, the JAX package's own prefill/decode
tolerance) and the cache after each call within 2e-5.  Also the shape rule
that keeps both forms on `_plain_attention`.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as jly
from repro.models.lm import _mla_init
import repro_torch.configs as tconfigs
import repro_torch.models.layers as ly
from repro_torch.kernels import ops as kops, ref as kref

B, PREFILL, DECODE, CACHE = 2, 20, 3, 32
TOL = 2e-4


def _cfgs():
    return (replace(jconfigs.reduced(jconfigs.get_config("deepseek-v3-671b")), dtype="float32"),
            replace(tconfigs.reduced(tconfigs.get_config("deepseek-v3-671b")), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _weights():
    cfg, _ = _cfgs()
    p = {n: np.asarray(a, np.float32) for n, a in
         _mla_init(cfg, jax.random.PRNGKey(11), jnp.float32).items()}
    rng = np.random.default_rng(12)
    for n in ("q_down_norm", "kv_down_norm"):
        p[n] = 0.1 * rng.standard_normal(p[n].shape, dtype=np.float32)
    return p


def _inputs(n, start, seed):
    x = np.random.default_rng(seed).standard_normal((B, n, 128), dtype=np.float32)
    pos = np.broadcast_to(np.arange(start, start + n, dtype=np.int32), (B, n)).copy()
    return x, pos


def _both(p):
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a.copy()) for n, a in p.items()})


def test_expanded_form_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _both(_weights())
    x, pos = _inputs(PREFILL, 0, 1)
    want, none = jly.mla_attention(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos))
    assert none is None
    kops.reset_launch_counts()
    kref.reset_call_counts()
    got, tnone = ly.mla_attention(tcfg, tp, torch.from_numpy(x), positions=torch.from_numpy(pos))
    assert tnone is None
    assert kref.call_counts["flash_attention"] == 0      # the shape rule: plain attention
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_absorbed_form_prefill_then_decode_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _both(_weights())
    m = tcfg.mla
    shape = (B, CACHE, m.kv_lora_rank + m.qk_rope_head_dim)
    jcache, tcache = {"lat": jnp.zeros(shape)}, {"lat": torch.zeros(shape)}
    for i, (start, n) in enumerate([(0, PREFILL)] + [(p, 1) for p in
                                                     range(PREFILL, PREFILL + DECODE)]):
        x, pos = _inputs(n, start, 2 + i)
        want, jcache = jly.mla_attention(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
                                         cache=jcache, cache_pos=start)
        got, tc = ly.mla_attention(tcfg, tp, torch.from_numpy(x),
                                   positions=torch.from_numpy(pos), cache=tcache,
                                   cache_pos=start)
        assert tc is tcache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tcache["lat"].numpy(), np.asarray(jcache["lat"]),
                                   rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="outside a cache"):
        x, pos = _inputs(2, CACHE - 1, 9)
        ly.mla_attention(tcfg, tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
                         cache=tcache, cache_pos=CACHE - 1)


@pytest.mark.parametrize("dims,route", [((32, 32, 32), "kernel"), ((48, 48, 32), "plain"),
                                        ((48, 48, 48), "raises"), ((64, 64, 64), "kernel")])
def test_attention_core_shape_rule(dims, route):
    """Causal self-attention from position 0 at the default scale goes to
    the kernel's path with one head dim for q, k and v, and raises there
    when that dim lies outside FLASH_HEAD_DIMS; MLA's expanded shapes (k
    wider than v) go to the plain path."""
    dq, dk, dv = dims
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 9, 2, d, generator=gen) for d in (dq, dk, dv))
    kref.reset_call_counts()
    if route == "raises":
        with pytest.raises(ValueError, match="head dim 48 not in"):
            ly.attention_core(q, k, v, causal=True)
        return
    out = ly.attention_core(q, k, v, causal=True)
    assert kref.call_counts["flash_attention"] == int(route == "kernel")
    assert out.shape == (1, 9, 2, dv)
    want = ly._plain_attention(q, k, v, causal=True, window=None, q_offset=0,
                               scale=1.0 / dq ** 0.5)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
