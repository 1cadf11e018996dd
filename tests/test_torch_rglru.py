"""The port's RG-LRU block and the hybrid family (`repro_torch.models.rglru`,
recurrentgemma-9b reduced) against the JAX package's, on the CPU.

Functions on seeded numpy inputs: `lru_scan` (the Hillis-Steele doubling)
against `jax.lax.associative_scan` at S = 1, 37, 64 and 100 (not all powers
of two), in fp32 within 1e-5 (the products associate in another order);
`rglru_layer` with and without its cache, in fp32 within 2e-5 and in bf16
within 2e-2 of the reference's max |value|, the cache's conv and h
compared after the call.  The model (`tests/_torch_family.py`): the
reduced config's window is 64, so a prompt of 77 into a cache of 96 is a
long prefill into a ring of 64 slots, and the 3 decode steps wrap it; the
super-blocks' caches (rec conv and h, the ring's k, v and pos) compared
after the prefill, in fp32; and a depth of 8 layers, two super-blocks and
a tail of two rec blocks, as recurrentgemma-9b's 38 = 12 x 3 + 2 has.  The
parameters' round trip through `convert`, with and without a tail;
`loss_fn` and a train step on the reduced config.

No whole-model bf16 case: over the reduced config's 6 layers the two
packages' bf16 hidden states differ by 2.8-3.4 % of their max |value| (80
and 40 tokens), as far as each lies from the fp32 forward on the same
weights (the port 2.9-3.3 %, the reference 2.5-3.1 %): rounding spread by
depth, not a difference of function, and over the 2e-2 bound.  bf16 is held
where it is one layer deep, `rglru_layer` above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace

import repro.configs as jconfigs
from repro.models import rglru as jrglru
import repro_torch.configs as tconfigs
from repro_torch.models import rglru

from _torch_family import Case, check_model, check_round_trip, check_training_runs

ARCH = "recurrentgemma-9b"
FN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FN_TOL[dtype], atol=FN_TOL[dtype])
    else:
        assert np.abs(got - want).max() <= FN_TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("S", [1, 37, 64, 100])
def test_lru_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 24)).astype(np.float32)
    bx = rng.standard_normal((2, S, 24), dtype=np.float32)
    want = jrglru._lru_scan(jnp.asarray(a), jnp.asarray(bx))
    got = rglru.lru_scan(torch.from_numpy(a), torch.from_numpy(bx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _params(cfg, rng):
    D, W, K = cfg.d_model, cfg.rglru.lru_width, cfg.rglru.conv_width
    p = {n: rng.standard_normal(s, dtype=np.float32) / np.sqrt(s[0])
         for n, s in (("in_proj", (D, W)), ("gate_proj", (D, W)), ("w_r", (W, W)),
                      ("w_i", (W, W)), ("out_proj", (W, D)))}
    p["conv_w"] = 0.5 * rng.standard_normal((K, W), dtype=np.float32)
    p["lam"] = rng.uniform(0.2, 0.8, W).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_cache", [False, True])
def test_rglru_layer_matches_reference(dtype, with_cache):
    """The fp32 parameters (conv_w, lam) stay fp32, the matrices take the
    dtype; with a cache, a 9-token continuation from a nonzero conv state
    and h, then one decode step."""
    cfg = replace(tconfigs.reduced(tconfigs.get_config(ARCH)), dtype=dtype)
    jcfg = replace(jconfigs.reduced(jconfigs.get_config(ARCH)), dtype=dtype)
    rng = np.random.default_rng(3)
    p = _params(cfg, rng)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fp32 = ("conv_w", "lam")
    jp = {n: jnp.asarray(a, jnp.float32 if n in fp32 else jd) for n, a in p.items()}
    tp = {n: torch.from_numpy(a).to(torch.float32 if n in fp32 else td) for n, a in p.items()}
    W = cfg.rglru.lru_width
    jcache = tcache = None
    if with_cache:
        conv = rng.standard_normal((2, cfg.rglru.conv_width - 1, W), dtype=np.float32)
        h = rng.standard_normal((2, W), dtype=np.float32)
        jcache = {"conv": jnp.asarray(conv, jd), "h": jnp.asarray(h)}
        tcache = {"conv": torch.from_numpy(conv).to(td), "h": torch.from_numpy(h)}
    for S in ((9, 1) if with_cache else (21,)):
        x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
        want, jcache = jrglru.rglru_layer(jcfg, jp, jnp.asarray(x, jd), cache=jcache)
        got, same = rglru.rglru_layer(cfg, tp, torch.from_numpy(x).to(td), cache=tcache)
        assert same is tcache and got.dtype == td
        _close(got, want, dtype)
        if with_cache:
            np.testing.assert_array_equal(tcache["conv"].float().numpy(),
                                          np.asarray(jcache["conv"], np.float32))
            assert tcache["h"].dtype == torch.float32
            _close(tcache["h"], jcache["h"], dtype)


def test_model_forward_prefill_and_decode_match_reference():
    _cfg, _params_, cache = check_model(Case(ARCH, "float32", n_fwd=80, n_pre=77, n_dec=3,
                                             cache_len=96))
    # the ring of 64 slots holds positions 16..79 at slot p mod 64
    pos = cache["super"]["attn2"]["pos"]
    assert pos.shape[-1] == 64
    want = torch.arange(16, 80, dtype=torch.int32)
    assert torch.equal(pos[..., want % 64], want.expand_as(pos))


def test_model_with_a_tail_matches_reference():
    check_model(Case(ARCH, "float32", n_fwd=40, n_pre=37, n_dec=3, cache_len=48, num_layers=8))


@pytest.mark.parametrize("num_layers", [None, 8])
def test_convert_round_trips_the_reference_tree(num_layers):
    check_round_trip(ARCH, num_layers)


def test_training_runs_on_the_cpu():
    check_training_runs(ARCH)
