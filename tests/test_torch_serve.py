"""The port's serving steps (`repro_torch.launch.serve`) against the JAX
package's `repro.launch.serve`, on the CPU.

Reduced qwen3, olmo, mixtral and deepseek-v3 in fp32 on the JAX package's
weights (`convert.lm_params_from_reference`): a prefill of a 21-token
prompt (batch 2; the moe family 80 tokens into a cache of 96, past reduced
mixtral's window of 64, so its ring of 64 slots is filled by the prefill
and wrapped by the decode steps) and 8 greedy decode steps on each side,
each side feeding back its own argmax.  The token ids must be equal and every step's logits within 2e-4
(rtol and atol), the JAX package's own prefill/decode tolerance.  The JAX
run is computed once per architecture.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import serve as jserve
from repro.models import init_cache as j_init_cache, init_params as j_init_params
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import init_cache, init_params

B, PROMPT, STEPS, CACHE = 2, 21, 8, 32
TOL = 2e-4
LONG = {"mixtral-8x7b": (80, 96), "deepseek-v3-671b": (80, 96)}


def _lengths(arch):
    """(prompt, cache) of an architecture's run."""
    return LONG.get(arch, (PROMPT, CACHE))


def _cfgs(arch):
    return (replace(jconfigs.reduced(jconfigs.get_config(arch)), dtype="float32"),
            replace(tconfigs.reduced(tconfigs.get_config(arch)), dtype="float32"))


def _prompt(vocab, n=PROMPT):
    return np.random.default_rng(11).integers(0, vocab, (B, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(numpy params, [logits of the prefill and each decode step], token ids)."""
    cfg, _ = _cfgs(arch)
    n, cache_len = _lengths(arch)
    params = j_init_params(cfg, jax.random.PRNGKey(5))
    prefill = jax.jit(jserve.make_prefill_step(cfg))
    step = jax.jit(jserve.make_decode_step(cfg))
    logits, cache = prefill(params, {"tokens": jnp.asarray(_prompt(cfg.vocab_size, n))},
                            j_init_cache(cfg, B, cache_len))
    out, ids = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        ids.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, jnp.int32(n + i))
        out.append(np.asarray(logits))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params), out, ids


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmo-1b", "mixtral-8x7b", "deepseek-v3-671b"])
def test_serving_steps_match_reference_over_greedy_tokens(arch):
    jparams, want, want_ids = _reference(arch)
    _, cfg = _cfgs(arch)
    n, cache_len = _lengths(arch)
    params = convert.lm_params_from_reference(cfg, jparams, device="cpu")
    prefill, step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    cache = init_cache(cfg, B, cache_len, device="cpu")
    logits, cache2 = prefill(params, {"tokens": torch.from_numpy(_prompt(cfg.vocab_size, n))
                                      .long()}, cache)
    assert cache2 is cache and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want[0], rtol=TOL, atol=TOL)
    for i in range(STEPS):
        tok = logits.argmax(-1, keepdim=True)
        np.testing.assert_array_equal(tok.numpy(), want_ids[i])
        logits, cache = step(params, cache, tok, n + i)
        np.testing.assert_allclose(logits.numpy(), want[i + 1], rtol=TOL, atol=TOL)
    if "pos" in cache["layers"]:        # the ring holds the last 64 positions, p at p mod 64
        last = n + STEPS - 1
        C = cache["layers"]["pos"].shape[-1]
        assert C == cfg.window < cache_len
        slot = torch.arange(last - C + 1, last + 1) % C
        assert (cache["layers"]["pos"][..., slot] == torch.arange(last - C + 1, last + 1)).all()


def test_abstract_cache_matches_reference_shapes():
    jcfg, cfg = _cfgs("qwen3-1.7b")
    want = jserve.abstract_cache(jcfg, 3, 40)["layers"]
    got = serve.abstract_cache(cfg, 3, 40)["layers"]
    for name in ("k", "v"):
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == tuple(want[name].shape)
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_abstract_cache_of_the_moe_family_matches_reference_shapes(arch):
    """mixtral's ring (k, v of window slots and pos, int32) and
    deepseek-v3's latent cache, at a cache longer than the window."""
    jcfg, cfg = _cfgs(arch)
    want = jserve.abstract_cache(jcfg, 3, 80)["layers"]
    got = serve.abstract_cache(cfg, 3, 80)["layers"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == tuple(want[name].shape)
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)


def test_entry_points_default_to_the_card():
    """Without `device=`, the parameters and the cache go to the card, and
    raise where there is none; with device="cpu" the steps run there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, cfg = _cfgs("phi3-mini-3.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    params = init_params(cfg, seed=1, device="cpu")
    cache = init_cache(cfg, 1, 8, device="cpu")
    logits, cache = serve.make_prefill_step(cfg)(params, {"tokens": torch.tensor([[1, 2, 3]])},
                                                 cache)
    logits, _ = serve.make_decode_step(cfg)(params, cache, logits.argmax(-1, keepdim=True), 3)
    assert logits.device.type == "cpu" and torch.isfinite(logits).all()
