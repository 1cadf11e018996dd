"""The sliding-window ring cache of the port's `gqa_attention` against the
JAX package's, on the CPU.

Reduced mixtral in fp32 with a window of 16 and a cache of 24 slots asked
for, so the ring has C = 16 slots and a `pos` row of each slot's position
(-1 where unwritten).  Both packages take the same weights and inputs
(numpy, seeded) through a sequence of writes: each call's output within
2e-4 (rtol and atol, the JAX package's own prefill/decode tolerance); after
each call the ring's `pos` equal to the reference's, and its k and v
within 2e-5 (one projection and RoPE each, summed in another order).
Cases: a long prefill (S >= C: attention over the fresh k and v with the
window, the last C written rolled) of 20 and one of exactly 16; a short
prefill of 5; each then decoded past the ring's wrap; and a short write of
4 at position 14, whose start the JAX package clamps to slot 12 (its
`dynamic_update_slice` does not wrap).  The port writes the ring in place.
"""

import math
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as jly
from repro.models import init_cache as j_init_cache
import repro_torch.configs as tconfigs
import repro_torch.models.layers as ly
from repro_torch.models import init_cache

B, WINDOW, CACHE = 2, 16, 24
# (start, length) of each write in turn
CASES = {
    "long-prefill": [(0, 20)] + [(p, 1) for p in range(20, 26)],
    "prefill-equal-to-the-ring": [(0, 16)] + [(p, 1) for p in range(16, 19)],
    "short-prefill": [(0, 5)] + [(p, 1) for p in range(5, 19)],
    "clamped-write": [(0, 5), (14, 4), (18, 1)],
}


def _cfgs():
    j = jconfigs.reduced(jconfigs.get_config("mixtral-8x7b"))
    t = tconfigs.reduced(tconfigs.get_config("mixtral-8x7b"))
    return (replace(j, dtype="float32", window=WINDOW),
            replace(t, dtype="float32", window=WINDOW))


def _params(cfg, rng):
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    return {n: rng.standard_normal(s, dtype=np.float32) / math.sqrt(s[0])
            for n, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)), ("wv", (D, KV * hd)),
                         ("wo", (H * hd, D)))}


def test_init_cache_makes_the_reference_ring():
    """C = min(cache_len, window), `pos` only where the cache is longer than
    the window, -1 in every slot, int32; stacked per layer."""
    jcfg, tcfg = _cfgs()
    for n in (CACHE, WINDOW, 9):
        want = j_init_cache(jcfg, B, n)["layers"]
        got = init_cache(tcfg, B, n, device="cpu")["layers"]
        assert sorted(got) == sorted(want)
        for name in want:
            assert tuple(got[name].shape) == tuple(want[name].shape)
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        if "pos" in got:
            assert got["pos"].dtype == torch.int32


@pytest.mark.parametrize("case", list(CASES))
def test_ring_writes_and_attention_match_reference(case):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(21)
    p = _params(tcfg, rng)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jcache = {k: v[0] for k, v in j_init_cache(jcfg, B, CACHE)["layers"].items()}
    tcache = {k: v[0] for k, v in init_cache(tcfg, B, CACHE, device="cpu")["layers"].items()}
    assert "pos" in tcache and tcache["k"].shape[1] == WINDOW
    for start, n in CASES[case]:
        x = rng.standard_normal((B, n, tcfg.d_model), dtype=np.float32)
        pos = np.broadcast_to(np.arange(start, start + n, dtype=np.int32), (B, n)).copy()
        jout, jcache = jly.gqa_attention(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
                                         cache=jcache, cache_pos=start, window=jcfg.window)
        tout, tc = ly.gqa_attention(tcfg, tp, torch.from_numpy(x),
                                    positions=torch.from_numpy(pos), cache=tcache,
                                    cache_pos=start, window=tcfg.window)
        assert tc is tcache
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       rtol=2e-5, atol=2e-5)
    last = CASES[case][-1][0] + CASES[case][-1][1] - 1
    if case != "clamped-write":      # every slot holds its position mod C
        want = np.arange(last - WINDOW + 1, last + 1)
        np.testing.assert_array_equal(np.sort(tcache["pos"].numpy(), axis=1),
                                      np.broadcast_to(want, (B, WINDOW)))
        assert (tcache["pos"].numpy() % WINDOW == np.arange(WINDOW)).all()


def test_long_write_past_position_zero_raises():
    """A write of S >= C tokens into the ring past position 0 raises (the
    JAX package's answer there depends on its attention dispatch, and its
    serving path never makes one)."""
    _, tcfg = _cfgs()
    tp = {n: torch.from_numpy(a) for n, a in _params(tcfg, np.random.default_rng(2)).items()}
    cache = {k: v[0] for k, v in init_cache(tcfg, 1, CACHE, device="cpu")["layers"].items()}
    pos = torch.arange(3, 3 + WINDOW, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="past position 0"):
        ly.gqa_attention(tcfg, tp, torch.zeros(1, WINDOW, tcfg.d_model), positions=pos,
                         cache=cache, cache_pos=3, window=WINDOW)
