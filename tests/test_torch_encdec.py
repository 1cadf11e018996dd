"""The port's encoder-decoder family (whisper-medium reduced: 2 encoder and 2
decoder layers, 32 frames) against the JAX package's, on the CPU.

Cross attention: `gqa_attention` with `kv_override` (q projected, no RoPE,
no k-norm on the given k; plain attention for Sq != Sk) against the
reference on seeded numpy inputs, with and without qk-norm, in fp32 within
2e-5 (rtol and atol) and in bf16 within 2e-2 of the reference's max
|value|.  The model (`tests/_torch_family.py`): the encoder runs
non-causal (the attention kernel's path, `causal=False`), the decoder's
prompt of 21 writes its self-attention cache and the cross attention's k
and v (`cross_k`, `cross_v`, compared after the prefill against the
reference's returned cache), and 3 decode steps read them; in fp32 and
bf16, and in fp32 with a decoder prompt as long as the encoder's 32 frames
(cross attention with Sq == Sk goes to the kernel's path in the port, to
plain attention in the reference: the same function).  The parameters'
round trip through `convert`; `loss_fn` and a train step on the reduced
config.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as jly
import repro_torch.configs as tconfigs
import repro_torch.models.layers as ly
from repro_torch.kernels import ref as kref

from _torch_family import Case, check_model, check_round_trip, check_training_runs

ARCH = "whisper-medium"
FN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FN_TOL[dtype], atol=FN_TOL[dtype])
    else:
        assert np.abs(got - want).max() <= FN_TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_through_kv_override_matches_reference(dtype, qk_norm):
    cfg = replace(tconfigs.reduced(tconfigs.get_config(ARCH)), dtype=dtype, qk_norm=qk_norm)
    jcfg = replace(jconfigs.reduced(jconfigs.get_config(ARCH)), dtype=dtype, qk_norm=qk_norm)
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    rng = np.random.default_rng(5)
    p = {n: rng.standard_normal(s, dtype=np.float32) / np.sqrt(s[0])
         for n, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)), ("wv", (D, KV * hd)),
                      ("wo", (H * hd, D)))}
    if qk_norm:
        p["q_norm"] = 0.1 * rng.standard_normal(hd, dtype=np.float32)
        p["k_norm"] = 0.1 * rng.standard_normal(hd, dtype=np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    norms = ("q_norm", "k_norm")
    jp = {n: jnp.asarray(a, jnp.float32 if n in norms else jd) for n, a in p.items()}
    tp = {n: torch.from_numpy(a).to(torch.float32 if n in norms else td) for n, a in p.items()}
    x = rng.standard_normal((2, 7, D), dtype=np.float32)
    k = rng.standard_normal((2, 32, KV, hd), dtype=np.float32)
    v = rng.standard_normal((2, 32, KV, hd), dtype=np.float32)
    want, _ = jly.gqa_attention(jcfg, jp, jnp.asarray(x, jd), positions=None, causal=False,
                                kv_override=(jnp.asarray(k, jd), jnp.asarray(v, jd)))
    kref.reset_call_counts()
    got, none = ly.gqa_attention(cfg, tp, torch.from_numpy(x).to(td), positions=None,
                                 causal=False, kv_override=(torch.from_numpy(k).to(td),
                                                            torch.from_numpy(v).to(td)))
    assert none is None and got.dtype == td
    assert kref.call_counts["flash_attention"] == 0          # Sq != Sk: plain
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_prefill_and_decode_match_reference(dtype):
    kref.reset_call_counts()
    cfg, _params, _cache = check_model(Case(ARCH, dtype, n_fwd=24, n_pre=21, n_dec=3,
                                            cache_len=32))
    # the encoder's self-attention and the decoder's prompt through the
    # kernel's path: the forward and the prefill each, a layer each
    assert kref.call_counts["flash_attention"] == 2 * (cfg.encoder_layers + cfg.num_layers)


def test_decoder_prompt_as_long_as_the_frames_matches_reference():
    check_model(Case(ARCH, "float32", n_fwd=32, n_pre=29, n_dec=3, cache_len=40))


def test_convert_round_trips_the_reference_tree():
    check_round_trip(ARCH)


def test_training_runs_on_the_cpu():
    check_training_runs(ARCH)
