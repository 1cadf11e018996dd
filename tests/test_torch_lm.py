"""The port's dense LM (`repro_torch.models`) against the JAX package's, on
the CPU.

Configs: every architecture's `ModelConfig`, `param_count` and `reduced`
equal the JAX package's.  Layers: each dense-path function against JAX's on
the same numpy inputs.  Model: reduced qwen3, olmo, phi3, mixtral and
deepseek-v3 in fp32, with the JAX package's parameters carried over by
`convert.lm_params_from_reference` — forward hidden states, prefill logits
and caches, and 3 decode steps — within 2e-4 (rtol and atol), the JAX
package's own prefill/decode tolerance (the same fp32 function, the sums of
the matmuls in another order); the moe family with a prompt of 77 into a
cache of 96, longer than reduced mixtral's window of 64, so its ring (64
slots) is written by a long prefill and wrapped by the decode steps, and
its aux loss within 1e-5; one bf16 case (qwen3) with max |difference|
within 2e-2 of the reference's max |value| (a scale-relative bound): both
packages round every matmul output to bf16 at the same places but sum in
another order, so single values differ by bf16 ulps (2^-8 relative) that
the next layer's matmuls spread to every value, small ones included, where
an elementwise relative bound has nothing to give.  No bf16 moe case: a
router near a tie flips a token's expert on such ulps (reduced mixtral in
bf16: one token of 160 routed elsewhere, its hidden state off by 0.85 of
4), so the MoE layer's bf16 parity is held on equal inputs
(`tests/test_torch_moe.py`).  The port's own prefill
-> decode against its forward within 1e-5.  The JAX side of each model case
is computed once.
"""

import dataclasses
import functools
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as jly
from repro.models import decode_step as j_decode, forward as j_forward
from repro.models import init_cache as j_init_cache, init_params as j_init_params
from repro.models.lm import unembed as j_unembed
import repro_torch.configs as tconfigs
import repro_torch.models.layers as ly
from repro_torch import convert
from repro_torch.models import config as tconfig, decode_step, forward, init_cache, init_params
from repro_torch.models.lm import set_activation_spec, unembed

DENSE = ["qwen3-1.7b", "olmo-1b", "phi3-mini-3.8b"]
MOE = ["mixtral-8x7b", "deepseek-v3-671b"]
# the ssm, hybrid, encdec and vlm families (served since PR 30's slice,
# trained since PR 32's)
OTHER_FAMILIES = ["whisper-medium", "recurrentgemma-9b", "mamba2-130m", "pixtral-12b"]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
B, S, N_DEC, CACHE = 2, 24, 3, 32
# (sequence, cache) of the moe family: past reduced mixtral's window of 64
LONG = (80, 96)


def _lengths(arch):
    return LONG if arch in MOE else (S, CACHE)


def _np(x):
    return np.asarray(x, np.float32)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol)


def _close_model(got: torch.Tensor, want, dtype: str):
    """fp32: elementwise within 2e-4; bf16: max |difference| within 2e-2 of
    the reference's max |value| (see the module docstring)."""
    if dtype == "float32":
        _close(got, want, TOL[dtype])
        return
    want = _np(want)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= TOL[dtype] * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_config_param_count_and_reduced_match_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert dataclasses.asdict(tconfigs.reduced(t)) == dataclasses.asdict(jconfigs.reduced(j))
    assert tconfigs.reduced(t).param_count() == jconfigs.reduced(j).param_count()
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.get_shape(name)) == dataclasses.asdict(shape)
        assert tconfigs.cell_supported(t, tconfigs.get_shape(name)) == \
            jconfigs.cell_supported(j, shape)


def test_registry_matches_reference():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert tconfigs.get_config("qwen3-1.7b").param_count() == 1_720_451_072


# ------------------------------------------------------------------- layers
def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_dense_swiglu_match_reference(dtype):
    rng = _rng(1)
    tol = TOL[dtype]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.standard_normal((2, 5, 4, 32), dtype=np.float32)
    scale = 0.1 * rng.standard_normal(32, dtype=np.float32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    _close(ly.rms_norm(tx), jly.rms_norm(jx), tol)
    _close(ly.rms_norm(tx, torch.from_numpy(scale)), jly.rms_norm(jx, jnp.asarray(scale)), tol)
    _close(ly.layer_norm_np(tx), jly.layer_norm_np(jx), tol)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5) * 7
    jc, js = jly.rope_angles(jnp.asarray(pos), 32, 1e6)
    tc, ts = ly.rope_angles(torch.from_numpy(pos), 32, 1e6)
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    out = ly.apply_rope(tx, tc, ts)
    assert out.dtype == td
    _close(out, jly.apply_rope(jx, jc, js), tol)
    w = {n: rng.standard_normal(s, dtype=np.float32) / 6
         for n, s in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    jw = {n: jnp.asarray(a, jd) for n, a in w.items()}
    tw = {n: torch.from_numpy(a).to(td) for n, a in w.items()}
    _close(ly.dense(tx, tw["w_gate"]), jly.dense(jx, jw["w_gate"]), tol)
    _close(ly.swiglu(tw, tx), jly.swiglu(jw, jx), tol)


def test_plain_attention_with_offset_matches_reference():
    """Decode (Sq = 1) and a prefill past position 0 over a cache of 40."""
    rng = _rng(2)
    k = rng.standard_normal((2, 40, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 40, 2, 32), dtype=np.float32)
    for sq, off, window in ((1, 17, None), (6, 9, None), (1, 30, 8)):
        q = rng.standard_normal((2, sq, 4, 32), dtype=np.float32)
        want = jly.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=True, window=window, q_offset=off)
        got = ly.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True, window=window, q_offset=off)
        _close(got, want, 2e-5)


def _gqa_params(cfg, rng):
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    p = {n: rng.standard_normal(s, dtype=np.float32) / math.sqrt(s[0])
         for n, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)), ("wv", (D, KV * hd)),
                      ("wo", (H * hd, D)))}
    p["q_norm"] = 0.1 * rng.standard_normal(hd, dtype=np.float32)
    p["k_norm"] = 0.1 * rng.standard_normal(hd, dtype=np.float32)
    return p


def test_gqa_attention_with_cache_matches_reference():
    """A prefill of 7 from position 0 into a cache of 12 (the kernel's
    path), then one decode step at position 7 (the plain path): outputs and
    the whole cache.  The port writes the cache in place."""
    cfg = replace(tconfigs.reduced(tconfigs.get_config("qwen3-1.7b")), dtype="float32")
    rng = _rng(3)
    p = _gqa_params(cfg, rng)
    jp, tp = ({n: jnp.asarray(a) for n, a in p.items()},
              {n: torch.from_numpy(a) for n, a in p.items()})
    shape = (2, 12, cfg.num_kv_heads, cfg.resolved_head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for s0, n in ((0, 7), (7, 1)):
        x = rng.standard_normal((2, n, cfg.d_model), dtype=np.float32)
        pos = np.broadcast_to(np.arange(s0, s0 + n, dtype=np.int32), (2, n))
        jout, jcache = jly.gqa_attention(cfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
                                         cache=jcache, cache_pos=s0)
        tout, tc = ly.gqa_attention(cfg, tp, torch.from_numpy(x),
                                    positions=torch.from_numpy(pos.copy()), cache=tcache,
                                    cache_pos=s0)
        assert tc is tcache
        _close(tout, jout, 2e-5)
        _close(tcache["k"], jcache["k"], 2e-5)
        _close(tcache["v"], jcache["v"], 2e-5)


# -------------------------------------------------------------------- model
def _cfg(arch, dtype="float32"):
    return replace(jconfigs.reduced(jconfigs.get_config(arch)), dtype=dtype)


def _tokens(cfg, n=S):
    return np.random.default_rng(4).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The JAX package's run: parameters (numpy), forward hidden states,
    logits and aux loss, prefill logits of the first n - N_DEC tokens, its
    cache, and the logits of N_DEC decode steps (n, cache of `_lengths`)."""
    cfg = _cfg(arch, dtype)
    n, cache_len = _lengths(arch)
    params = j_init_params(cfg, jax.random.PRNGKey(7))
    tok = jnp.asarray(_tokens(cfg, n))
    hidden, aux, _ = jax.jit(lambda p, t: j_forward(cfg, p, {"tokens": t}))(params, tok)
    logits = j_unembed(cfg, params, hidden).astype(jnp.float32)
    pre = jax.jit(lambda p, t, c: j_forward(cfg, p, {"tokens": t}, cache=c, cache_pos=0))
    h, _, cache = pre(params, tok[:, :n - N_DEC], j_init_cache(cfg, B, cache_len))
    out = {"hidden": _np(hidden), "logits": _np(logits), "aux": float(aux),
           "prefill": _np(j_unembed(cfg, params, h[:, -1]).astype(jnp.float32)),
           "cache": {k: np.asarray(v) for k, v in cache["layers"].items()}, "decode": []}
    step = jax.jit(lambda p, c, t, k: j_decode(cfg, p, c, t, k))
    for pos in range(n - N_DEC, n):
        lg, cache = step(params, cache, tok[:, pos:pos + 1], jnp.int32(pos))
        out["decode"].append(_np(lg))
    out["params"] = jax.tree.map(_np, params)
    return out


def _port(arch, dtype):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    cfg = replace(cfg, dtype=dtype)
    return cfg, convert.lm_params_from_reference(cfg, _reference(arch, dtype)["params"],
                                                 device="cpu")


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in DENSE + MOE]
                         + [("qwen3-1.7b", "bfloat16")])
def test_forward_prefill_and_decode_match_reference(arch, dtype):
    ref = _reference(arch, dtype)
    cfg, params = _port(arch, dtype)
    n, cache_len = _lengths(arch)
    tok = torch.from_numpy(_tokens(cfg, n)).long()
    hidden, aux, none = forward(cfg, params, {"tokens": tok})
    assert none is None and aux.dtype == torch.float32
    if cfg.moe is None:
        assert float(aux) == 0.0 == ref["aux"]
    else:
        assert abs(float(aux) - ref["aux"]) <= 1e-5
    _close_model(hidden, ref["hidden"], dtype)
    _close_model(unembed(cfg, params, hidden), ref["logits"], dtype)
    cache = init_cache(cfg, B, cache_len, device="cpu")
    h, _, cache = forward(cfg, params, {"tokens": tok[:, :n - N_DEC]}, cache=cache)
    _close_model(unembed(cfg, params, h[:, -1]), ref["prefill"], dtype)
    assert sorted(cache["layers"]) == sorted(ref["cache"])
    for name, want in ref["cache"].items():
        if name == "pos":
            np.testing.assert_array_equal(cache["layers"][name].numpy(), want)
        else:
            _close_model(cache["layers"][name], want, dtype)
    for i, pos in enumerate(range(n - N_DEC, n)):
        logits, cache = decode_step(cfg, params, cache, tok[:, pos:pos + 1], pos)
        assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab_size)
        _close_model(logits, ref["decode"][i], dtype)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_prefill_then_decode_matches_forward(arch):
    """The port alone, on its own random weights: prefill n - 3 tokens,
    decode 3, and the logits equal forward's at those positions (for
    deepseek-v3 the absorbed MLA form against the expanded one)."""
    cfg = replace(tconfigs.reduced(tconfigs.get_config(arch)), dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    n, cache_len = _lengths(arch)
    tok = torch.from_numpy(_tokens(cfg, n)).long()
    full = unembed(cfg, params, forward(cfg, params, {"tokens": tok})[0]).float()
    cache = init_cache(cfg, B, cache_len, device="cpu")
    h, _, cache = forward(cfg, params, {"tokens": tok[:, :n - N_DEC]}, cache=cache)
    torch.testing.assert_close(unembed(cfg, params, h[:, -1]).float(), full[:, n - N_DEC - 1],
                               rtol=1e-5, atol=1e-5)
    for pos in range(n - N_DEC, n):
        logits, cache = decode_step(cfg, params, cache, tok[:, pos:pos + 1], pos)
        torch.testing.assert_close(logits, full[:, pos], rtol=1e-5, atol=1e-5)


def test_init_params_draws_the_reference_distributions():
    """Shapes and dtypes of every leaf equal the JAX tree's; matrices are
    normal with std 1/sqrt(fan-in) (the embedding 0.02), norm scales zero."""
    cfg = _cfg("qwen3-1.7b", "bfloat16")
    jtree = jax.eval_shape(lambda: j_init_params(cfg, jax.random.PRNGKey(0)))
    params = init_params(cfg, seed=0, device="cpu")
    names = dict(params.named_parameters())
    assert names["tok_embed"].dtype == torch.bfloat16
    assert abs(float(names["tok_embed"].float().std()) - 0.02) < 0.002
    wq = names["layers.1.attn.wq"].float()
    assert tuple(wq.shape) == tuple(jtree["layers"]["attn"]["wq"].shape[1:])
    assert abs(float(wq.std()) * math.sqrt(cfg.d_model) - 1) < 0.05
    assert names["layers.0.attn.q_norm"].dtype == torch.float32
    assert not names["final_norm"].any() and "out_head" not in names
    assert not any(p.requires_grad for p in params.parameters())
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtree))
    assert sum(p.numel() for p in params.parameters()) == n_ref
    same = init_params(cfg, seed=0, device="cpu")
    assert torch.equal(same.layers[1].mlp["w_up"], params.layers[1].mlp["w_up"])


@pytest.mark.parametrize("arch", MOE)
def test_init_params_tree_matches_reference(arch):
    """The port's parameters, in the JAX tree (`lm_params_to_reference`),
    have the JAX tree's structure, shapes and dtypes leaf for leaf (the
    router fp32, the multi-token-prediction head's leaves included), and
    the MoE leaves the reference's scales: the expert stacks 1/sqrt(E),
    experts_down 1/sqrt(F)."""
    cfg = _cfg(arch, "bfloat16")
    jtree = jax.eval_shape(lambda: j_init_params(cfg, jax.random.PRNGKey(0)))
    tree = convert.lm_params_to_reference(init_params(cfg, seed=0, device="cpu"))
    jflat, jdef = jax.tree_util.tree_flatten(jtree)
    flat, tdef = jax.tree_util.tree_flatten(tree)
    assert tdef == jdef
    for got, want in zip(flat, jflat, strict=True):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    moe = tree["layers"]["moe"]
    m = cfg.moe
    assert moe["router"].dtype == torch.float32
    assert abs(float(moe["experts_up"].float().std()) * math.sqrt(m.num_experts) - 1) < 0.05
    assert abs(float(moe["experts_down"].float().std()) * math.sqrt(m.d_ff_expert) - 1) < 0.05


@pytest.mark.parametrize("arch", MOE)
def test_convert_round_trips_the_reference_tree(arch):
    """The JAX package's bf16 parameters into the port and back give the
    same tree, every leaf bit for bit."""
    cfg = _cfg(arch, "bfloat16")
    jtree = j_init_params(cfg, jax.random.PRNGKey(1))
    back = convert.lm_params_to_reference(
        convert.lm_params_from_reference(cfg, jtree, device="cpu"))
    jflat, jdef = jax.tree_util.tree_flatten(jtree)
    flat, tdef = jax.tree_util.tree_flatten(back)
    assert tdef == jdef
    for got, want in zip(flat, jflat, strict=True):
        want = np.asarray(want)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


# ----------------------------------------------------------- not yet ported
@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_other_families_train_on_the_data_stream(arch):
    """The ssm, hybrid, encdec and vlm families serve (their parameters and
    cache build; parity in `tests/test_torch_{ssm,rglru,encdec,vlm}.py`)
    and train on the data stream's batches (tokens, and the frames or the
    patches `synthetic_batch` draws): `loss_fn` and one step of
    `make_train_step` give finite results (parity in
    `tests/test_torch_train_{ssm,hybrid,encdec,vlm}.py`)."""
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import loss_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import init_opt_state

    cfg = replace(tconfigs.reduced(tconfigs.get_config(arch)), dtype="float32")
    params = init_params(cfg, device="cpu")
    assert init_cache(cfg, 1, 8, device="cpu")
    batch = synthetic_batch(cfg, ShapeConfig("t", 64, 2, "train"), seed=0, step=0, device="cpu")
    assert ("frames" in batch) == (cfg.family == "encdec")
    assert ("patches" in batch) == (cfg.family == "vlm")
    loss, m = loss_fn(cfg, params, batch)
    assert torch.isfinite(loss) and float(m["aux"]) == 0.0
    _params, _opt, m = make_train_step(cfg)(params, init_opt_state(params), batch, 0)
    assert all(torch.isfinite(v) for v in m.values()), m


def test_unported_configs_and_paths_raise():
    """A window, MLA and a ring cache now run (a dense config given a window
    of 16 makes a ring and decodes over it; one given MLA builds and runs
    a forward), and the moe family trains (`loss_fn`, the
    multi-token-prediction head included, and `make_train_step`).  The
    launch tooling's parts run too: the activation spec is set and cleared
    (a plain tensor's forward does not read it), and `set_moe_impl` takes a
    DeviceMesh (of a fake process group of 4), on which `a2a_available`
    holds for a reduced mixtral whose 4 experts divide the 'model' size."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import loss_fn, moe_a2a

    cfg = tconfigs.reduced(tconfigs.get_config("qwen3-1.7b"))
    for good in (replace(cfg, window=16, dtype="float32"),
                 replace(cfg, mla=tconfig.MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                                    qk_nope_head_dim=32, qk_rope_head_dim=16,
                                                    v_head_dim=32), dtype="float32")):
        params = init_params(good, seed=0, device="cpu")
        cache = init_cache(good, 1, 24, device="cpu")
        assert ("pos" in cache["layers"]) == (good.window is not None)
        tok = torch.arange(20)[None] % good.vocab_size
        h, _, cache = forward(good, params, {"tokens": tok}, cache=cache)
        logits, _ = decode_step(good, params, cache, tok[:, -1:], 20)
        assert torch.isfinite(logits).all()
    params = init_params(cfg, seed=0, device="cpu")
    tok = {"tokens": torch.arange(16)[None] % cfg.vocab_size}
    want, _, _ = forward(cfg, params, tok)
    set_activation_spec((("data",), "model", None))
    try:
        got, _, _ = forward(cfg, params, tok)
    finally:
        set_activation_spec(None)
    assert torch.equal(got, want)
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.int64)}
    for arch in ("mixtral-8x7b", "deepseek-v3-671b"):      # the moe family trains now
        c = replace(tconfigs.reduced(tconfigs.get_config(arch)), dtype="float32")
        loss, m = loss_fn(c, init_params(c, device="cpu"), batch)
        assert torch.isfinite(loss) and ("mtp" in m) == bool(c.mtp_depth)
        make_train_step(c)
    from torch.distributed import destroy_process_group
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import init_fake_process_group

    init_fake_process_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        moe_a2a.set_moe_impl(mesh=mesh, dp_axes=("data",))
        mix = tconfigs.reduced(tconfigs.get_config("mixtral-8x7b"))
        assert moe_a2a.a2a_available(mix, 16) and not moe_a2a.a2a_available(mix, 15)
        assert not moe_a2a.a2a_available(cfg, 16)            # no MoE
    finally:
        moe_a2a.set_moe_impl(None)
        destroy_process_group()
    assert not moe_a2a.a2a_available(mix, 16)
    p = {n: torch.from_numpy(a) for n, a in _gqa_params(cfg, _rng(5)).items()}
    with pytest.raises(ValueError, match="outside a cache"):
        ly.gqa_attention(cfg, p, torch.zeros(1, 5, cfg.d_model),
                         positions=torch.zeros(1, 5, dtype=torch.int32),
                         cache={"k": torch.zeros(1, 4, 2, 32), "v": torch.zeros(1, 4, 2, 32)},
                         cache_pos=0)
