"""Training gradients of the port against the JAX package's, on the CPU.

Attention: `kernels.ops.FlashAttentionFn` (forward: the attention wrapper,
here its plain version; backward: the plain `ref.flash_attention_backward`)
against `jax.grad` of the JAX package's `_plain_attention` for causal,
windowed, non-causal, GQA and MQA cases, within 1e-5 (fp32, sums in
another order), also with the backward cut into blocks of query rows.  The
model: `loss_fn` and every gradient leaf of reduced qwen3, olmo and phi3 in
fp32 against `jax.value_and_grad(loss_fn)` on the same weights (carried
over by `convert`), each leaf within 1e-5 of the reference in relative L2;
remat "none" and "block" give the same gradients.  Serving after training
builds no graph.  The JAX side of each model case is computed once.
"""

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
from repro.models import init_params as j_init_params, loss_fn as j_loss_fn
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops as kops, ref as kref
from repro_torch.launch import serve
from repro_torch.models import init_cache, loss_fn
from repro_torch.models import lm as tlm

TOL = 1e-5
B, S = 2, 24

# (B, S, H, KV, hd, causal, window): GQA 2, MHA, MQA, windows below and past
# S, and non-causal with and without a window
ATTN_CASES = [
    (2, 37, 4, 2, 32, True, None), (1, 40, 4, 4, 64, True, None),
    (2, 33, 8, 1, 32, True, None), (1, 50, 4, 2, 32, True, 7),
    (1, 20, 4, 2, 32, True, 100), (2, 29, 4, 2, 32, False, None),
    (1, 31, 4, 1, 64, False, 5),
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attn_inputs(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]


@functools.lru_cache(maxsize=None)
def _jax_attn_grads(case):
    B_, S_, H, KV, hd, causal, window = case
    q, k, v, do = _attn_inputs(B_, S_, H, KV, hd)

    def f(q, k, v):
        o = jly._plain_attention(q, k, v, causal=causal, window=window, q_offset=0,
                                 scale=1 / math.sqrt(q.shape[-1]))
        return jnp.sum(o * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("blocked", [False, True])
def test_flash_function_backward_matches_jax_grad(case, blocked, monkeypatch):
    B_, S_, H, KV, hd, causal, window = case
    q, k, v, do = _attn_inputs(B_, S_, H, KV, hd)
    want = _jax_attn_grads(case)
    if blocked:     # 5 query rows a block: ragged blocks and key windows
        monkeypatch.setattr(kref, "BACKWARD_BLOCK_BYTES", 4 * B_ * H * S_ * 5)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    kref.reset_call_counts()
    out = kops.FlashAttentionFn.apply(*ts, causal, window)
    out.backward(torch.from_numpy(do))
    assert kref.call_counts["flash_attention"] == 1
    assert kref.call_counts["flash_attention_backward"] == 1
    for name, t, w in zip("qkv", ts, want):
        assert t.grad.shape == w.shape
        assert _rel(t.grad, w) <= TOL, (name, _rel(t.grad, w))


def test_attention_core_carries_gradients_to_q_k_v():
    """`attention_core` on the kernel's domain goes through the Function:
    the gradients reach q, k and v (the wrapper alone has no history on the
    card), and equal the plain attention's autograd."""
    q, k, v, do = (torch.from_numpy(x) for x in _attn_inputs(2, 21, 4, 2, 32, seed=1))
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tlm.ly.attention_core(*got).backward(do)
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tlm.ly._plain_attention(*want, causal=True, window=None, q_offset=0,
                            scale=1 / math.sqrt(32)).backward(do)
    for g, w in zip(got, want):
        assert g.grad is not None and float(g.grad.abs().max()) > 0
        assert _rel(g.grad, w.grad.numpy()) <= TOL


# ------------------------------------------------------------------- model
MODELS = ["qwen3-1.7b", "olmo-1b", "phi3-mini-3.8b"]


def _cfg(arch: str, remat: str = "block"):
    return replace(tconfigs.reduced(tconfigs.get_config(arch)), dtype="float32", remat=remat)


def _tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch: str, remat: str = "block"):
    jcfg = replace(jconfigs.reduced(jconfigs.get_config(arch)), dtype="float32", remat=remat)
    params = j_init_params(jcfg, jax.random.PRNGKey(11))
    tokens = _tokens(jcfg)
    (loss, m), grads = jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}), has_aux=True)(params)
    to_np = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    return to_np(params), float(loss), float(m["ce"]), to_np(grads)


def _port_loss_and_grads(arch: str, remat: str):
    params, *_ = _jax_loss_and_grads(arch)
    cfg = _cfg(arch, remat)
    model = convert.lm_params_from_reference(cfg, params, device="cpu").requires_grad_()
    kref.reset_call_counts()
    loss, m = loss_fn(cfg, model, {"tokens": torch.from_numpy(_tokens(cfg))})
    loss.backward()
    return cfg, model, loss, m


@pytest.mark.parametrize("arch", MODELS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    _params, jloss, jce, jgrads = _jax_loss_and_grads(arch)
    cfg, model, loss, m = _port_loss_and_grads(arch, "block")
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    assert abs(m["ce"].item() - jce) <= TOL * abs(jce) and m["aux"].item() == 0.0
    named = dict(model.named_parameters())
    assert len(named) == sum(1 for n in named if not n.startswith("layers.")) + \
        cfg.num_layers * sum(1 for n in named if n.startswith("layers.0."))
    for name, p in named.items():
        want = convert._ref_leaf(jgrads, name)
        assert p.grad is not None and p.grad.shape == want.shape, name
        assert _rel(p.grad, want) <= TOL, (name, _rel(p.grad, want))
    # remat: each block's forward runs again in the backward, attention too
    L = cfg.num_layers
    assert kref.call_counts["flash_attention"] == 2 * L
    assert kref.call_counts["flash_attention_backward"] == L


@pytest.mark.parametrize("arch", ["qwen3-1.7b"])
def test_remat_none_and_block_give_the_same_gradients(arch):
    _cfg_b, block, loss_b, _ = _port_loss_and_grads(arch, "block")
    cfg_n, none, loss_n, _ = _port_loss_and_grads(arch, "none")
    assert kref.call_counts["flash_attention"] == cfg_n.num_layers
    assert torch.equal(loss_b, loss_n)
    for (name, a), (_, b) in zip(block.named_parameters(), none.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7, msg=name)


def test_remat_dots_and_unported_losses_raise():
    """remat "dots" (selective checkpointing: the blocks' `aten.mm` outputs
    saved, the rest recomputed) against `jax.grad` under the JAX package's
    `checkpoint_dots_with_no_batch_dims`, and against remat "block"; the
    other families' losses run."""
    _params, jloss, jce, jgrads = _jax_loss_and_grads("qwen3-1.7b", "dots")
    cfg, dots, loss, m = _port_loss_and_grads("qwen3-1.7b", "dots")
    assert cfg.remat == "dots"
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    for name, p in dots.named_parameters():
        assert _rel(p.grad, convert._ref_leaf(jgrads, name)) <= TOL, name
    # the attention forward is recomputed (not an mm), the mm outputs are not
    assert kref.call_counts["flash_attention"] == 2 * cfg.num_layers
    _cfg_b, block, loss_b, _ = _port_loss_and_grads("qwen3-1.7b", "block")
    assert torch.equal(loss, loss_b)
    for (name, a), (_, b) in zip(dots.named_parameters(), block.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7, msg=name)
    most = _cfg("qwen3-1.7b", "most")
    with pytest.raises(ValueError, match="unknown remat"):
        loss_fn(most, tlm.init_params(most, seed=0, device="cpu").requires_grad_(),
                {"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    mtp = replace(cfg, mtp_depth=1, remat="block")             # trains now, as the moe family
    loss, m = loss_fn(mtp, tlm.init_params(mtp, seed=0, device="cpu").requires_grad_(),
                      {"tokens": torch.zeros((1, 8), dtype=torch.int64)})
    assert set(m) == {"ce", "aux", "mtp"} and torch.isfinite(loss)
    for arch in ("mamba2-130m", "recurrentgemma-9b", "whisper-medium", "pixtral-12b"):
        other = replace(tconfigs.reduced(tconfigs.get_config(arch)), remat="block")
        batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}     # trains now, too
        if other.family == "encdec":
            batch["frames"] = torch.zeros((1, other.encoder_seq, other.d_model))
        if other.family == "vlm":
            batch["patches"] = torch.zeros((1, 4, other.d_model))
        loss, m = loss_fn(other, tlm.init_params(other, seed=0, device="cpu").requires_grad_(),
                          batch)
        assert torch.isfinite(loss) and set(m) == {"ce", "aux"}
        loss.backward()


@pytest.mark.parametrize("S_", [24, 20, 7])
def test_chunked_ce_chunk_rule_matches_one_pass(S_):
    """Chunks of 8, 4 and 1 positions (the halving rule) against the whole
    (B, S, vocab) cross-entropy at once."""
    cfg = _cfg("qwen3-1.7b")
    model = tlm.init_params(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(0)
    hidden = torch.randn(2, S_, cfg.d_model, generator=g)
    targets = torch.randint(0, cfg.vocab_size, (2, S_), generator=g)
    mask = (torch.rand(2, S_, generator=g) > 0.2).float()
    got = tlm.chunked_ce(cfg, model, hidden, targets, mask, chunk=8)
    logits = tlm.unembed(cfg, model, hidden).float()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, targets[..., None])[..., 0]
    want = (nll * mask).sum() / mask.sum()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_serving_after_training_builds_no_graph():
    """With gradients on (as the train step leaves them), prefill and decode
    run under inference mode: no output has a grad_fn."""
    cfg = _cfg("qwen3-1.7b")
    model = tlm.init_params(cfg, seed=0, device="cpu").requires_grad_()
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(_tokens(cfg))
    cache = init_cache(cfg, B, S + 2, device="cpu")
    logits, cache = serve.make_prefill_step(cfg)(model, {"tokens": tokens}, cache)
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(c.grad_fn is None for c in cache["layers"].values())
    logits, cache = serve.make_decode_step(cfg)(model, cache, logits.argmax(-1, keepdim=True), S)
    assert logits.grad_fn is None and not logits.requires_grad
