"""Neural layers of the dense decoder: norms, RoPE, GQA attention, SwiGLU.

The port of the dense-path part of the JAX package's `repro.models.layers`,
with its type promotions: fp32 inside the norms, fp32 RoPE angles applied
and cast back, matmuls cast to the input's dtype.  Causal attention with
Sq == Sk (every prefill and training forward from position 0) goes through
the attention kernel under autograd (`kernels.ops.FlashAttentionFn`) in
place of the JAX package's blocked jnp paths; decode and prefill past position 0 attend over the cache with
`_plain_attention`, as the JAX package does.  Weights keep the JAX layout
(in, out).  Unlike JAX, `gqa_attention` writes the new k/v into the cache
in place.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import NEG_INF
from .config import ModelConfig

__all__ = ["rms_norm", "layer_norm_np", "norm", "rope_angles", "apply_rope", "dense", "swiglu",
           "NEG_INF", "attention_core", "gqa_attention", "mla_attention"]


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor | None = None, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)


def layer_norm_np(x: torch.Tensor, eps: float = 1e-5):
    """Non-parametric LayerNorm (OLMo)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def norm(cfg: ModelConfig, scale: torch.Tensor | None, x: torch.Tensor):
    if cfg.nonparametric_norm:
        return layer_norm_np(x)
    return rms_norm(x, scale)


# -------------------------------------------------------------------- RoPE
@functools.lru_cache(maxsize=None)
def _rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The RoPE frequencies, computed on the host in fp32 as the JAX package
    does and copied to `device` once (a copy a layer would stall the host
    on the card every layer)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos, sin (..., dim/2), fp32."""
    ang = positions.float()[..., None] * _rope_freqs(dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, hd); cos, sin (..., S, hd/2) broadcast over heads."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------ dense matmul
def dense(x: torch.Tensor, w: torch.Tensor):
    """x (..., d) @ w (d, f), in x's dtype."""
    return torch.matmul(x, w).to(x.dtype)


def swiglu(p, x: torch.Tensor):
    g = dense(x, p["w_gate"])
    u = dense(x, p["w_up"])
    return dense(F.silu(g) * u, p["w_down"])


# -------------------------------------------------------------- attention
def _plain_attention(q, k, v, *, causal: bool, window, q_offset: int, scale: float):
    """Einsum attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd),
    H % KV == 0; q_offset is the position of q[0] relative to k[0] (decode:
    Sq = 1).  The JAX package's `_plain_attention`, for decode and for
    prefill past position 0."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def attention_core(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0,
                   scale: float | None = None):
    """Attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd).  Causal
    attention with Sq == Sk from position 0 at the default scale is the
    attention kernel's function and goes through `kernels.ops.FlashAttentionFn`
    (the kernel, or on a CPU tensor its plain version, under autograd with
    the plain backward, so training gets attention's gradient on both
    devices); anything else to `_plain_attention`."""
    if causal and q.shape[1] == k.shape[1] and q_offset == 0 and scale is None:
        return kops.FlashAttentionFn.apply(q, k, v, True, window)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _plain_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                            scale=scale)


# --------------------------------------------------------------- GQA layer
def gqa_attention(cfg: ModelConfig, p, x: torch.Tensor, *, positions: torch.Tensor,
                  cache: dict | None = None, cache_pos: int | None = None,
                  causal: bool = True, window=None):
    """Grouped-query attention with RoPE and optional qk-norm.

    cache: dict(k=(B, C, KV, hd), v=...), a linear cache; the new k and v
    are written into it in place at [cache_pos, cache_pos + S), and the
    cache is returned.  From cache_pos 0 the queries attend over the fresh
    k and v through the kernel (every later slot is masked for them, as in
    the JAX package's attention over the whole cache); past 0 they attend
    over the whole cache.  Returns (out (B, S, D), cache)."""
    B, S, _D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense(x, p["wq"]).reshape(B, S, H, hd)
    k = dense(x, p["wk"]).reshape(B, S, KV, hd)
    v = dense(x, p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    q_offset = 0
    if cache is not None:
        if "pos" in cache:
            raise NotImplementedError("the sliding-window ring cache is not ported yet "
                                      "(ROADMAP.md §1, slice 7: the window ring cache)")
        C = cache["k"].shape[1]
        if cache_pos < 0 or cache_pos + S > C:
            raise ValueError(f"positions [{cache_pos}, {cache_pos + S}) outside a cache of {C}")
        cache["k"][:, cache_pos:cache_pos + S] = k
        cache["v"][:, cache_pos:cache_pos + S] = v
        if cache_pos:
            k, v, q_offset = cache["k"], cache["v"], cache_pos
    out = attention_core(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return dense(out.reshape(B, S, H * hd), p["wo"]), cache


def mla_attention(*_args, **_kwargs):
    """Multi-head Latent Attention (DeepSeek-V3): not ported yet."""
    raise NotImplementedError("MLA attention is not ported yet (ROADMAP.md §1, slice 7: "
                              "the MoE/MLA families)")
