"""Neural layers of the LM: norms, RoPE, GQA and MLA attention, SwiGLU.

The port of the JAX package's `repro.models.layers`, with its type
promotions: fp32 inside the norms, fp32 RoPE angles applied and cast back,
matmuls cast to the input's dtype, fp32 inside attention.  Attention with
Sq == Sk from position 0 at the default scale, causal or not (every
prefill and training forward from position 0, and an encoder's
self-attention), goes through the attention kernel under autograd
(`kernels.ops.FlashAttentionFn`) in place of the JAX package's blocked jnp
and plain paths, where its head dims lie in the kernel's domain; decode,
prefill past position 0, the ring cache's writes shorter than the ring,
cross attention (Sq != Sk) and both forms of MLA attend with
`_plain_attention` or `_ring_decode_attend`, as the JAX package does.
Weights keep the JAX layout (in, out).  Unlike JAX, `gqa_attention` and
`mla_attention` write the cache in place.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import NEG_INF
from . import spmd
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
    return spmd.matmul(x, w).to(x.dtype)


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
    """Attention of q (B, Sq, H, hd) over k (B, Sk, KV, hd) and v
    (B, Sk, KV, vd).  The attention kernel's function, and so its path
    through `kernels.ops.FlashAttentionFn` (the kernel, or on a CPU tensor
    its plain version, under autograd with the plain backward, so training
    gets attention's gradient on both devices), is this shape rule: Sq ==
    Sk from position 0 (q_offset 0), causal or not (an encoder's
    self-attention), the default scale 1/sqrt(hd), and one head dim for q,
    k and v (a head dim outside `kops.FLASH_HEAD_DIMS` raises there).
    Anything else goes to `_plain_attention`: decode and prefill past
    position 0, cross attention (Sq != Sk), MLA's expanded form (q and k
    192 wide, v 128) and its absorbed form (an explicit scale, v narrower
    than k).  On a mesh (DTensors), either runs on each rank's local batch
    and heads (`spmd.attention`)."""
    hd = q.shape[-1]
    if (q.shape[1] == k.shape[1] and q_offset == 0 and scale is None
            and k.shape[-1] == v.shape[-1] == hd):
        def fn(q, k, v):
            return kops.FlashAttentionFn.apply(q, k, v, causal, window)
    else:
        fn = functools.partial(_plain_attention, causal=causal, window=window,
                               q_offset=q_offset,
                               scale=scale if scale is not None else 1.0 / math.sqrt(hd))
    return spmd.attention(fn, q, k, v) if spmd.distributed(q) else fn(q, k, v)


# --------------------------------------------------------------- GQA layer
def gqa_attention(cfg: ModelConfig, p, x: torch.Tensor, *, positions: torch.Tensor,
                  cache: dict | None = None, cache_pos: int | None = None,
                  causal: bool = True, window=None, kv_override=None):
    """Grouped-query attention with RoPE, optional qk-norm and window.

    kv_override: (k, v), each (B, Sk, KV, hd), for cross attention (the
    whisper decoder over its encoder's output): taken as they are (no
    k-norm, and no RoPE on q or k), no cache, attended through
    `attention_core` (plain for Sq != Sk, as the JAX package's).

    cache: dict(k=(B, C, KV, hd), v=...), written in place and returned.
    - A linear cache: the new k and v go to [cache_pos, cache_pos + S).
      From cache_pos 0 the queries attend over the fresh k and v through
      `attention_core` (every later slot is masked for them, as in the JAX
      package's attention over the whole cache); past 0 over the whole
      cache.
    - A ring (the sliding-window cache shorter than the sequence, with
      `pos` (B, C) int32, each slot's position or -1): a write of S >= C
      tokens from position 0 attends over the fresh k and v with the
      window, and puts the last C of them into the ring rolled so that
      position t sits at slot t mod C.  A shorter write goes to slots
      [i, i + S), i = min(cache_pos mod C, C - S) (JAX's
      `dynamic_update_slice` clamps a start that would run past the ring;
      it does not wrap), and attends over the ring by each slot's position
      (`_ring_decode_attend`).  A write of S >= C tokens past position 0
      raises: the JAX package's answer there depends on its dispatch (its
      blocked path drops q_offset, its plain path shifts the causal mask by
      it), and its serving path never makes one.
    Returns (out (B, S, D), cache)."""
    B, S, _D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = spmd.heads(dense(x, p["wq"]), (B, S, H, hd))
    if kv_override is not None:
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        k, v = kv_override
        out = attention_core(q, k, v, causal=causal, window=window)
        return dense(out.reshape(B, S, H * hd), p["wo"]), cache
    k = spmd.heads(dense(x, p["wk"]), (B, S, KV, hd))
    v = spmd.heads(dense(x, p["wv"]), (B, S, KV, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    q_offset = 0
    if cache is not None:
        C = cache["k"].shape[1]
        if "pos" in cache:
            if S >= C:
                if cache_pos:
                    raise ValueError(f"a write of {S} >= {C} tokens into the ring past position "
                                     f"0 (at {cache_pos})")
                shift = (S - C) % C
                roll = functools.partial(torch.roll, shifts=shift, dims=1)
                cache["k"].copy_(spmd.along(roll, k[:, -C:], 1))
                cache["v"].copy_(spmd.along(roll, v[:, -C:], 1))
                cache["pos"].copy_(spmd.along(roll, positions[:, -C:], 1))
            else:
                i = min(cache_pos % C, C - S)
                cache["k"][:, i:i + S] = k
                cache["v"][:, i:i + S] = v
                cache["pos"][:, i:i + S] = positions
                return _ring_decode_attend(cfg, p, q, cache, positions), cache
        else:
            if cache_pos < 0 or cache_pos + S > C:
                raise ValueError(f"positions [{cache_pos}, {cache_pos + S}) outside a cache "
                                 f"of {C}")
            cache["k"][:, cache_pos:cache_pos + S] = k
            cache["v"][:, cache_pos:cache_pos + S] = v
            if cache_pos:
                k, v, q_offset = cache["k"], cache["v"], cache_pos
    out = attention_core(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return dense(out.reshape(B, S, H * hd), p["wo"]), cache


def _ring_decode_attend(cfg: ModelConfig, p, q: torch.Tensor, cache: dict,
                        positions: torch.Tensor) -> torch.Tensor:
    """Attention of q (B, S, H, hd) at `positions` (B, S) over the ring
    `cache`, each slot masked by its own position: valid where it was
    written (pos >= 0), at or before the query, and inside the window
    (`cfg.window`, or 2^30 without one).  fp32 scores over sqrt(hd), as the
    JAX package's `_ring_decode_attend`; returns the output projection
    (B, S, D)."""
    B, S, H, hd = q.shape
    KV = cfg.num_kv_heads
    k, v, kpos = cache["k"], cache["v"], cache["pos"]
    qg = spmd.splittable(q, 2, KV).reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) / math.sqrt(hd)
    qpos = positions.reshape(B, -1)[..., None]
    kp = kpos[:, None, :]
    valid = (kp >= 0) & (kp <= qpos) & (kp > qpos - (cfg.window or 1 << 30))
    pr = torch.softmax(scores.masked_fill(~valid[:, None, None], NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", pr, v.float())
    return dense(out.reshape(B, S, H * hd).to(q.dtype), p["wo"])


# --------------------------------------------------------------- MLA layer
def mla_attention(cfg: ModelConfig, p, x: torch.Tensor, *, positions: torch.Tensor,
                  cache: dict | None = None, cache_pos: int | None = None):
    """Multi-head Latent Attention (DeepSeek-V3), in the JAX package's two
    forms.

    Without a cache, the expanded form: per-head k and v made from the
    latent, q and k of nope + rope dims, v of v_head_dim, attended through
    `attention_core` (outside the kernel's domain: `_plain_attention`).
    With a cache, the absorbed form: the latent (kv_lora + rope) of
    positions [cache_pos, cache_pos + S) is written into cache["lat"]
    (B, cache_len, kv_lora + rope) in place, the queries are projected
    into the latent space through k_up (fp32), and attention runs MQA-style
    over the whole latent cache (values its first kv_lora dims, scale
    1/sqrt(nope + rope)); v_up is applied to the output (fp32).
    Returns (out (B, S, D), cache, or None without one)."""
    m = cfg.mla
    B, S, _D = x.shape
    H = cfg.num_heads
    nope, rope, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    cq = rms_norm(dense(x, p["q_down"]), p["q_down_norm"])
    q = spmd.heads(dense(cq, p["q_up"]), (B, S, H, nope + rope))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv = dense(x, p["kv_down"])
    c_kv = rms_norm(kv[..., :r], p["kv_down_norm"])
    k_rope = kv[..., r:].reshape(B, S, 1, rope)
    cos, sin = rope_angles(positions, rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    scale = 1.0 / math.sqrt(nope + rope)

    if cache is not None:
        lat_cache = cache["lat"]
        if cache_pos < 0 or cache_pos + S > lat_cache.shape[1]:
            raise ValueError(f"positions [{cache_pos}, {cache_pos + S}) outside a cache of "
                             f"{lat_cache.shape[1]}")
        lat_cache[:, cache_pos:cache_pos + S] = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)
        w_uk = p["k_up"].reshape(r, H, nope)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk.float())
        q_all = torch.cat([q_lat, q_rope.float()], dim=-1).to(x.dtype)
        o_lat = attention_core(q_all, lat_cache[:, :, None, :], lat_cache[:, :, None, :r],
                               causal=True, q_offset=cache_pos, scale=scale)
        w_uv = p["v_up"].reshape(r, H, m.v_head_dim)
        out = torch.einsum("bqhr,rhv->bqhv", o_lat.float(), w_uv.float())
        out = out.reshape(B, S, H * m.v_head_dim).to(x.dtype)
        return dense(out, p["wo"]), cache

    k_nope = spmd.heads(dense(c_kv, p["k_up"]), (B, S, H, nope))
    v = spmd.heads(dense(c_kv, p["v_up"]), (B, S, H, m.v_head_dim))
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
    out = attention_core(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True)
    return dense(out.reshape(B, S, H * m.v_head_dim), p["wo"]), None
