"""RecurrentGemma's recurrent block: the RG-LRU recurrence and its causal conv.

The port of the JAX package's `repro.models.rglru` (De et al. 2024):
    r_t = sigmoid(W_r x_t),  i_t = sigmoid(W_i x_t)
    a_t = exp(-c softplus(Lambda) r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)
A prefill runs the recurrence as a log-depth scan over the sequence (torch
has no `associative_scan`: a Hillis-Steele doubling, ceil(log2 S) steps of
elementwise ops, in fp32); decode keeps h as O(1) state.  No kernel: the
JAX package has none for this block.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import spmd
from .config import ModelConfig

__all__ = ["lru_scan", "rglru_layer"]

_C = 8.0


def lru_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t from h_{-1} = 0, along axis 1 of a, bx (B, S,
    W): each step d = 1, 2, 4, ... composes every pair (a, b) with the one d
    positions before it, (a', b') o (a, b) = (a' a, b' a + b).  The products
    associate in another order than JAX's `associative_scan`, so the two
    agree to rounding, not bit for bit."""
    S = a.shape[1]
    d = 1
    while d < S:
        bx = torch.cat([bx[:, :d], torch.addcmul(bx[:, d:], a[:, d:], bx[:, :-d])], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return bx


def rglru_layer(cfg: ModelConfig, p, x: torch.Tensor, *, cache: dict | None = None):
    """The recurrent block: conv1d -> RG-LRU -> output projection.  x (B, S,
    D) -> (B, S, D), and the cache.  cache: {"conv" (B, K - 1, W) in the
    model dtype, "h" (B, W) fp32}, written in place; with a cache the scan
    starts from h: h_t = scan_t + (a_1 ... a_t) h.  The reference's dtypes:
    the conv's products in fp32 (the fp32 conv_w) and kept in fp32; the
    gates' products in fp32 (JAX promotes the bf16 w_r and w_i to the fp32
    input's type); h cast to x's dtype before the gelu gate."""
    r = cfg.rglru
    B, S, _D = x.shape
    W = r.lru_width or cfg.d_model
    xw = spmd.matmul(x, p["in_proj"])
    gate = F.gelu(spmd.matmul(x, p["gate_proj"]), approximate="tanh")

    K = r.conv_width
    state = (torch.zeros((B, K - 1, W), dtype=xw.dtype, device=x.device) if cache is None
             else cache["conv"].to(xw.dtype))
    xp = torch.cat([state, xw], dim=1)
    xc = sum(xp[:, i:i + S] * p["conv_w"][i][None, None] for i in range(K))     # fp32

    rg = torch.sigmoid(spmd.matmul(xc, p["w_r"].float()))
    ig = torch.sigmoid(spmd.matmul(xc, p["w_i"].float()))
    a = torch.exp(-_C * F.softplus(p["lam"].float()) * rg)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (ig * xc.float())
    h = lru_scan(a, bx)
    if cache is not None:
        h = h + spmd.along(functools.partial(torch.cumprod, dim=1), a, 1) \
            * cache["h"][:, None].float()
        cache["conv"].copy_(xp[:, -(K - 1):])
        cache["h"].copy_(h[:, -1])
    y = h.to(x.dtype) * gate
    return spmd.matmul(y, p["out_proj"]).to(x.dtype), cache
