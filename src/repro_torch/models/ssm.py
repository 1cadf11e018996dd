"""Mamba-2 (State-Space Duality) block: the chunked scan of a prefill and the
O(1) decode.

The port of the JAX package's `repro.models.ssm`.  Within a chunk the
recurrence is computed as masked attention-like products, across chunks a
(B, H, P, N) state is carried by a plain loop over the chunks (the JAX
package's `lax.scan`); decode keeps the (conv, state) pair and costs O(1) a
token.  The products run in fp32, as the reference's `einsum`s do, each
written as pairwise products in an order that never holds a (B, nc, l, l,
H, P) intermediate (at mamba2-130m's 8 x 8192 prefill that would be 25
GB).  No kernel: the JAX package has none for this block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import spmd
from .config import ModelConfig

__all__ = ["causal_conv", "ssd_chunked", "mamba2_layer"]


def causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv over time: x (B, S, C), w (K, C) fp32.  state
    (B, K - 1, C): the trailing context of a decode.  The products in fp32
    (x times the fp32 w), the result cast to x's dtype.  Returns (y,
    new_state: the last K - 1 inputs, in x's dtype, or None for K = 1)."""
    K = w.shape[0]
    B, S, C = x.shape
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * w[i][None, None] for i in range(K))
    return y.to(x.dtype), (xp[:, -(K - 1):] if K > 1 else None)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, h0: torch.Tensor | None = None):
    """The SSD scan.  xh (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32 < 0,
    Bm / Cm (B, S, N); h0 (B, H, P, N) fp32, the state a prefill continues
    from (zeros unless given).  Per head: h_t = exp(A dt_t) h_{t-1} + dt_t
    B_t x_t, y_t = C_t . h_t.  S must be a multiple of `chunk`, as the
    reference asserts.  Returns (y (B, S, H, P) in xh's dtype, the final
    state (B, H, P, N) fp32)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"a sequence of {S} is not a multiple of the chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    xc = xh.reshape(B, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(B, nc, chunk, H).to(f32)
    Bc = Bm.reshape(B, nc, chunk, N).to(f32)
    Cc = Cm.reshape(B, nc, chunk, N).to(f32)

    dA = dtc * A[None, None, None, :]                     # (B, nc, l, H) log-decay <= 0
    cums = torch.cumsum(dA, dim=2)                        # inclusive, within a chunk

    # intra-chunk: y_i = sum_{j <= i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j.
    # Above the diagonal diff > 0 grows with the chunk (past 88 fp32's exp
    # overflows); it is masked to -inf before the exponential, so those
    # entries are exactly 0 and their gradient 0, not 0 x inf = NaN (the
    # reference masks after it: ROADMAP.md §3, item 3)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]           # (B, nc, l, l, H)
    above = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device).triu(1)
    L = torch.exp(diff.masked_fill(above[None, None, :, :, None], float("-inf")))
    del diff
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = CB[..., None] * L * dtc[:, :, None, :, :]          # (B, nc, i, j, H)
    del L
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
    del M

    # chunk states, then the scan across chunks
    seg_end = cums[:, :, -1:, :]                          # (B, nc, 1, H) a chunk's decay
    xw = xc * (dtc * torch.exp(seg_end - cums))[..., None]             # (B, nc, l, H, P)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, xw)   # (B, nc, H, P, N)
    del xw
    chunk_decay = torch.exp(seg_end[:, :, 0, :])          # (B, nc, H)
    h = torch.zeros((B, H, P, N), dtype=f32, device=xh.device) if h0 is None else h0.to(f32)
    prev = []                                             # the state at each chunk's start
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(prev, dim=1)                     # (B, nc, H, P, N)

    # inter-chunk: y_i += exp(cums_i) C_i . h_prev
    y += torch.einsum("bcin,bchpn->bcihp", Cc, h_prev) * torch.exp(cums)[..., None]
    return y.reshape(B, S, H, P).to(xh.dtype), h


def mamba2_layer(cfg: ModelConfig, p, x: torch.Tensor, *, cache: dict | None = None):
    """x (B, S, D) -> (B, S, D), and the cache.  cache: {"conv" (B, K - 1,
    din + 2N) in the model dtype, "state" (B, H, P, N) fp32}, written in
    place: a prefill (S > 1) continues the chunked scan from the cached
    state, a decode step (S = 1) updates it in O(1).  The reference's
    dtypes: dt, A, the scan and the skip in fp32; the scan's y cast to x's
    dtype before the skip is added (a decode step's y is not); the gate
    silu(z) in x's dtype."""
    s = cfg.ssm
    B, S, D = x.shape
    din = s.expand * D
    H = din // s.head_dim
    P, N = s.head_dim, s.d_state

    zxbcdt = spmd.matmul(x, p["in_proj"])
    z, xb, Bm, Cm, dt = torch.split(zxbcdt, [din, din, N, N, H], dim=-1)
    conv_out, new_conv = causal_conv(torch.cat([xb, Bm, Cm], dim=-1), p["conv_w"],
                                     None if cache is None else cache["conv"])
    conv_out = F.silu(conv_out)
    xb = spmd.heads(conv_out[..., :din], (B, S, H, P))
    Bm = conv_out[..., din:din + N]
    Cm = conv_out[..., din + N:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())                    # (H,) negative

    if cache is None or S > 1:
        chunk = min(s.chunk, S)
        # on a mesh, each rank scans its own rows (heads whole: A is shared)
        y, h = spmd.per_batch(lambda *a: ssd_chunked(*a[:5], chunk, a[5]), xb, dt, A, Bm, Cm,
                              None if cache is None else cache["state"], shared=(2,), n_out=2)
    else:
        # O(1) decode: h = h exp(A dt) + dt B x; y = C . h
        dec = torch.exp(A[None] * dt[:, 0])               # (B, H)
        xdt = xb[:, 0].float() * dt[:, 0, :, None]        # (B, H, P)
        h = cache["state"] * dec[..., None, None] + xdt[..., None] * Bm[:, 0, None, None].float()
        y = spmd.local_op(torch.matmul, h, Cm[:, 0, None, :, None].float())[..., 0][:, None]
        # (B, 1, H, P); on a mesh a rank's batch and heads alone
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(h)
    y = y + xb.float() * p["d_skip"].float()[None, None, :, None]
    # z's channels are y's heads: whole where the heads do not split over a mesh dim
    y = y.reshape(B, S, din).to(x.dtype) * F.silu(spmd.splittable(z, 2, H))
    return spmd.matmul(y, p["out_proj"]).to(x.dtype), cache
