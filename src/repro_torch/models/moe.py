"""Mixture-of-Experts layer with sort-based dispatch (the port of the JAX
package's `repro.models.moe`).

Dispatch is capacity-bounded and sort-based: the routed (token, k) pairs
are ranked within their expert by a stable argsort of the expert ids, the
first C of each expert are written into an (E, C, D) buffer, and the rest
are dropped.  The experts run as three batched matmuls over that buffer
(`torch.bmm`, as the JAX package's einsums run outside any Pallas kernel),
so every expert's weights are read once a call.  The router runs in fp32,
the experts in the model dtype, as in the JAX package.

Two places follow the JAX package's arithmetic exactly rather than the
obvious torch call:
- the buffer is written by one `index_copy_` of the kept rows; every
  dropped row goes to one spare slot past the buffer, which is then cut
  off (JAX adds a dropped row's zero at slot (E - 1, C - 1), which leaves
  the slot's token as it was);
- the combine adds a token's K contributions one at a time in k order, in
  the model dtype, as `jax.ops.segment_sum` does (no `index_add_`, whose
  CUDA atomics add in any order, and no fp32 `sum` over K, which rounds
  once).

`moe_tokens` is the one body of the dispatch.  On a DeviceMesh it runs on
each data-parallel shard's tokens with the experts split over 'model' and
the batch's positions and capacity (`spmd.moe_layer`), or expert-parallel
over an all-to-all (`moe_a2a.moe_layer_a2a`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["moe_capacity", "route", "expert_ffn", "shared_ffn", "moe_tokens", "moe_layer",
           "aux_loss"]


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """An expert's slots for `tokens` routed tokens: tokens K / E times the
    capacity factor, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor, capacity=None,
          before=None):
    """The router of xt (T, D): fp32 softmax over the experts, the top K
    (gates renormalised to sum 1), and each routed pair's slot in its
    expert's buffer.  Returns (probs (T, E) fp32, gate (T, K) fp32, ids
    (T, K) int64, pos (T K,) int32, keep (T K,) bool); pair t K + k is
    token t's k-th expert at position pos among these tokens' pairs of
    that expert, and keep says pos < capacity (`moe_capacity` of T by
    default).  `before`, a function of these pairs' count per expert (E,),
    gives the pairs routed to each expert ahead of these tokens (the
    earlier shards' of a batch split over ranks); keep then says pos plus
    that count < capacity, so that a shard keeps what the whole batch
    would."""
    m = cfg.moe
    T = xt.shape[0]
    E, K = m.num_experts, m.top_k
    dev = xt.device
    probs = torch.softmax(torch.matmul(xt.float(), router.float()), dim=-1)
    gate, ids = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")
    pos_sorted = torch.arange(T * K, device=dev) - seg_start[sorted_e]
    pos = torch.empty(T * K, dtype=torch.int32, device=dev)
    pos[order] = pos_sorted.to(torch.int32)
    at = pos
    if before is not None:
        counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        at = pos + before(counts)[flat_e].to(torch.int32)
    return probs, gate, ids, pos, at < (moe_capacity(cfg, T) if capacity is None else capacity)


def expert_ffn(buf: torch.Tensor, eg: torch.Tensor, eu: torch.Tensor, ed: torch.Tensor):
    """The SwiGLU experts on their buffer: buf (n, C, D), eg / eu (n, D, F),
    ed (n, F, D) -> (n, C, D), three batched matmuls."""
    g = torch.bmm(buf, eg)
    u = torch.bmm(buf, eu)
    return torch.bmm(F.silu(g) * u, ed)


def shared_ffn(xt: torch.Tensor, sg: torch.Tensor, su: torch.Tensor, sd: torch.Tensor):
    """The shared experts' sum for every token: xt (T, D), sg / su (Ns, D,
    F), sd (Ns, F, D) -> (T, D)."""
    hg = torch.einsum("td,sdf->tsf", xt, sg)
    hu = torch.einsum("td,sdf->tsf", xt, su)
    return torch.einsum("tsf,sfd->td", F.silu(hg) * hu, sd)


def _same(t):
    return t


def moe_tokens(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor, ffn, *,
               capacity=None, before=None, experts=None, enter=_same, leave=_same):
    """The routed experts' output for the tokens xt (T, D): the one MoE body
    of every layout (one device, experts split over ranks, the all-to-all).
    Route (`route`, with `capacity` and `before`), scatter the kept pairs
    into the (E, R, D) buffer at their positions among these tokens' pairs
    (R = C; with `before`, min(C, T): a shard's kept pairs of an expert
    are at most its tokens), `ffn`, gather each pair's row, and add a
    token's K rows in k order.
    - ffn maps the buffer rows of the experts [lo, lo + n) (n, R, D), where
      `experts` = (lo, n) (all E by default), to their outputs (n, R, D);
    - enter / leave act on the tokens on their way into the buffer and on
      the gathered rows on their way out (identity by default; Megatron's
      copy and reduce where each rank runs a part of the experts).
    Returns (out (T, D), probs (T, E) fp32, ids (T, K))."""
    m = cfg.moe
    T, D = xt.shape
    E, K = m.num_experts, m.top_k
    C = moe_capacity(cfg, T) if capacity is None else capacity
    probs, gate, ids, pos, keep = route(cfg, router, xt, capacity, before)
    R = C if before is None else min(C, T)

    flat_e = ids.reshape(-1)
    slot = flat_e * R + pos
    tok = torch.arange(T * K, device=xt.device) // K
    xin = enter(xt)
    buf = xin.new_zeros((E * R + 1, D))
    buf.index_copy_(0, torch.where(keep, slot, E * R), xin[tok])
    buf = buf[:E * R].view(E, R, D)
    lo, n = experts or (0, E)
    if n != E:
        buf = buf[lo:lo + n]
        keep = keep & (flat_e >= lo) & (flat_e < lo + n)
        slot = slot - lo * R
    y = ffn(buf).reshape(n * R, D)

    rows = leave(torch.where(keep[:, None], y[torch.where(keep, slot, 0)], 0))
    contrib = (rows * gate.reshape(-1, 1).to(rows.dtype)).view(T, K, D)
    out = contrib[:, 0].clone()
    for k in range(1, K):
        out += contrib[:, k]
    return out, probs, ids


def moe_layer(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss 0-d fp32).
    p: router (D, E), experts_gate / experts_up (E, D, F), experts_down
    (E, F, D), and shared_gate / shared_up (Ns, D, F), shared_down
    (Ns, F, D) with `num_shared`."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    out, probs, ids = moe_tokens(
        cfg, xt, p["router"],
        lambda buf: expert_ffn(buf, p["experts_gate"], p["experts_up"], p["experts_down"]))
    if cfg.moe.num_shared:
        out = out + shared_ffn(xt, p["shared_gate"], p["shared_up"], p["shared_down"])
    return out.reshape(B, S, D).to(x.dtype), aux_loss(probs, ids, cfg.moe.num_experts)


def aux_loss(probs: torch.Tensor, ids: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss: E times the sum over experts of the
    mean router probability and the share of tokens whose first choice it
    is."""
    me = probs.mean(0)
    ce = F.one_hot(ids[:, 0], E).float().mean(0)
    return E * torch.sum(me * ce)
