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

The expert-parallel all-to-all dispatch of `moe_a2a` needs a mesh and is
not ported (`moe_a2a.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["moe_capacity", "route", "moe_layer"]


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """An expert's slots for `tokens` routed tokens: tokens K / E times the
    capacity factor, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """The router of xt (T, D): fp32 softmax over the experts, the top K
    (gates renormalised to sum 1), and each routed pair's slot in its
    expert's buffer.  Returns (probs (T, E) fp32, gate (T, K) fp32, ids
    (T, K) int64, pos (T K,) int32, keep (T K,) bool); pair t K + k is
    token t's k-th expert, and keep says pos < capacity."""
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
    return probs, gate, ids, pos, pos < moe_capacity(cfg, T)


def moe_layer(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss 0-d fp32).
    p: router (D, E), experts_gate / experts_up (E, D, F), experts_down
    (E, F, D), and shared_gate / shared_up (Ns, D, F), shared_down
    (Ns, F, D) with `num_shared`."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    C = moe_capacity(cfg, T)
    xt = x.reshape(T, D)
    probs, gate, ids, pos, keep = route(cfg, p["router"], xt)

    slot = ids.reshape(-1) * C + pos
    tok = torch.arange(T * K, device=x.device) // K
    buf = x.new_zeros((E * C + 1, D))
    buf.index_copy_(0, torch.where(keep, slot, E * C), xt[tok])
    buf = buf[:E * C].view(E, C, D)

    g = torch.bmm(buf, p["experts_gate"])
    u = torch.bmm(buf, p["experts_up"])
    y = torch.bmm(F.silu(g) * u, p["experts_down"]).view(E * C, D)

    rows = torch.where(keep[:, None], y[torch.where(keep, slot, 0)], 0)
    contrib = (rows * gate.reshape(-1, 1).to(rows.dtype)).view(T, K, D)
    out = contrib[:, 0].clone()
    for k in range(1, K):
        out += contrib[:, k]

    if m.num_shared:
        sg = torch.einsum("td,sdf->tsf", xt, p["shared_gate"])
        su = torch.einsum("td,sdf->tsf", xt, p["shared_up"])
        out = out + torch.einsum("tsf,sfd->td", F.silu(sg) * su, p["shared_down"])
    return out.reshape(B, S, D).to(x.dtype), _aux_loss(probs, ids, E)


def _aux_loss(probs: torch.Tensor, ids: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss: E times the sum over experts of the
    mean router probability and the share of tokens whose first choice it
    is."""
    me = probs.mean(0)
    ce = F.one_hot(ids[:, 0], E).float().mean(0)
    return E * torch.sum(me * ce)
