"""Optimizers: AdamW and Adafactor (factored second moment) over trees of
tensors (counterpart of the JAX package's `repro.optim.optimizers`).

A tree is a nested dict of tensors (None entries are empty), or an
`nn.Module`, which stands for the flat dict of its `named_parameters()`.
Every step keeps the JAX package's dtypes: moments in the state dtype, the
update in fp32, a parameter updated as `(p.float() + u).to(p.dtype)`, the
clip scaled in fp32 and cast back.  Unlike the JAX package, which returns
new trees, the port writes in place where that saves device memory:
`adamw_update` and `adafactor_update` write the new moments into the
state's tensors (the returned `OptState` holds them, with step + 1), and
`apply_updates` writes into the parameters, under `torch.no_grad()`.  The
step counter is a 0-d int32 host tensor, so that the bias corrections and
the schedule are host scalars a card kernel takes without a copy; AdamW
divides by its bias corrections once they are on the moments' device, so
that a step on a DeviceMesh rounds as the plain step does.

Stacked layers.  The JAX package stacks the leaves of each of its layer
stacks on a leading layer axis, where the port keeps one parameter a
layer ("<root>.<i>.<path>").  AdamW is elementwise, so its moments are
kept a parameter each.  Adafactor is not: its row and column statistics
and its RMS clip are taken over the whole stacked leaf (a per-layer norm
weight (D,) is a factored (L, D) leaf there).  So for a module that names
its stacked roots in `stacked_roots` (the LM: `models.lm.STACKED`),
`init_opt_state` keeps Adafactor's state of the parameters under each
such root as the stacked leaf's, under the key "<root>.*.<path>", and
`adafactor_update` updates such a group as one stacked tensor.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["OptState", "init_opt_state", "adamw_update", "adafactor_update", "apply_updates",
           "global_norm", "clip_by_global_norm", "stack_key"]


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any        # first moment (adamw) or 0-d zeros (adafactor, momentum-free)
    nu: Any        # second moment (adamw) | (row, col) factored (adafactor)


def _tree(params) -> dict:
    """`params` as a tree: a module's `named_parameters()` as a flat dict,
    anything else as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def _map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (nested dicts; None stays None), with
    the entries of `rest` at the same places (which may be tuples)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if tree is None:
        return None
    return fn(tree, *rest)


def _leaves(tree) -> list:
    """The leaves of a nested dict in JAX's order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [tree]


def _state_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def stack_key(name: str, stacked) -> str | None:
    """The state key "<root>.*.<path>" of the parameter "<root>.<i>.<path>"
    whose root is in `stacked`, or None for any other name."""
    parts = name.split(".")
    if parts[0] in stacked and len(parts) > 2 and parts[1].isdigit():
        return ".".join([parts[0], "*", *parts[2:]])
    return None


def _stacked_groups(params: dict, keys) -> dict:
    """{state key: the names of its parameters in layer order} of each
    group of the flat dict `params` whose key "<root>.*.<path>" is in
    `keys`."""
    groups: dict = {}
    for name in params:
        key = stack_key(name, (name.split(".")[0],))
        if key in keys:
            groups.setdefault(key, []).append(name)
    return {k: sorted(v, key=lambda n: int(n.split(".")[1])) for k, v in groups.items()}


def _factored(shape, dt: torch.dtype, device) -> tuple:
    """Adafactor's (vr, vc) zeros for a leaf of `shape`: row and column
    statistics over its last two axes from two dimensions up, else a full
    vr and a 0-d vc."""
    shape = tuple(shape)
    if len(shape) >= 2:
        return (torch.zeros(shape[:-1], dtype=dt, device=device),
                torch.zeros(shape[:-2] + shape[-1:], dtype=dt, device=device))
    return (torch.zeros(shape, dtype=dt, device=device), torch.zeros((), dtype=dt, device=device))


def init_opt_state(params, optimizer: str = "adamw", dtype: str = "float32") -> OptState:
    """Zero moments in `dtype` on the parameters' devices.  With Adafactor,
    the parameters "<root>.<i>.<path>" of a module's `stacked_roots` (an
    LM's) share the state of their stacked leaf, (L, ...) for L layers,
    under "<root>.*.<path>"; a tree of tensors keeps a state a leaf each,
    and AdamW a state a parameter each."""
    stacked = getattr(params, "stacked_roots", ()) if isinstance(params, nn.Module) else ()
    params = _tree(params)
    dt = _state_dtype(dtype)
    if optimizer == "adamw":
        mu = _map(lambda p: torch.zeros_like(p, dtype=dt), params)
        nu = _map(lambda p: torch.zeros_like(p, dtype=dt), params)
    elif optimizer == "adafactor":
        def zero(p):
            return torch.zeros((), dtype=dt, device=p.device)

        def factored(p):
            return _factored(p.shape, dt, p.device)

        mu, nu = _map(zero, params), _map(factored, params)
        keys = {stack_key(n, stacked) for n in params} - {None}
        for key, names in _stacked_groups(params, keys).items():
            p = params[names[0]]
            for n in names:
                del mu[n], nu[n]
            mu[key] = zero(p)
            nu[key] = _factored((len(names), *p.shape), dt, p.device)
    else:
        raise ValueError(optimizer)
    return OptState(torch.zeros((), dtype=torch.int32), mu, nu)


def _split_as(t: torch.Tensor, like: torch.Tensor, skip: int) -> torch.Tensor:
    """A factor `t` of `like`'s shape but its size-1 dim `skip`, split as
    `like` is on every other dim (a DTensor; anything else as it is), so
    that the factored denominator is formed where `like`'s shards lie."""
    if not isinstance(t, DTensor):
        return t
    pl = [Shard(q.dim) if q.is_shard() and q.dim != skip else Replicate()
          for q in like.placements]
    return t.redistribute(t.device_mesh, pl)


def _stack(ts: list) -> torch.Tensor:
    """`torch.stack(ts)`; DTensors of one placement are stacked rank by rank
    (no data moves), each split dim one further, so that the new layer
    dim 0 stays whole."""
    t0 = ts[0]
    if not isinstance(t0, DTensor):
        return torch.stack(ts)
    if any(tuple(t.placements) != tuple(t0.placements) for t in ts):
        raise ValueError(f"a stacked group of several placements: {[t.placements for t in ts]}")
    pl = [Shard(q.dim + 1) if q.is_shard() else q for q in t0.placements]
    shape = (len(ts), *t0.shape)
    return DTensor.from_local(torch.stack([t.to_local() for t in ts]), t0.device_mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


@torch.no_grad()
def adamw_update(grads, state: OptState, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """(updates in fp32, the state with step + 1); the moments are written
    in place."""
    params = _tree(params)
    step = state.step + 1
    t = step.to(torch.float32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    on = {}

    def upd(g, p, m, v):
        # the bias corrections on the moments' device: a card kernel divides
        # by a host scalar through its reciprocal, a DTensor's division by
        # a tensor, so the two would round apart
        if m.device not in on:
            on[m.device] = (c1.to(m.device), c2.to(m.device))
        d1, d2 = on[m.device]
        g32 = g.float()
        m2 = b1 * m.float() + (1 - b1) * g32
        v2 = b2 * v.float() + (1 - b2) * g32 * g32
        u = (m2 / d1) / (torch.sqrt(v2 / d2) + eps) + weight_decay * p.float()
        m.copy_(m2)
        v.copy_(v2)
        return -lr * u

    return _map(upd, grads, params, state.mu, state.nu), OptState(step, state.mu, state.nu)


@torch.no_grad()
def adafactor_update(grads, state: OptState, params, lr, *, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0):
    """(updates in fp32, the state with step + 1); the factored second
    moments are written in place.  A leaf of two or more dimensions keeps a
    row and a column statistic over its last two axes; a 1-D leaf a full
    one.  The parameters of a stacked group of the state ("<root>.*.<path>",
    from `init_opt_state`) are updated as their stacked leaf: their
    gradients stacked on a leading layer axis, the statistics and the RMS
    clip taken over the whole of it, as the JAX package updates its
    stacked tree."""
    params = _tree(params)
    step = state.step + 1
    t = step.to(torch.float32)
    beta = 1.0 - t ** (-decay)

    def upd(g, p, v):
        g32 = g.float()
        g2 = g32 * g32 + eps
        vr, vc = v
        if g.dim() >= 2:
            vr2 = beta * vr.float() + (1 - beta) * g2.mean(dim=-1)
            vc2 = beta * vc.float() + (1 - beta) * g2.mean(dim=-2)
            r = vr2 / torch.clamp(vr2.mean(dim=-1, keepdim=True), min=eps)
            n = g32.dim()
            u = g32 / (_split_as(torch.sqrt(r)[..., None], g32, n - 1)
                       * _split_as(torch.sqrt(vc2)[..., None, :], g32, n - 2))
            vc.copy_(vc2)
        else:
            vr2 = beta * vr.float() + (1 - beta) * g2
            u = g32 / torch.sqrt(torch.clamp(vr2, min=eps))
        vr.copy_(vr2)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay:
            u = u + weight_decay * p.float()
        return -lr * u

    groups = _stacked_groups(params, state.nu)
    grouped = {n for names in groups.values() for n in names}
    rest = [n for n in params if n not in grouped]
    updates = _map(upd, *({n: tree[n] for n in rest} for tree in (grads, params, state.nu)))
    for key, names in groups.items():
        p = _stack([params[n] for n in names]) if weight_decay else None
        g = _stack([grads[n] for n in names])
        u = upd(g, p, state.nu[key])
        if isinstance(u, DTensor):          # back to the stacked placements, then split
            u = u.redistribute(u.device_mesh, g.placements)
        updates.update(zip(names, u.unbind(0)))
    return {n: updates[n] for n in params}, OptState(step, state.mu, state.nu)


@torch.no_grad()
def apply_updates(params, updates):
    """Each parameter p becomes (p.float() + u).to(p.dtype), in place;
    returns `params`."""
    def one(p, u):
        p.copy_((p.float() + u).to(p.dtype))
        return p

    _map(one, _tree(params), updates)
    return params


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (0-d)."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in _leaves(_tree(tree))))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm) in fp32 and cast back, the
    global norm)."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), grads), n
