"""The model's side of a DeviceMesh: ZeRO gathers at use, the residual
stream's placement, and the regions that run on each rank's local tensors.

A model whose parameters `launch.sharding.distribute_params` made DTensors
runs on the mesh: DTensor's propagation places every op the model does
(`forward` runs under `implicit_replication`, so a tensor the model makes
on the fly, a position or a mask, counts as replicated), except where this
module takes over:
- `use` all-gathers a weight over its FSDP axes where a block reads it
  (ZeRO-3, as GSPMD does in the JAX package: inside the block, so remat
  gathers again in the backward), and the gradient of that all-gather is
  a reduce-scatter back to the weight's shard;
- `constrain` puts the (B, S, D) residual at the activation spec
  (`lm.set_activation_spec`);
- `embedding` and `vocab_parallel_nll` look up and score a vocab split
  over 'model' where its rows lie (Megatron's vocab parallelism);
- `attention` runs the attention kernel (or the plain attention) on each
  rank's local batch and heads (a `local_map` region: never a DTensor's
  pointer, never all heads on one rank);
- `matmul` multiplies on each rank's local blocks by Megatron's rules;
- `along`, `per_batch` and `local_op` run, on local blocks, what DTensor
  has no strategy for or cannot split (a roll or running product along the
  sequence, the SSD's scan, a product over split batch and head dims);
- `moe_layer` runs the sort-based MoE (`moe.moe_tokens`) on each rank's
  tokens with the experts tensor-parallel over 'model' (split on E or on
  the hidden dim), with Megatron's two operators around the experts:
  identity forward and all-reduce backward on the way in, all-reduce
  forward and identity backward on the way out, so that the route and
  everything after the experts is replicated over 'model' in both
  directions.  A data-parallel shard keeps and drops what the whole batch
  would, as the JAX package's GSPMD layer does: the batch's capacity, and
  positions counted from the shards ahead of it; the aux loss takes the
  global statistics (sums over the shards).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

from ..launch.mesh import axis_sizes, batch_spec_axes, dp_axes

__all__ = ["to_placements", "use", "uses", "constrain", "attention", "moe_layer",
           "reduce_from", "copy_to", "on_mesh", "distributed", "like", "heads", "splittable",
           "matmul", "local_op", "along", "per_batch", "embedding", "vocab_parallel_nll",
           "whole_tokens"]


def distributed(t) -> bool:
    return isinstance(t, DTensor)


def on_mesh(t):
    """A context in which the model's own plain tensors (positions, masks,
    RoPE tables) count as replicated DTensors, when `t` is a DTensor and
    no such context is open yet (`implicit_replication` turns the switch
    off on leaving, so it must not nest); a null context otherwise.  The
    backward of a loss on a mesh runs in it too."""
    if not isinstance(t, DTensor) or DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()


def matmul(x, w):
    """`torch.matmul(x, w)` of x (..., d) and w (d, f).  On a mesh, x (B, S,
    d) or (T, d) and w (d, f) DTensors multiply on each rank's local blocks
    (a `local_map` region, so DTensor never flattens B and S into one
    split dim: its propagation of that product fails on fake tensors), with
    Megatron's rules on each mesh dim:
    - x split on a token dim, w whole: out split as x; w's gradient a
      partial sum;
    - x split on d, w on d (row parallel): out a partial sum;
    - x whole, w split on f (column parallel): out split on f; x's
      gradient a partial sum;
    - anything else is gathered first: x's tokens where w is split on f
      (the all-gather of sequence parallelism), w where x is not split on
      d, x where w is not split on d."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor) and x.ndim in (2, 3)
            and w.ndim == 2):
        return torch.matmul(x, w)
    feat = x.ndim - 1
    x_pl, w_pl, out_pl, x_grad, w_grad = [], [], [], [], []
    for xq, wq in zip(x.placements, w.placements):
        xd = xq.dim if xq.is_shard() else None
        wd = wq.dim if wq.is_shard() else None
        if xd is not None and xd < feat and wd == 1:
            xd = None                         # gather the tokens
        if wd == 0 and xd != feat:
            wd = None                         # gather w's rows
        if xd == feat and wd != 0:
            xd = None                         # gather x's features
        x_pl.append(Shard(xd) if xd is not None else Replicate())
        w_pl.append(Shard(wd) if wd is not None else Replicate())
        if xd is not None and xd < feat:
            out_pl.append(Shard(xd)), x_grad.append(Shard(xd)), w_grad.append(Partial())
        elif xd == feat:
            out_pl.append(Partial()), x_grad.append(Shard(feat)), w_grad.append(Shard(0))
        elif wd == 1:
            out_pl.append(Shard(feat)), x_grad.append(Partial()), w_grad.append(Shard(1))
        else:
            out_pl.append(Replicate()), x_grad.append(Replicate()), w_grad.append(Replicate())
    fn = local_map(torch.matmul, out_placements=out_pl, in_placements=(x_pl, w_pl),
                   in_grad_placements=(x_grad, w_grad), device_mesh=x.device_mesh,
                   redistribute_inputs=True)
    return fn(x, w)


def along(fn, t, dim: int):
    """`fn(t)` for an op along `t`'s dim `dim` alone (a roll, a running
    product along the sequence): on a mesh, `dim` is gathered first where
    a mesh dim splits it, and `fn` runs on each rank's block."""
    if not isinstance(t, DTensor):
        return fn(t)
    pl = [Replicate() if q.is_shard() and q.dim == dim else q for q in t.placements]
    t = t.redistribute(t.device_mesh, pl) if tuple(pl) != tuple(t.placements) else t
    return local_map(fn, out_placements=pl, in_placements=(pl,), in_grad_placements=(pl,),
                     device_mesh=t.device_mesh)(t)


def per_batch(fn, *args, shared=(), n_out: int = 1):
    """`fn(*args)` on each rank's rows of the batch (dim 0 of every tensor
    arg but those at the indices `shared`, which have no batch dim), for an
    op independent from row to row (the SSD's chunked scan): every arg
    whole but the batch, the `n_out` outputs split as the batch; a shared
    arg's gradient a partial sum over the batch's mesh dims.  Without a
    DTensor arg, `fn(*args)`."""
    x0 = next((a for a in args if isinstance(a, DTensor)), None)
    if x0 is None:
        return fn(*args)
    mesh = x0.device_mesh
    rows = _batch_placements(mesh, x0.shape[0])
    rep = [Replicate()] * mesh.ndim
    part = [Partial() if q.is_shard() else Replicate() for q in rows]
    in_pl = tuple(None if not isinstance(a, torch.Tensor) else rep if i in shared else rows
                  for i, a in enumerate(args))
    in_grad = tuple(None if not isinstance(a, torch.Tensor) else part if i in shared else rows
                    for i, a in enumerate(args))
    return local_map(fn, out_placements=(rows,) * n_out if n_out > 1 else rows,
                     in_placements=in_pl, in_grad_placements=in_grad, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def local_op(fn, *args):
    """`fn(*args)` on each rank's local tensors, with no data moved: for an
    op independent along every dim its DTensor args are split on (a batched
    product over split batch and head dims, which DTensor would flatten
    into one).  The output takes the first arg's placements; no
    gradient."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    pls = [list(a.placements) if isinstance(a, DTensor) else None for a in args]
    return local_map(fn, out_placements=pls[0], in_placements=tuple(pls),
                     device_mesh=args[0].device_mesh)(*args)


def _vocab_dim(w, dim: int):
    """The one mesh dim that splits DTensor `w`'s dim `dim` (the vocab), or
    None (whole, or split over several)."""
    if not isinstance(w, DTensor):
        return None
    over = [i for i, q in enumerate(w.placements) if q.is_shard() and q.dim == dim]
    return over[0] if len(over) == 1 else None


def embedding(tokens, w):
    """`F.embedding(tokens, w)`; with the table's vocab rows split over one
    mesh dim, each rank looks up the tokens its rows hold (zeros for the
    others) and the rows are summed over that dim (a partial sum, reduced
    where a later op needs it)."""
    vd = _vocab_dim(w, 0)
    if vd is None or not isinstance(tokens, DTensor):
        return torch.nn.functional.embedding(tokens, w)
    mesh = w.device_mesh
    t_pl = [q if q.is_shard() and q.dim == 0 else Replicate() for q in tokens.placements]
    t_pl[vd] = Replicate()
    out_pl = [Partial() if i == vd else Shard(0) if q.is_shard() else Replicate()
              for i, q in enumerate(t_pl)]
    w_pl = [Shard(0) if i == vd else Replicate() for i in range(mesh.ndim)]
    w_grad = [Shard(0) if i == vd else Partial() if q.is_shard() else Replicate()
              for i, q in enumerate(t_pl)]

    def body(tl, wl):
        lo = mesh.get_local_rank(vd) * wl.shape[0]
        inside = (tl >= lo) & (tl < lo + wl.shape[0])
        rows = torch.nn.functional.embedding(torch.where(inside, tl - lo, 0), wl)
        return torch.where(inside[..., None], rows, 0)

    return local_map(body, out_placements=out_pl, in_placements=(t_pl, w_pl),
                     in_grad_placements=(t_pl, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, w)


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[target] of each row, the logits' vocab split
    over mesh dim `dim` (this rank's columns [lo, lo + V_l)): the max, the
    sum of exponentials and the target's logit each all-reduced over it;
    the gradient softmax - onehot, this rank's columns."""

    @staticmethod
    def forward(ctx, logits, target, mesh, dim):
        group = (mesh, dim)
        v_l = logits.shape[-1]
        lo = mesh.get_local_rank(dim) * v_l
        mx = funcol.wait_tensor(funcol.all_reduce(logits.amax(-1), "max", group))
        e = torch.exp(logits - mx[:, None])
        se = funcol.wait_tensor(funcol.all_reduce(e.sum(-1), "sum", group))
        inside = (target >= lo) & (target < lo + v_l)
        idx = torch.where(inside, target - lo, 0)
        gold = torch.where(inside, logits.gather(-1, idx[:, None])[:, 0], 0)
        gold = funcol.wait_tensor(funcol.all_reduce(gold, "sum", group))
        ctx.save_for_backward(e, se, idx, inside)
        return torch.log(se) + mx - gold

    @staticmethod
    def backward(ctx, g):
        e, se, idx, inside = ctx.saved_tensors
        grad = e / se[:, None]
        grad.scatter_add_(-1, idx[:, None], -inside.to(grad.dtype)[:, None])
        return grad * g[:, None], None, None, None


def vocab_parallel_nll(logits, target):
    """Each row's -log softmax(logits)[target] of DTensor `logits` (N, V),
    its vocab split over one mesh dim, against `target` (N,); None where
    the vocab is not split so (the caller's plain formula then applies)."""
    vd = _vocab_dim(logits, logits.ndim - 1)
    if vd is None:
        return None
    mesh = logits.device_mesh
    rows = [Shard(0) if q.is_shard() and q.dim == 0 else Replicate() for q in logits.placements]
    lg_pl = list(rows)
    lg_pl[vd] = Shard(1)
    rows[vd] = Replicate()
    fn = local_map(lambda lg, t: _VocabParallelNLL.apply(lg, t, mesh, vd), out_placements=rows,
                   in_placements=(lg_pl, rows), in_grad_placements=(lg_pl, rows),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(logits, target)


def splittable(t, dim: int, outer: int):
    """`t`, made ready to split its dim `dim` into (outer, rest): on a mesh,
    a dim split over more ranks than `outer` divides is gathered first
    (GQA's KV heads below the 'model' size)."""
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        over = [i for i, q in enumerate(t.placements) if q.is_shard() and q.dim == dim]
        if over and outer % math.prod(mesh.size(i) for i in over):
            pl = [Replicate() if i in over else q for i, q in enumerate(t.placements)]
            t = t.redistribute(mesh, pl)
    return t


def heads(t, shape):
    """`t.reshape(shape)`, `shape` splitting t's last dim into (heads,
    head dim), through `splittable`."""
    return splittable(t, t.ndim - 1, shape[-2]).reshape(shape)


def to_placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of a spec (a tuple with an entry a tensor
    dim: None, an axis name or a tuple of names): `Shard(dim)` on every
    mesh dimension the entry for `dim` names, `Replicate()` elsewhere."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def use(cfg, p):
    """`p` as a block reads it: a DTensor gathered over its FSDP mesh
    dimensions (the data-parallel ones; all of them under
    `parallelism="fsdp_sp"`), its 'model' sharding kept; anything else as
    it is."""
    if not isinstance(p, DTensor):
        return p
    names = p.device_mesh.mesh_dim_names
    fsdp = set(names) if cfg.parallelism == "fsdp_sp" else set(dp_axes(p.device_mesh))
    pl = [Replicate() if n in fsdp and q.is_shard() else q for n, q in zip(names, p.placements)]
    return p if tuple(pl) == tuple(p.placements) else p.redistribute(p.device_mesh, pl)


def uses(cfg, pd):
    """`use` over a block's parameter dict (a plain dict back when any
    entry is a DTensor, else `pd` itself)."""
    if pd is None or not any(isinstance(v, DTensor) for v in pd.values()):
        return pd
    return {k: use(cfg, v) for k, v in pd.items()}


def constrain(x, spec):
    """The residual x (B, S, D) at `spec` where x is a DTensor and S is a
    multiple of 16 (the JAX package's rule), else x.  A dim the spec's mesh
    dims do not divide (a micro-batch of one sequence over 'data') stays
    whole over them."""
    if (spec is None or not isinstance(x, DTensor) or x.ndim != 3 or x.shape[1] < 16
            or x.shape[1] % 16):
        return x
    mesh = x.device_mesh
    pl = list(to_placements(mesh, spec))
    for d in range(x.ndim):
        over = [i for i, q in enumerate(pl) if q.is_shard() and q.dim == d]
        if over and x.shape[d] % math.prod(mesh.size(i) for i in over):
            for i in over:
                pl[i] = Replicate()
    return x.redistribute(mesh, pl)


def whole_tokens(x):
    """x (B, S, D) with its sequence gathered where a mesh dim splits it
    (once for all the projections that read it: Megatron's sequence
    parallelism), else x."""
    if not isinstance(x, DTensor) or x.ndim != 3:
        return x
    pl = [Replicate() if q.is_shard() and q.dim == 1 else q for q in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def like(t: torch.Tensor, ref):
    """`t` (a plain tensor of `ref`'s global leading dims) placed as the
    DTensor `ref` is, each rank keeping its chunk; `t` itself when `ref` is
    not a DTensor."""
    if not isinstance(ref, DTensor):
        return t
    return DTensor.from_local(_chunk(t, ref), ref.device_mesh, ref.placements,
                              shape=t.shape, stride=t.contiguous().stride())


def _chunk(t: torch.Tensor, ref: DTensor) -> torch.Tensor:
    """This rank's chunk of `t` under `ref`'s Shard placements."""
    mesh = ref.device_mesh
    for i, pl in enumerate(ref.placements):
        if pl.is_shard():
            n, r = mesh.size(i), mesh.get_local_rank(i)
            step = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, r * step, step)
    return t.contiguous()


def _dim(mesh, name: str):
    names = tuple(mesh.mesh_dim_names)
    return names.index(name) if name in names else None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) over a mesh dimension forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) over a mesh dimension backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum", (ctx.mesh, ctx.dim))), \
            None, None


def reduce_from(x, mesh, dim):
    return x if dim is None else _ReduceFrom.apply(x, mesh, dim)


def copy_to(x, mesh, dim):
    return x if dim is None else _CopyTo.apply(x, mesh, dim)


def _batch_placements(mesh, batch: int, dim: int = 0) -> list:
    """Shard(dim) on the data-parallel mesh dims that divide `batch`,
    Replicate elsewhere."""
    bax = set(batch_spec_axes(mesh, batch))
    return [Shard(dim) if n in bax else Replicate() for n in mesh.mesh_dim_names]


def attention(fn, q, k, v):
    """`fn(q, k, v)`, an attention of DTensors q (B, Sq, H, hd) over k and
    v (B, Sk, KV, hd / vd), on each rank's local batch (over the
    data-parallel dims that divide B) and heads (over 'model' where H
    divides it; k and v too where KV does, else each rank slices the KV
    heads its query heads read), each sequence whole.  Returns a DTensor
    (B, Sq, H, vd) at q's placements."""
    mesh = q.device_mesh
    B, _S, H, _hd = q.shape
    KV = k.shape[2]
    tp = axis_sizes(mesh).get("model", 1)
    md = _dim(mesh, "model")
    q_pl = _batch_placements(mesh, B)
    kv_pl, kv_grad = list(q_pl), list(q_pl)
    heads = md is not None and tp > 1 and H % tp == 0
    if heads:
        q_pl[md] = Shard(2)
        if KV % tp == 0:
            kv_pl[md] = kv_grad[md] = Shard(2)
        else:
            kv_grad[md] = Partial()     # each rank reads its own slice of the heads
    group = H // KV

    def body(ql, kl, vl):
        if heads and KV % tp:
            h_l = ql.shape[2]
            if (h_l % group if h_l >= group else group % h_l):
                raise ValueError(f"{h_l} query heads a rank do not map onto whole KV groups "
                                 f"of {group}")
            r = mesh.get_local_rank(md)
            lo, hi = r * h_l // group, ((r + 1) * h_l - 1) // group + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql.contiguous(), kl.contiguous(), vl.contiguous())

    return local_map(body, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _model_split(w, md):
    """The tensor dim of DTensor `w` sharded over mesh dim `md`, or None."""
    if md is None:
        return None
    pl = w.placements[md]
    return pl.dim if pl.is_shard() else None


def moe_layer(cfg, p, x):
    """`moe.moe_layer` of a DTensor x (B, S, D) and the gathered weights `p`
    (`uses`): `moe.moe_tokens` on each data-parallel shard's tokens, with
    the whole batch's capacity and each pair's position in its expert
    counted over the whole batch (the pairs of the shards ahead of this one
    come from an all-gather of each shard's count per expert), so that a
    shard keeps and drops what the unsharded layer would; a shard's buffer
    holds min(C, its tokens) rows an expert, enough for what it keeps; the
    experts split
    over 'model' as their placements say (on E: a rank runs its experts; on
    the hidden dim F: a rank runs its slice of every expert; or whole),
    partial outputs all-reduced over 'model'.  Returns (out (B, S, D)
    DTensor at x's batch placement, aux 0-d DTensor): the aux loss of the
    global statistics."""
    from .moe import expert_ffn, moe_capacity, moe_tokens, shared_ffn

    mesh = x.device_mesh
    m = cfg.moe
    B, S, D = x.shape
    E = m.num_experts
    md = _dim(mesh, "model")
    # local_map reads a tuple as one entry an output or argument, and a list
    # as the placements of one tensor
    x_pl = _batch_placements(mesh, B)
    partial_dp = [Partial() if q.is_shard() else Replicate() for q in x_pl]
    names = ("experts_gate", "experts_up", "experts_down")
    shared = ("shared_gate", "shared_up", "shared_down") if m.num_shared else ()
    ws = [p[n] for n in (*names, *shared)]
    w_pl = [list(w.placements) for w in ws]
    w_grad = [[Partial() if dq.is_partial() else q for q, dq in zip(pl, partial_dp)]
              for pl in w_pl]
    split = [_model_split(w, md) for w in ws]
    e_split = split[0] == 0
    rmd = md if any(s is not None for s in split[:3]) else None     # routed experts split
    smd = md if any(s is not None for s in split[3:]) else None     # shared experts split
    C = moe_capacity(cfg, B * S)
    rows_over = [i for i, q in enumerate(x_pl) if q.is_shard()]     # mesh dims splitting B

    def before(counts):
        """The pairs per expert of the shards ahead of this rank's in the
        batch: Shard(0) over several mesh dims splits the rows in mesh-dim
        order, so the shard's index is row-major over them."""
        every, index = counts[None], 0
        for i in reversed(rows_over):
            every = funcol.wait_tensor(funcol.all_gather_tensor(every, 0, (mesh, i)))
        for i in rows_over:
            index = index * mesh.size(i) + mesh.get_local_rank(i)
        return every[:index].sum(0)

    def body(xl, router, eg, eu, ed, *sh):
        Bl, Sl, _ = xl.shape
        xt = xl.reshape(Bl * Sl, D)
        lo = mesh.get_local_rank(md) * eg.shape[0] if e_split else 0
        out, probs, ids = moe_tokens(
            cfg, xt, router, lambda buf: expert_ffn(buf, eg, eu, ed), capacity=C,
            before=before if rows_over else None, experts=(lo, eg.shape[0]),
            enter=lambda t: copy_to(t, mesh, rmd), leave=lambda t: reduce_from(t, mesh, rmd))
        if sh:
            out = out + reduce_from(shared_ffn(copy_to(xt, mesh, smd), *sh), mesh, smd)
        me_sum = probs.sum(0)
        ce_sum = torch.nn.functional.one_hot(ids[:, 0], E).float().sum(0)
        return out.reshape(Bl, Sl, D).to(xl.dtype), me_sum, ce_sum

    rep = [Replicate()] * len(x_pl)
    fn = local_map(body, out_placements=(x_pl, partial_dp, partial_dp),
                   in_placements=(x_pl, rep, *w_pl),
                   in_grad_placements=(x_pl, partial_dp, *w_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    out, me_sum, ce_sum = fn(x, p["router"], *ws)
    tokens = B * S
    aux = E * torch.sum((me_sum / tokens) * (ce_sum / tokens))
    return out, aux
