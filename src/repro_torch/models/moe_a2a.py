"""Expert-parallel MoE dispatch over an all-to-all (counterpart of the JAX
package's `repro.models.moe_a2a`).

The sort-based dispatch of `moe.moe_layer` gathers the tokens of the whole
batch into one (E, C, D) buffer.  This module dispatches the way
expert-parallel systems do on the wire:

  1. tokens are sequence-sharded across the 'model' mesh dimension (every
     rank owns a distinct slice of tokens);
  2. each rank packs its routed tokens into per-destination-shard,
     per-expert capacity slots: buf (tp, E_local, C_e, D);
  3. ONE all-to-all over 'model' (`all_to_all_single_autograd`, under
     autograd) moves token payloads only;
  4. each shard runs its local experts on the received (E_local, tp C_e, D)
     batch by `torch.bmm`; the reverse all-to-all returns the outputs to
     the token owners.

The route, the packing and the combine are `moe.moe_tokens`, the body
every MoE layout shares (its buffer (E, C_e, D) is (tp, E_local, C_e, D)
in shard order), with steps 3 and 4 as its `ffn`; it runs on each rank's
local tensors inside a `local_map` region, as in the JAX package's
`shard_map` body; the experts' weights arrive gathered over the FSDP axes
(`spmd.use`: ZeRO, their gradients reduce-scattered back).  The aux loss
is each shard's estimate from its own statistics, averaged over all
shards.  Needs num_experts % tp == 0 (deepseek-v3: 256 % 16; mixtral's 8 <
16 keeps `spmd.moe_layer`'s tensor parallelism inside each expert).
Enabled per run by `set_moe_impl` (the dry run and a sharded trainer set
it; by default `lm` runs `moe.moe_layer`, or `spmd.moe_layer` on a mesh).
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..launch.mesh import batch_spec_axes
from .config import ModelConfig
from .moe import aux_loss, expert_ffn, moe_tokens, shared_ffn

__all__ = ["set_moe_impl", "a2a_available", "moe_layer_a2a"]

_IMPL = {"mesh": None, "dp_axes": (), "model_axis": "model"}


def set_moe_impl(mesh=None, dp_axes=(), model_axis: str = "model") -> None:
    """Install (or clear, with mesh=None) the all-to-all dispatch for the
    MoE layers: tokens batch-sharded over `dp_axes`, sequence- and
    expert-sharded over `model_axis` of the DeviceMesh `mesh`."""
    _IMPL.update(mesh=mesh, dp_axes=tuple(dp_axes), model_axis=model_axis)


def _size(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index(axis)) if axis in names else 1


def a2a_available(cfg: ModelConfig, seq_len: int) -> bool:
    mesh = _IMPL["mesh"]
    if mesh is None or cfg.moe is None:
        return False
    tp = _size(mesh, _IMPL["model_axis"])
    return cfg.moe.num_experts % tp == 0 and tp > 1 and seq_len % tp == 0 and seq_len >= tp


def moe_layer_a2a(cfg: ModelConfig, p, x):
    """Drop-in for `moe.moe_layer` where `a2a_available`: x (B, S, D), a
    DTensor (or a plain tensor, taken as replicated), and `p` the MoE
    parameters (DTensors gathered over the FSDP axes, the experts sharded
    on E over 'model').  Returns (out (B, S, D) DTensor, batch over the
    data axes and sequence over 'model'; aux 0-d DTensor, the mean over
    shards of E sum(me ce))."""
    mesh = _IMPL["mesh"]
    ax = _IMPL["model_axis"]
    m = cfg.moe
    names = tuple(mesh.mesh_dim_names)
    md = names.index(ax)
    tp = mesh.size(md)
    B, S, D = x.shape
    # the data axes the batch at hand divides (a micro-batch may take fewer)
    dp = tuple(a for a in batch_spec_axes(mesh, B) if a in _IMPL["dp_axes"])
    E, K = m.num_experts, m.top_k
    E_l = E // tp
    dp_size = 1
    for a in dp:
        dp_size *= _size(mesh, a)
    # per-source-shard, per-expert capacity
    T_l = (B * S) // tp // max(dp_size, 1)
    C_e = max(8, -(-int(T_l * K / E * m.capacity_factor) // 8) * 8)
    group = mesh.get_group(md)

    def body(xl, router, eg, eu, ed, *shared):
        Bl, Sl, _ = xl.shape
        xt = xl.reshape(Bl * Sl, D)

        def experts(buf):
            """The dispatch buffer (E, C_e, D) (expert e's rows for shard e //
            E_l) over the all-to-all to the shards that hold the experts,
            their local experts on the (E_l, tp C_e, D) batch, and back."""
            recv = funcol.all_to_all_single_autograd(buf.reshape(-1, D).contiguous(), None,
                                                     None, group)
            work = recv.view(tp, E_l, C_e, D).transpose(0, 1).reshape(E_l, tp * C_e, D)
            y = expert_ffn(work, eg, eu, ed)
            y = y.view(E_l, tp, C_e, D).transpose(0, 1).reshape(E * C_e, D)
            return funcol.all_to_all_single_autograd(y.contiguous(), None, None, group)

        out, probs, ids = moe_tokens(cfg, xt, router, experts, capacity=C_e)
        if shared:
            out = out + shared_ffn(xt, *shared)
        # switch aux loss from local stats, averaged over all shards
        return out.reshape(Bl, Sl, D).to(xl.dtype), aux_loss(probs, ids, E)

    # local_map reads a tuple as one entry an output or argument, and a list
    # as the placements of one tensor
    dp_set = set(dp)
    x_pl = [Shard(0) if n in dp_set else Shard(1) if i == md else Replicate()
            for i, n in enumerate(names)]
    rep = [Replicate()] * len(names)
    spread = set(dp) | {ax}            # dims over which the tokens differ
    part = [Partial() if n in spread else Replicate() for n in names]
    aux_pl = [Partial("avg") if n in spread else Replicate() for n in names]
    w_pl = [Shard(0) if i == md else Replicate() for i in range(len(names))]
    w_grad = [Shard(0) if i == md else Partial() if n in dp_set else Replicate()
              for i, n in enumerate(names)]
    shared = (p["shared_gate"], p["shared_up"], p["shared_down"]) if m.num_shared else ()
    fn = local_map(body, out_placements=(x_pl, aux_pl),
                   in_placements=(x_pl, rep, w_pl, w_pl, w_pl, *(rep,) * len(shared)),
                   in_grad_placements=(x_pl, part, w_grad, w_grad, w_grad,
                                       *(part,) * len(shared)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, p["router"], p["experts_gate"], p["experts_up"], p["experts_down"], *shared)
