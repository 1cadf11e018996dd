"""The train step: microbatched gradient accumulation, clip, schedule and
optimizer (counterpart of the JAX package's `repro.launch.train`).

`make_train_step` returns the step the trainer and the `train_lm` twin run.
It turns the model's gradients on, runs `num_micro` forward/backward passes
over equal slices of the batch, accumulates their gradients in
`cfg.grad_acc_dtype` from zeros (`a + b.to(a.dtype)` in micro-batch order,
as the JAX package's scan) and divides by `num_micro` (one micro: the
gradients in the parameters' dtype, as the JAX package takes them), clips
by the global norm, and applies `cfg.optimizer` (AdamW, or Adafactor over
the JAX package's stacked layers, whose state `init_opt_state` makes
from the LM) at the cosine schedule's rate, in place on the model's
parameters.  On a DeviceMesh (parameters, state and batch DTensors,
`launch.sharding`) the same step runs SPMD: `micro_shardings` places each
micro-batch (rows [i mb, (i + 1) mb) of the global batch, spread over the
data-parallel ranks, as the JAX package's reshaped micro stack), and
`grad_shardings` each micro-batch's gradients (at the parameters'
placements: a weight's shard, reduce-scattered).
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig, ShapeConfig
from ..models import spmd
from ..models.lm import init_params, loss_fn
from ..optim import (adafactor_update, adamw_update, apply_updates, clip_by_global_norm,
                     cosine_schedule, init_opt_state)
from .mesh import axis_sizes, batch_spec_axes

__all__ = ["default_num_micro", "make_train_step", "abstract_train_state"]

def default_num_micro(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> int:
    """Microbatch count: per-device microbatch tokens about 8k at most for
    big models, fewer micro-steps for small ones (the JAX package's rule).
    The batch a device is the global batch over the data-parallel axes of
    `mesh` that divide it (a DeviceMesh or `MeshShape`); `mesh=None` is one
    device: the whole global batch on it."""
    if cfg.num_micro_override:
        return cfg.num_micro_override
    dp = 1
    if mesh is not None:
        sizes = axis_sizes(mesh)
        for a in batch_spec_axes(mesh, shape.global_batch):
            dp *= sizes[a]
    per_dev = max(1, shape.global_batch // dp)
    if cfg.d_model >= 4096:
        per_dev_micro = 1          # big models: one sequence per device/micro
    elif cfg.d_model >= 2048:
        per_dev_micro = min(per_dev, 4)
    else:
        per_dev_micro = min(per_dev, 8)
    n = max(1, per_dev // per_dev_micro)
    while shape.global_batch % n:
        n -= 1
    return n


def make_train_step(cfg: ModelConfig, *, num_micro: int = 1, lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000, clip_norm: float = 1.0,
                    micro_shardings: dict | None = None, grad_shardings: dict | None = None):
    """train_step(params: LM, opt_state, batch, step: int) -> (params,
    opt_state, metrics): params updated in place, metrics {"ce", "aux",
    "loss", "grad_norm", "lr"} and "mtp" with the multi-token-prediction
    head, as 0-d fp32 tensors (loss, ce, aux and mtp the means over the
    microbatches).  The optimizer is `cfg.optimizer`'s, as in the JAX
    package: AdamW, or else Adafactor.  Every family trains; a batch's
    leaves (tokens, and the encdec family's frames or the vlm family's
    patches) are each cut into the microbatches along their first axis.

    micro_shardings: {batch key: DTensor placements} of each micro-batch
    (its batch dim over the data-parallel axes), for a batch of DTensors
    cut into several micro-batches; without it a micro-batch keeps what
    slicing the DTensor gives.  grad_shardings: {parameter name:
    placements} each micro-batch's gradients are put at before they are
    accumulated."""
    acc_dt = torch.bfloat16 if cfg.grad_acc_dtype == "bfloat16" else torch.float32

    def train_step(params, opt_state, batch, step):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        B = batch["tokens"].shape[0]
        if B % num_micro:
            raise ValueError(f"a batch of {B} does not split into {num_micro} microbatches")
        mb = B // num_micro
        grads, losses, ms = None, [], []
        for i in range(num_micro):
            micro = batch if num_micro == 1 else {k: v[i * mb:(i + 1) * mb]
                                                  for k, v in batch.items()}
            if micro_shardings is not None and num_micro > 1:
                micro = {k: v.redistribute(v.device_mesh, micro_shardings[k])
                         for k, v in micro.items()}
            loss, m = loss_fn(cfg, params, micro)
            with spmd.on_mesh(loss):
                loss.backward()
            if grad_shardings is not None:
                for n, p in named.items():
                    if tuple(p.grad.placements) != tuple(grad_shardings[n]):
                        p.grad = p.grad.redistribute(p.grad.device_mesh, grad_shardings[n])
            if num_micro == 1:
                grads = {n: p.grad for n, p in named.items()}
            else:
                if grads is None:
                    grads = {n: torch.zeros_like(p, dtype=acc_dt) for n, p in named.items()}
                for n, p in named.items():
                    grads[n] += p.grad.to(acc_dt)
            for p in named.values():
                p.grad = None
            losses.append(loss.detach())
            ms.append({k: v.detach() for k, v in m.items()})
        if num_micro > 1:
            grads = {n: g / num_micro for n, g in grads.items()}
        loss = torch.stack(losses).mean()
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr_t = cosine_schedule(step, peak_lr=lr, warmup_steps=warmup, total_steps=total_steps)
        update = adamw_update if cfg.optimizer == "adamw" else adafactor_update
        updates, opt_state = update(grads, opt_state, params, lr_t)
        del grads
        apply_updates(params, updates)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr_t)

    return train_step


def abstract_train_state(cfg: ModelConfig):
    """(params, opt_state) with every tensor on the `meta` device: their
    shapes and dtypes, no memory; an Adafactor state in the JAX package's
    stacked shapes."""
    params = init_params(cfg, device=torch.device("meta"))
    return params, init_opt_state(params, cfg.optimizer, cfg.opt_state_dtype)
