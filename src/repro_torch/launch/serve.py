"""Serving steps of the LM: prefill and batched greedy decode.

The port of the JAX package's `repro.launch.serve`.  The steps run on the
device of the parameters and the cache, and update the cache in place (JAX
returns a new one); each also returns the cache, so a caller reads like the
JAX one.  Prefill runs the attention kernel once a layer.  Both steps run
under `torch.inference_mode()` (on a mesh `torch.no_grad()`), so serving a
model whose gradients are on (after training) builds no graph and keeps no
activations.
"""

from __future__ import annotations

import torch

from ..models import decode_step, forward, init_cache
from ..models.config import ModelConfig
from ..models import spmd
from ..models.lm import unembed

__all__ = ["make_prefill_step", "make_decode_step", "abstract_cache"]


def _no_graph(tokens):
    """`torch.inference_mode()`; on a mesh `torch.no_grad()` (a DTensor's
    views of a cache made outside inference mode cannot be taken inside
    it)."""
    return torch.no_grad() if spmd.distributed(tokens) else torch.inference_mode()


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, batch, cache) -> (last-token logits (B, vocab) fp32,
    filled cache), writing positions [0, S) of the cache."""

    def prefill(params, batch, cache):
        with _no_graph(batch["tokens"]):
            hidden, _, cache = forward(cfg, params, batch, cache=cache, cache_pos=0)
            return unembed(cfg, params, hidden[:, -1]).float(), cache

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens (B, 1), pos) -> (logits (B, vocab) fp32,
    cache)."""

    def step(params, cache, tokens, pos):
        with _no_graph(tokens):
            return decode_step(cfg, params, cache, tokens, pos)

    return step


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """The cache's shapes and dtypes, as tensors on the `meta` device (no
    memory)."""
    return init_cache(cfg, batch, cache_len, device=torch.device("meta"))
