"""The dense decoder LM: parameters, cache, forward and decode.

The port of the dense-decoder part of the JAX package's `repro.models.lm`
(llama-style decoders: qwen3 with qk-norm, olmo with the non-parametric
LayerNorm, phi3, deepseek-coder).  The JAX package stacks the layers on a
leading axis and scans them; here `LM` is an `nn.Module` holding one
`Block` a layer in an `nn.ModuleList`, and `forward` / `decode_step` loop
over them.  Parameters are made on their device from a seeded
`torch.Generator`, with the JAX package's distributions (normal over
sqrt(fan-in), the embedding at 0.02, norm scales at zero); they keep JAX's
(in, out) layout and are made with `requires_grad=False`, so serving builds
no graph: training turns gradients on explicitly (`params.requires_grad_()`,
as `launch.train.make_train_step` does).  The cache keeps JAX's stacked
layout, {"layers": {"k": (L, B, C, KV, hd), "v": ...}}, and is written in
place.

Training: `loss_fn` (next-token cross-entropy through `chunked_ce`, which
never holds the (B, S, vocab) logits at once) and `cfg.remat`, read where
a forward records a graph: "none" keeps every activation, "block" and
"full" recompute each `Block` in the backward
(`torch.utils.checkpoint`, non-reentrant), as the JAX package's
`jax.checkpoint` per scanned layer does.

Not ported yet, each raising NotImplementedError that names its ROADMAP
slice: the moe, ssm, hybrid, encdec and vlm families, MLA and
sliding-window configs, the multi-token-prediction loss, `remat="dots"`,
and the training-side activation sharding (`set_activation_spec`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.types import resolve_device
from . import layers as ly
from .config import ModelConfig

__all__ = ["LM", "Block", "init_params", "init_cache", "embed", "unembed", "forward",
           "decode_step", "chunked_ce", "loss_fn", "check_ported", "set_activation_spec"]

_SLICE = "ROADMAP.md §1, slice 7"


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config the port cannot run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet "
                                  f"({_SLICE}: the MoE/MLA, SSM, RG-LRU, encoder-decoder and "
                                  "VLM families)")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported yet ({_SLICE}: "
                                  "the MoE/MLA families)")
    if cfg.window is not None:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention and its ring cache "
                                  f"are not ported yet ({_SLICE}: the window ring cache)")


def set_activation_spec(spec) -> None:
    """The JAX package's sequence-parallel activation sharding: not ported
    (the launch tooling of slice 7)."""
    raise NotImplementedError(f"activation sharding is not ported ({_SLICE}: the launch "
                              "tooling)")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Init:
    """Draws parameters on `device` from one seeded generator."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        meta = device.type == "meta"      # shapes only: no generator, no draws
        self.gen = None if meta else torch.Generator(device=device).manual_seed(seed)
        self.device, self.dtype = device, dtype

    def mat(self, shape, scale=None) -> nn.Parameter:
        """Normal, std `scale` or 1/sqrt(shape[0]), drawn in fp32 and cast."""
        std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        return _param((x * std).to(self.dtype))

    def zeros(self, n: int) -> nn.Parameter:
        return _param(torch.zeros(n, dtype=torch.float32, device=self.device))


class Block(nn.Module):
    """One decoder block: pre-norm GQA attention and pre-norm SwiGLU, each
    residual.  Parameters mirror the JAX block's tree: `attn` (wq, wk, wv,
    wo, and q_norm / k_norm with qk-norm), `mlp` (w_gate, w_up, w_down),
    `attn_norm` and `mlp_norm` (None for the non-parametric norm)."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
        parametric = not cfg.nonparametric_norm
        self.register_parameter("attn_norm", init.zeros(D) if parametric else None)
        attn = {"wq": init.mat((D, H * hd)), "wk": init.mat((D, KV * hd)),
                "wv": init.mat((D, KV * hd)), "wo": init.mat((H * hd, D))}
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = init.zeros(hd), init.zeros(hd)
        self.attn = nn.ParameterDict(attn)
        self.register_parameter("mlp_norm", init.zeros(D) if parametric else None)
        self.mlp = nn.ParameterDict({"w_gate": init.mat((D, cfg.d_ff)),
                                     "w_up": init.mat((D, cfg.d_ff)),
                                     "w_down": init.mat((cfg.d_ff, D))})

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cache: dict | None,
                cache_pos: int) -> torch.Tensor:
        cfg = self.cfg
        h, _ = ly.gqa_attention(cfg, self.attn, ly.norm(cfg, self.attn_norm, x),
                                positions=positions, cache=cache, cache_pos=cache_pos,
                                window=cfg.window)
        x = x + h
        return x + ly.swiglu(self.mlp, ly.norm(cfg, self.mlp_norm, x))


class LM(nn.Module):
    """The dense decoder: `tok_embed` (vocab, d), `out_head` (d, vocab)
    unless the embeddings are tied, `final_norm`, and `layers`, one `Block`
    a layer.  Built from `seed` on `device` (the card unless given)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        init = _Init(seed, resolve_device(device), _dt(cfg))
        self.tok_embed = init.mat((cfg.vocab_size, cfg.d_model), scale=0.02)
        self.register_parameter(
            "out_head", None if cfg.tie_embeddings else init.mat((cfg.d_model, cfg.vocab_size)))
        self.register_parameter(
            "final_norm", None if cfg.nonparametric_norm else init.zeros(cfg.d_model))
        self.layers = nn.ModuleList(Block(cfg, init) for _ in range(cfg.num_layers))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """The model's parameters, drawn from `seed` on `device` (the card
    unless given; raises without one)."""
    return LM(cfg, seed, device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    """A zeroed linear decode cache, {"layers": {"k", "v"}} each
    (L, batch, cache_len, KV, hd), in the model's dtype unless given, on
    `device` (the card unless given; "meta" for shapes only)."""
    check_ported(cfg)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dev = resolve_device(device)
    dt = dtype or _dt(cfg)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}}


def embed(cfg: ModelConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings times sqrt(d_model), the factor rounded to the
    model's dtype first (JAX's weak-typed scalar; a 0-d host tensor, which
    a kernel on the card takes as a scalar, without a copy)."""
    dt = _dt(cfg)
    return params.tok_embed[tokens].to(dt) * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)


def unembed(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    w = params.tok_embed.T if cfg.tie_embeddings else params.out_head
    return torch.matmul(x, w)


def _remat(cfg: ModelConfig, params: LM, cache: dict | None) -> bool:
    """Whether a forward recomputes its blocks in the backward: when it
    records a graph through trainable parameters, without a cache, and
    `cfg.remat` asks for it."""
    if cache is not None or not torch.is_grad_enabled() or not params.tok_embed.requires_grad:
        return False
    if cfg.remat == "dots":
        raise NotImplementedError("remat='dots' (save the matmuls' outputs, recompute the "
                                  "rest) is not ported yet (ROADMAP.md §1, item 6: the "
                                  "launch tooling)")
    if cfg.remat not in ("none", "block", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return cfg.remat != "none"


def _run_layers(params: LM, x: torch.Tensor, positions: torch.Tensor, cache: dict | None,
                cache_pos: int) -> torch.Tensor:
    remat = _remat(params.cfg, params, cache)
    for i, block in enumerate(params.layers):
        if remat:
            x = checkpoint(block, x, positions, None, cache_pos, use_reentrant=False)
            continue
        lc = None if cache is None else {n: cache["layers"][n][i] for n in ("k", "v")}
        x = block(x, positions, lc, cache_pos)
    return x


def forward(cfg: ModelConfig, params: LM, batch: dict, cache: dict | None = None,
            cache_pos: int = 0):
    """Full-sequence forward (prefill): batch["tokens"] (B, S).  With a
    cache, k and v of positions [cache_pos, cache_pos + S) are written into
    it in place.  Returns (hidden (B, S, D), aux loss 0.0, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(cfg, params, tokens)
    positions = (torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
                 + cache_pos)
    x = _run_layers(params, x, positions, cache, cache_pos)
    x = ly.norm(cfg, params.final_norm, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), cache


def decode_step(cfg: ModelConfig, params: LM, cache: dict, tokens: torch.Tensor, pos: int):
    """One decode step: tokens (B, 1) at absolute position `pos`, attending
    over the cache, which it updates in place.  Returns (logits (B, vocab)
    fp32, cache)."""
    B = tokens.shape[0]
    x = embed(cfg, params, tokens)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device)
    x = _run_layers(params, x, positions, cache, pos)
    x = ly.norm(cfg, params.final_norm, x)
    return unembed(cfg, params, x[:, 0]).float(), cache


def chunked_ce(cfg: ModelConfig, params: LM, hidden: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy over the mask's weight, a chunk of
    positions at a time (the JAX package's rule: the largest chunk <= 512
    dividing S, halving), the logits of a chunk in fp32: the (B, S, vocab)
    logits are never held at once in the forward.  hidden (B, S, D),
    targets (B, S) int, mask (B, S) fp32."""
    B, S, _D = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        logits = unembed(cfg, params, hidden[:, c0:c0 + chunk]).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[:, c0:c0 + chunk, None].long())[..., 0]
        m = mask[:, c0:c0 + chunk]
        nll = nll + ((lse - gold) * m).sum()
        cnt = cnt + m.sum()
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params: LM, batch: dict):
    """Next-token cross-entropy of batch["tokens"] (B, S), each position
    predicting the next (the last position masked), times batch["mask"]
    where given, plus 0.01 times the aux loss (0 for the dense family).
    Returns (loss, {"ce", "aux"}), 0-d fp32 tensors."""
    if cfg.mtp_depth:
        raise NotImplementedError(f"{cfg.name}: the multi-token-prediction loss is not ported "
                                  "yet (ROADMAP.md §1, slice 7c: the MoE/MLA families)")
    if cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: the vlm loss is not ported yet (ROADMAP.md §1, "
                                  "slice 7c: the VLM family)")
    tokens = batch["tokens"]
    hidden, aux, _ = forward(cfg, params, batch)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if "mask" in batch:
        mask = mask * batch["mask"]
    ce = chunked_ce(cfg, params, hidden, targets, mask)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}
