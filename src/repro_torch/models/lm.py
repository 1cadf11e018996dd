"""The decoder LM: parameters, cache, forward and decode.

The port of the decoder part of the JAX package's `repro.models.lm`: the
dense family (llama-style decoders: qwen3 with qk-norm, olmo with the
non-parametric LayerNorm, phi3, deepseek-coder) and the moe family
(mixtral: top-2 MoE over 8 experts, GQA with a sliding window and its ring
cache; deepseek-v3: MLA attention, top-8 MoE over 256 routed experts and a
shared one, and the multi-token-prediction head's parameters).  The JAX
package stacks the layers on a leading axis and scans them; here `LM` is
an `nn.Module` holding one `Block` a layer in an `nn.ModuleList`, and
`forward` / `decode_step` loop over them.  Parameters are made on their
device from a seeded `torch.Generator`, with the JAX package's
distributions (normal over sqrt(first axis), the embedding at 0.02, norm
scales at zero); they keep JAX's (in, out) layout and are made with
`requires_grad=False`, so serving builds no graph: training turns
gradients on explicitly (`params.requires_grad_()`, as
`launch.train.make_train_step` does).  The cache keeps JAX's stacked
layout, {"layers": {"k": (L, B, C, KV, hd), "v": ...}} (with a window
shorter than the cache, a ring of C = window slots and "pos" (L, B, C)
int32; with MLA, {"layers": {"lat": (L, B, C, kv_lora + rope)}}), and is
written in place.

Training: `loss_fn` (next-token cross-entropy through `chunked_ce`, which
never holds the (B, S, vocab) logits at once) and `cfg.remat`, read where
a forward records a graph: "none" keeps every activation, "block" and
"full" recompute each `Block` in the backward
(`torch.utils.checkpoint`, non-reentrant), as the JAX package's
`jax.checkpoint` per scanned layer does.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item (`ROADMAP.md` §1):
- item 4 (slice 7c): the ssm, hybrid (RG-LRU), encdec and vlm families
  (`check_ported`), and the moe family's training: `loss_fn` on a moe
  config (the aux loss under autograd), the multi-token-prediction loss,
  and Adafactor in the train step (`launch.train.make_train_step`);
- item 6 (the launch tooling): `remat="dots"`, the training-side
  activation sharding (`set_activation_spec`), and the all-to-all MoE
  dispatch (`moe_a2a`), which needs a mesh.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.types import resolve_device
from . import layers as ly
from .config import ModelConfig
from .moe import moe_layer

__all__ = ["LM", "Block", "init_params", "init_cache", "embed", "unembed", "forward",
           "decode_step", "chunked_ce", "loss_fn", "check_ported", "set_activation_spec"]

_ITEM4 = "ROADMAP.md §1, item 4 (slice 7c)"


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config the port cannot run yet: the
    ssm, hybrid, encdec and vlm families (item 4 of ROADMAP.md §1).  The
    dense and moe families run: GQA (qk-norm, windows and their ring
    cache) or MLA, SwiGLU or sort-based MoE.  What of a ported config
    still raises is named where it does: the moe family's training
    (`loss_fn`, `launch.train.make_train_step`; item 4), `remat="dots"`,
    `set_activation_spec` and `moe_a2a` (item 6)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet "
                                  f"({_ITEM4}: the SSM, RG-LRU, encoder-decoder and VLM "
                                  "families)")


def set_activation_spec(spec) -> None:
    """The JAX package's sequence-parallel activation sharding: not ported
    (the launch tooling)."""
    raise NotImplementedError("activation sharding is not ported (ROADMAP.md §1, item 6: the "
                              "launch tooling)")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# The most elements `_Init.mat` draws in fp32 at once: a larger matrix is
# drawn in slices along its first axis (deepseek-v3's expert stack, 3.8 G
# elements, would otherwise hold a 15 GB fp32 temporary).  Every matrix of
# at most this size is one draw.
DRAW_ELEMENTS = 1 << 30


class _Init:
    """Draws parameters on `device` from one seeded generator."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        meta = device.type == "meta"      # shapes only: no generator, no draws
        self.gen = None if meta else torch.Generator(device=device).manual_seed(seed)
        self.device, self.dtype = device, dtype

    def mat(self, shape, scale=None, dtype: torch.dtype | None = None) -> nn.Parameter:
        """Normal, std `scale` or 1/sqrt(shape[0]), drawn in fp32 and cast
        to `dtype` (the model's unless given), in slices of the first axis
        of at most DRAW_ELEMENTS elements."""
        std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        out = torch.empty(shape, dtype=dtype or self.dtype, device=self.device)
        rows = max(1, DRAW_ELEMENTS // max(1, math.prod(shape[1:])))
        for r0 in range(0, shape[0], rows):
            n = min(rows, shape[0] - r0)
            x = torch.randn((n, *shape[1:]), generator=self.gen, device=self.device,
                            dtype=torch.float32)
            out[r0:r0 + n] = x.mul_(std)
        return _param(out)

    def zeros(self, n: int) -> nn.Parameter:
        return _param(torch.zeros(n, dtype=torch.float32, device=self.device))


def _attn_params(cfg: ModelConfig, init: _Init) -> dict:
    """GQA: wq, wk, wv, wo, and q_norm / k_norm with qk-norm (the JAX
    package's `_attn_init`)."""
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    p = {"wq": init.mat((D, H * hd)), "wk": init.mat((D, KV * hd)),
         "wv": init.mat((D, KV * hd)), "wo": init.mat((H * hd, D))}
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = init.zeros(hd), init.zeros(hd)
    return p


def _mla_params(cfg: ModelConfig, init: _Init) -> dict:
    """MLA's projections and latent norms (the JAX package's `_mla_init`)."""
    m, D, H = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"q_down": init.mat((D, m.q_lora_rank)), "q_down_norm": init.zeros(m.q_lora_rank),
            "q_up": init.mat((m.q_lora_rank, H * qk)),
            "kv_down": init.mat((D, m.kv_lora_rank + m.qk_rope_head_dim)),
            "kv_down_norm": init.zeros(m.kv_lora_rank),
            "k_up": init.mat((m.kv_lora_rank, H * m.qk_nope_head_dim)),
            "v_up": init.mat((m.kv_lora_rank, H * m.v_head_dim)),
            "wo": init.mat((H * m.v_head_dim, D))}


def _moe_params(cfg: ModelConfig, init: _Init) -> dict:
    """The router (fp32, (D, E)), the expert stacks (E, D, F) and (E, F, D),
    and the shared experts' with `num_shared`, at the JAX package's
    `_moe_init` scales: 1/sqrt of the first axis, experts_down and
    shared_down 1/sqrt(F)."""
    m, D = cfg.moe, cfg.d_model
    E, F_ = m.num_experts, m.d_ff_expert
    p = {"router": init.mat((D, E), dtype=torch.float32),
         "experts_gate": init.mat((E, D, F_)), "experts_up": init.mat((E, D, F_)),
         "experts_down": init.mat((E, F_, D), scale=1.0 / math.sqrt(F_))}
    if m.num_shared:
        n = m.num_shared
        p["shared_gate"] = init.mat((n, D, F_))
        p["shared_up"] = init.mat((n, D, F_))
        p["shared_down"] = init.mat((n, F_, D), scale=1.0 / math.sqrt(F_))
    return p


class Block(nn.Module):
    """One decoder block: pre-norm attention (GQA, or MLA with `cfg.mla`)
    and a pre-norm SwiGLU, or MoE with `cfg.moe`, each residual.
    Parameters mirror the JAX block's tree: `attn` (GQA: wq, wk, wv, wo,
    and q_norm / k_norm with qk-norm; MLA: q_down, q_down_norm, q_up,
    kv_down, kv_down_norm, k_up, v_up, wo), `mlp` (w_gate, w_up, w_down) or
    `moe` (router, experts_*, shared_*), `attn_norm` and `mlp_norm` (None
    for the non-parametric norm)."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        parametric = not cfg.nonparametric_norm
        self.register_parameter("attn_norm", init.zeros(D) if parametric else None)
        self.attn = nn.ParameterDict(_mla_params(cfg, init) if cfg.mla is not None
                                     else _attn_params(cfg, init))
        self.register_parameter("mlp_norm", init.zeros(D) if parametric else None)
        if cfg.moe is not None:
            self.moe = nn.ParameterDict(_moe_params(cfg, init))
        else:
            self.mlp = nn.ParameterDict({"w_gate": init.mat((D, cfg.d_ff)),
                                         "w_up": init.mat((D, cfg.d_ff)),
                                         "w_down": init.mat((cfg.d_ff, D))})

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cache: dict | None,
                cache_pos: int):
        """Returns (x, the MoE layer's aux loss, or None without MoE)."""
        cfg = self.cfg
        h_in = ly.norm(cfg, self.attn_norm, x)
        if cfg.mla is not None:
            h, _ = ly.mla_attention(cfg, self.attn, h_in, positions=positions, cache=cache,
                                    cache_pos=cache_pos)
        else:
            h, _ = ly.gqa_attention(cfg, self.attn, h_in, positions=positions, cache=cache,
                                    cache_pos=cache_pos, window=cfg.window)
        x = x + h
        h_in = ly.norm(cfg, self.mlp_norm, x)
        if cfg.moe is None:
            return x + ly.swiglu(self.mlp, h_in), None
        h, aux = moe_layer(cfg, self.moe, h_in)
        return x + h, aux


class LM(nn.Module):
    """The decoder: `tok_embed` (vocab, d), `out_head` (d, vocab) unless
    the embeddings are tied, `final_norm`, `layers`, one `Block` a layer,
    and with `cfg.mtp_depth` the multi-token-prediction head's `mtp_proj`
    (2d, d), `mtp_block` and `mtp_norm` (held for the JAX package's tree;
    serving does not run them).  Built from `seed` on `device` (the card
    unless given)."""

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
        if cfg.mtp_depth:
            self.mtp_proj = init.mat((2 * cfg.d_model, cfg.d_model))
            self.mtp_block = Block(cfg, init)
            self.register_parameter(
                "mtp_norm", None if cfg.nonparametric_norm else init.zeros(cfg.d_model))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """The model's parameters, drawn from `seed` on `device` (the card
    unless given; raises without one)."""
    return LM(cfg, seed, device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    """A zeroed decode cache in the model's dtype unless given, on `device`
    (the card unless given; "meta" for shapes only), stacked per layer as
    the JAX package's `init_cache`: {"layers": {"k", "v"}} each
    (L, batch, C, KV, hd), C = min(cache_len, window) with a window; with a
    window shorter than cache_len also "pos" (L, batch, C) int32, filled
    with -1 (the ring); with MLA {"layers": {"lat": (L, batch, cache_len,
    kv_lora + rope)}}."""
    check_ported(cfg)
    dev = resolve_device(device)
    dt = dtype or _dt(cfg)
    L = cfg.num_layers
    if cfg.mla is not None:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return {"layers": {"lat": torch.zeros((L, batch, cache_len, width), dtype=dt,
                                              device=dev)}}
    window = cfg.window
    C = min(cache_len, window) if window else cache_len
    shape = (L, batch, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    layers = {"k": torch.zeros(shape, dtype=dt, device=dev),
              "v": torch.zeros(shape, dtype=dt, device=dev)}
    if window and cache_len > window:
        layers["pos"] = torch.full((L, batch, C), -1, dtype=torch.int32, device=dev)
    return {"layers": layers}


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
                cache_pos: int):
    """(x after every block, the summed aux loss of the MoE layers, 0-d
    fp32, or None without MoE)."""
    remat = _remat(params.cfg, params, cache)
    aux = None
    for i, block in enumerate(params.layers):
        if remat:
            x, a = checkpoint(block, x, positions, None, cache_pos, use_reentrant=False)
        else:
            lc = None if cache is None else {n: t[i] for n, t in cache["layers"].items()}
            x, a = block(x, positions, lc, cache_pos)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward(cfg: ModelConfig, params: LM, batch: dict, cache: dict | None = None,
            cache_pos: int = 0):
    """Full-sequence forward (prefill): batch["tokens"] (B, S).  With a
    cache, k and v of positions [cache_pos, cache_pos + S) are written into
    it in place.  Returns (hidden (B, S, D), the MoE layers' summed aux
    loss (0-d fp32; 0.0 without MoE), cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(cfg, params, tokens)
    positions = (torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
                 + cache_pos)
    x, aux = _run_layers(params, x, positions, cache, cache_pos)
    x = ly.norm(cfg, params.final_norm, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, cache


def decode_step(cfg: ModelConfig, params: LM, cache: dict, tokens: torch.Tensor, pos: int):
    """One decode step: tokens (B, 1) at absolute position `pos`, attending
    over the cache, which it updates in place.  Returns (logits (B, vocab)
    fp32, cache)."""
    B = tokens.shape[0]
    x = embed(cfg, params, tokens)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device)
    x, _ = _run_layers(params, x, positions, cache, pos)
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
    Returns (loss, {"ce", "aux"}), 0-d fp32 tensors.  The moe family's
    training (its aux loss under autograd, the multi-token-prediction loss)
    raises NotImplementedError (ROADMAP.md §1, item 4)."""
    if cfg.mtp_depth:
        raise NotImplementedError(f"{cfg.name}: the multi-token-prediction loss is not ported "
                                  f"yet ({_ITEM4}: the MoE family's training)")
    if cfg.family == "moe":
        raise NotImplementedError(f"{cfg.name}: the MoE family's training is not ported yet "
                                  f"({_ITEM4}: the MoE family's training)")
    if cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: the vlm loss is not ported yet ({_ITEM4}: the "
                                  "VLM family)")
    tokens = batch["tokens"]
    hidden, aux, _ = forward(cfg, params, batch)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if "mask" in batch:
        mask = mask * batch["mask"]
    ce = chunked_ce(cfg, params, hidden, targets, mask)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}
