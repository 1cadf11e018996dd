"""The LM of every family: parameters, cache, forward and decode.

The port of the JAX package's `repro.models.lm`: the dense family
(llama-style decoders: qwen3 with qk-norm, olmo with the non-parametric
LayerNorm, phi3, deepseek-coder), the moe family (mixtral: top-2 MoE over 8
experts, GQA with a sliding window and its ring cache; deepseek-v3: MLA
attention, top-8 MoE over 256 routed experts and a shared one, and the
multi-token-prediction head's parameters), ssm (mamba2: a stack of Mamba-2
blocks, `models.ssm`), hybrid (recurrentgemma: super-blocks of the
pattern (rec, rec, attn) and a tail of rec blocks, the RG-LRU of
`models.rglru` and local attention over a ring of `cfg.rglru.window`
slots), encdec (whisper: a non-causal encoder over precomputed frame
embeddings, `batch["frames"]`, and a decoder with cross attention) and
vlm (pixtral: precomputed patch embeddings, `batch["patches"]`, prepended
to the tokens).  The JAX package stacks the layers on a leading axis and
scans them; here `LM` is an `nn.Module` holding one `Block` a layer in an
`nn.ModuleList` under the JAX tree's stacked root (`layers`; `super`, an
`nn.ModuleDict` a super-block, and `tail`; `enc` and `dec`), and
`forward` / `decode_step` loop over them.  Parameters are made on their
device from a seeded `torch.Generator`, with the JAX package's
distributions (normal over sqrt(first axis), the embedding at 0.02, norm
scales at zero); they keep JAX's (in, out) layout and are made with
`requires_grad=False`, so serving builds no graph: training turns
gradients on explicitly (`params.requires_grad_()`, as
`launch.train.make_train_step` does).  The cache keeps JAX's stacked
layout (`init_cache`) and is written in place.

Training: `loss_fn` (next-token cross-entropy through `chunked_ce`, which
never holds the (B, S, vocab) logits at once, plus 0.01 times the MoE
layers' aux loss, and with `cfg.mtp_depth` 0.3 times the
multi-token-prediction head's cross-entropy) and `cfg.remat`, read where
a forward records a graph: "none" keeps every activation, "block" and
"full" recompute each `Block` in the backward
(`torch.utils.checkpoint`, non-reentrant), as the JAX package's
`jax.checkpoint` per scanned layer does.  Every family trains: the vlm
family's loss drops the patch positions before the cross-entropy, and the
encdec family's gradients reach the encoder through each decoder block's
cross attention.

`remat="dots"` is the JAX package's `checkpoint_dots_with_no_batch_dims`
as selective activation checkpointing: each block saves the outputs of its
products without batch dims (`aten.mm`) and recomputes the rest.

On a DeviceMesh (parameters made DTensors by
`launch.sharding.distribute_params`, the batch by `distribute_tree`), the
same code runs SPMD (`models.spmd`): each block gathers its weights over
the FSDP axes where it reads them, the residual stream is put at the
activation spec (`set_activation_spec`, the JAX package's sequence-parallel
residuals) at every block boundary, the attention kernel runs on each
rank's local heads, and the MoE layers run `moe_a2a.moe_layer_a2a` where
`moe_a2a.a2a_available`, else `spmd.moe_layer`.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.types import resolve_device
from . import layers as ly
from . import moe_a2a, spmd
from .config import ModelConfig
from .moe import moe_layer
from .rglru import rglru_layer
from .ssm import mamba2_layer

__all__ = ["LM", "Block", "init_params", "init_cache", "embed", "unembed", "forward",
           "decode_step", "chunked_ce", "loss_fn", "check_ported", "decoder_kind",
           "set_activation_spec", "STACKED"]

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# The JAX tree's roots whose leaves are stacked on a leading layer axis (the
# `LM`'s `nn.ModuleList`s of the same names): the decoder's layers, the
# hybrid family's super-blocks and tail, and the encoder-decoder's stacks.
STACKED = ("layers", "super", "tail", "enc", "dec")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ValueError for a family the JAX package does not have.  Every
    family of it serves and trains: GQA (qk-norm, windows and their ring
    cache) or MLA, SwiGLU or sort-based MoE, Mamba-2, RG-LRU with local
    attention, encoder-decoder, patch prefixes, on one device or a
    DeviceMesh."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}, not one of {_FAMILIES}")


# The residual stream's spec on a mesh, set by the launcher (the dry run,
# a sharded train step): a spec over (B, S, D) put on the residual at every
# block boundary (`spmd.constrain`).  None: DTensor places it freely.
_ACT_SPEC = {"spec": None}


def set_activation_spec(spec) -> None:
    """Put the residual stream of a forward on a mesh at `spec` (a tuple
    over (B, S, D), e.g. (("data",), "model", None): sequence-parallel
    residuals) at every block boundary where S >= 16 and S % 16 == 0, as
    the JAX package's `with_sharding_constraint`; None clears it."""
    _ACT_SPEC["spec"] = None if spec is None else tuple(spec)


def _constrain_act(x):
    return spmd.constrain(x, _ACT_SPEC["spec"])


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
        return self.full(n, 0.0)

    def full(self, n: int, value: float) -> nn.Parameter:
        return _param(torch.full((n,), value, dtype=torch.float32, device=self.device))


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


def _ssm_params(cfg: ModelConfig, init: _Init) -> dict:
    """Mamba-2's in_proj (D, 2 din + 2N + H), conv_w (d_conv, din + 2N)
    fp32 at 0.5, dt_bias and a_log zeros, d_skip ones (all (H,) fp32) and
    out_proj (din, D) (the JAX package's `_ssm_init`)."""
    s, D = cfg.ssm, cfg.d_model
    din = s.expand * D
    H, N = din // s.head_dim, s.d_state
    return {"in_proj": init.mat((D, 2 * din + 2 * N + H)),
            "conv_w": init.mat((s.d_conv, din + 2 * N), scale=0.5, dtype=torch.float32),
            "dt_bias": init.zeros(H), "a_log": init.zeros(H), "d_skip": init.full(H, 1.0),
            "out_proj": init.mat((din, D))}


def _rec_params(cfg: ModelConfig, init: _Init) -> dict:
    """The RG-LRU's in_proj and gate_proj (D, W), conv_w (conv_width, W)
    fp32 at 0.5, w_r and w_i (W, W), lam (W,) fp32 at 0.5 and out_proj (W,
    D) (the JAX package's `_rec_init`)."""
    r, D = cfg.rglru, cfg.d_model
    W = r.lru_width or D
    return {"in_proj": init.mat((D, W)), "gate_proj": init.mat((D, W)),
            "conv_w": init.mat((r.conv_width, W), scale=0.5, dtype=torch.float32),
            "w_r": init.mat((W, W)), "w_i": init.mat((W, W)), "lam": init.full(W, 0.5),
            "out_proj": init.mat((W, D))}


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


def decoder_kind(cfg: ModelConfig) -> str:
    """The block kind of a `layers` stack: ssm, mla or attn."""
    if cfg.family == "ssm":
        return "ssm"
    return "mla" if cfg.mla is not None else "attn"


class Block(nn.Module):
    """One block of `kind`, its parameters mirroring the JAX block's tree:
    - attn, mla: pre-norm attention (GQA `attn`: wq, wk, wv, wo, and
      q_norm / k_norm with qk-norm; MLA `attn`: q_down, q_down_norm, q_up,
      kv_down, kv_down_norm, k_up, v_up, wo) and a pre-norm SwiGLU `mlp`
      (w_gate, w_up, w_down), or MoE `moe` (router, experts_*, shared_*)
      with `cfg.moe`, each residual; `attn_norm` and `mlp_norm` (None for
      the non-parametric norm);
    - attn_local (the hybrid's attention, at `cfg.rglru.window`) and enc
      (the encoder's, non-causal): attn's parameters, with `mlp`;
    - dec: attn's, and `cross_norm` and `cross` (wq, wk, wv, wo: attention
      over the encoder's output), with `mlp`;
    - rec: `attn_norm`, the RG-LRU `rec` (in_proj, gate_proj, conv_w,
      w_r, w_i, lam, out_proj), `mlp_norm` and `mlp`;
    - ssm: `norm` and the Mamba-2 `ssm` (in_proj, conv_w, dt_bias, a_log,
      d_skip, out_proj)."""

    def __init__(self, cfg: ModelConfig, init: _Init, kind: str):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        D = cfg.d_model
        norm = (lambda: None) if cfg.nonparametric_norm else (lambda: init.zeros(D))
        if kind == "ssm":
            self.register_parameter("norm", norm())
            self.ssm = nn.ParameterDict(_ssm_params(cfg, init))
            return
        self.register_parameter("attn_norm", norm())
        if kind == "rec":
            self.rec = nn.ParameterDict(_rec_params(cfg, init))
        else:
            self.attn = nn.ParameterDict(_mla_params(cfg, init) if kind == "mla"
                                         else _attn_params(cfg, init))
        if kind == "dec":
            self.register_parameter("cross_norm", norm())
            self.cross = nn.ParameterDict(_attn_params(cfg, init))
        self.register_parameter("mlp_norm", norm())
        if cfg.moe is not None and kind in ("attn", "mla"):
            self.moe = nn.ParameterDict(_moe_params(cfg, init))
        else:
            self.mlp = nn.ParameterDict({"w_gate": init.mat((D, cfg.d_ff)),
                                         "w_up": init.mat((D, cfg.d_ff)),
                                         "w_down": init.mat((cfg.d_ff, D))})

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cache: dict | None,
                cache_pos: int, enc_out: torch.Tensor | None = None):
        """Returns (x, the MoE layer's aux loss, or None without MoE).  A
        dec block's cross attention reads k and v from `enc_out` (B, Se, D)
        where given, writing them into cache["cross_k"] / ["cross_v"] with a
        cache, else from the cache."""
        with spmd.on_mesh(x):
            return self._forward(x, positions, cache, cache_pos, enc_out)

    def _forward(self, x, positions, cache, cache_pos, enc_out):
        cfg, kind = self.cfg, self.kind
        p = functools.partial(spmd.uses, cfg)
        if kind == "ssm":
            h_in = spmd.whole_tokens(ly.norm(cfg, self.norm, x))
            h, _ = mamba2_layer(cfg, p(self.ssm), h_in, cache=cache)
            return x + h, None
        h_in = spmd.whole_tokens(ly.norm(cfg, self.attn_norm, x))
        if kind == "rec":
            h, _ = rglru_layer(cfg, p(self.rec), h_in, cache=cache)
        elif kind == "mla":
            h, _ = ly.mla_attention(cfg, p(self.attn), h_in, positions=positions, cache=cache,
                                    cache_pos=cache_pos)
        else:
            window = cfg.rglru.window if kind == "attn_local" else cfg.window
            self_cache = cache["self"] if kind == "dec" and cache is not None else cache
            h, _ = ly.gqa_attention(cfg, p(self.attn), h_in, positions=positions,
                                    cache=self_cache, cache_pos=cache_pos, causal=kind != "enc",
                                    window=window)
        x = x + h
        if kind == "dec":
            x = x + self._cross(x, cache, enc_out)
        h_in = ly.norm(cfg, self.mlp_norm, x)
        if cfg.moe is None or kind not in ("attn", "mla"):
            return x + ly.swiglu(p(self.mlp), spmd.whole_tokens(h_in)), None
        if moe_a2a.a2a_available(cfg, h_in.shape[1]):
            h, aux = moe_a2a.moe_layer_a2a(cfg, p(self.moe), h_in)
        elif spmd.distributed(h_in):
            h, aux = spmd.moe_layer(cfg, p(self.moe), h_in)
        else:
            h, aux = moe_layer(cfg, self.moe, h_in)
        return x + h, aux

    def _cross(self, x: torch.Tensor, cache: dict | None, enc_out: torch.Tensor | None):
        cfg = self.cfg
        cross = spmd.uses(cfg, self.cross)
        if enc_out is None:
            k, v = cache["cross_k"], cache["cross_v"]
        else:
            B, Se, _D = enc_out.shape
            shape = (B, Se, cfg.num_kv_heads, cfg.resolved_head_dim)
            k = spmd.heads(ly.dense(enc_out, cross["wk"]), shape)
            v = spmd.heads(ly.dense(enc_out, cross["wv"]), shape)
            if cache is not None:
                cache["cross_k"].copy_(k)
                cache["cross_v"].copy_(v)
        h, _ = ly.gqa_attention(cfg, cross, ly.norm(cfg, self.cross_norm, x), positions=None,
                                causal=False, kv_override=(k, v))
        return h


class LM(nn.Module):
    """The model: `tok_embed` (vocab, d), `out_head` (d, vocab) unless the
    embeddings are tied, `final_norm`, and the blocks under the JAX tree's
    stacked roots: `layers` (one `Block` a layer: attn, mla or ssm); for
    the hybrid family `super` (one `nn.ModuleDict` a super-block, a
    `Block` for each entry of `cfg.rglru.pattern`, named "<kind><i>":
    rec0, rec1, attn2) and `tail` (the rec blocks past the last whole
    super-block); for encdec `enc` (non-causal), `enc_norm` and `dec`.
    With `cfg.mtp_depth` also the multi-token-prediction head's `mtp_proj`
    (2d, d), `mtp_block` and `mtp_norm` (`loss_fn` runs them; serving
    does not).  Built from `seed` on `device` (the card
    unless given).  `stacked_roots` names the stacked roots for
    `optim.init_opt_state`, whose Adafactor keeps the state of each such
    root's leaf whole, as the JAX package does."""

    stacked_roots = STACKED

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        init = _Init(seed, resolve_device(device), _dt(cfg))
        norm = (lambda: None) if cfg.nonparametric_norm else (lambda: init.zeros(cfg.d_model))
        self.tok_embed = init.mat((cfg.vocab_size, cfg.d_model), scale=0.02)
        self.register_parameter(
            "out_head", None if cfg.tie_embeddings else init.mat((cfg.d_model, cfg.vocab_size)))
        self.register_parameter("final_norm", norm())
        if cfg.family == "hybrid":
            pat = cfg.rglru.pattern
            nb, rem = divmod(cfg.num_layers, len(pat))
            self.super = nn.ModuleList(
                nn.ModuleDict({f"{k}{i}": Block(cfg, init, "rec" if k == "rec" else "attn_local")
                               for i, k in enumerate(pat)}) for _ in range(nb))
            if rem:
                self.tail = nn.ModuleList(Block(cfg, init, "rec") for _ in range(rem))
        elif cfg.family == "encdec":
            self.enc = nn.ModuleList(Block(cfg, init, "enc") for _ in range(cfg.encoder_layers))
            self.register_parameter("enc_norm", norm())
            self.dec = nn.ModuleList(Block(cfg, init, "dec") for _ in range(cfg.num_layers))
        else:
            self.layers = nn.ModuleList(Block(cfg, init, decoder_kind(cfg))
                                        for _ in range(cfg.num_layers))
        if cfg.mtp_depth:
            self.mtp_proj = init.mat((2 * cfg.d_model, cfg.d_model))
            self.mtp_block = Block(cfg, init, decoder_kind(cfg))
            self.register_parameter("mtp_norm", norm())


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """The model's parameters, drawn from `seed` on `device` (the card
    unless given; raises without one)."""
    return LM(cfg, seed, device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    """A zeroed decode cache in the model's dtype unless given, on `device`
    (the card unless given; "meta" for shapes only), stacked per layer as
    the JAX package's `init_cache`.  Attention: {"k", "v"} each (L, batch,
    C, KV, hd), C = min(cache_len, window) with a window, and with a window
    shorter than cache_len also "pos" (L, batch, C) int32 filled with -1
    (the ring); with MLA {"lat": (L, batch, cache_len, kv_lora + rope)}.
    By family:
    - dense, moe, vlm: {"layers": attention's};
    - ssm: {"layers": {"conv" (L, batch, d_conv - 1, din + 2N), "state"
      (L, batch, H, P, N) fp32}};
    - hybrid: {"super": {"rec<i>": {"conv" (nb, batch, conv_width - 1, W),
      "h" (nb, batch, W) fp32}, "attn<i>": attention's at
      `cfg.rglru.window`}, "tail": rec's (rem, ...) with a tail};
    - encdec: {"dec": {"self": attention's, "cross_k", "cross_v" (L,
      batch, encoder_seq, KV, hd)}}."""
    check_ported(cfg)
    dev = resolve_device(device)
    dt = dtype or _dt(cfg)
    KV, hd, D = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attn(n: int, window) -> dict:
        C = min(cache_len, window) if window else cache_len
        c = {"k": zeros(n, batch, C, KV, hd), "v": zeros(n, batch, C, KV, hd)}
        if window and cache_len > window:
            c["pos"] = torch.full((n, batch, C), -1, dtype=torch.int32, device=dev)
        return c

    L = cfg.num_layers
    if cfg.family == "ssm":
        s = cfg.ssm
        din = s.expand * D
        return {"layers": {"conv": zeros(L, batch, s.d_conv - 1, din + 2 * s.d_state),
                           "state": zeros(L, batch, din // s.head_dim, s.head_dim, s.d_state,
                                          dtype=torch.float32)}}
    if cfg.family == "hybrid":
        r = cfg.rglru
        W = r.lru_width or D
        nb, rem = divmod(L, len(r.pattern))

        def rec(n: int) -> dict:
            return {"conv": zeros(n, batch, r.conv_width - 1, W),
                    "h": zeros(n, batch, W, dtype=torch.float32)}

        out = {"super": {f"{k}{i}": rec(nb) if k == "rec" else attn(nb, r.window)
                         for i, k in enumerate(r.pattern)}}
        if rem:
            out["tail"] = rec(rem)
        return out
    if cfg.family == "encdec":
        cross = (L, batch, cfg.encoder_seq, KV, hd)
        return {"dec": {"self": attn(L, None), "cross_k": zeros(*cross),
                        "cross_v": zeros(*cross)}}
    if cfg.mla is not None:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return {"layers": {"lat": zeros(L, batch, cache_len, width)}}
    return {"layers": attn(L, cfg.window)}


def embed(cfg: ModelConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings times sqrt(d_model), the factor rounded to the
    model's dtype first (JAX's weak-typed scalar; a 0-d host tensor, which
    a kernel on the card takes as a scalar, without a copy).  A lookup
    (on a mesh, a vocab-sharded table is looked up where its rows lie and
    the rows summed over 'model': `spmd.embedding`)."""
    dt = _dt(cfg)
    w = spmd.use(cfg, params.tok_embed)
    return spmd.embedding(tokens, w).to(dt) * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)


def unembed(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    w = spmd.use(cfg, params.tok_embed).T if cfg.tie_embeddings else spmd.use(cfg,
                                                                              params.out_head)
    return spmd.matmul(x, w)


def _remat(cfg: ModelConfig, params: LM, cache: dict | None) -> bool:
    """Whether a forward recomputes its blocks in the backward: when it
    records a graph through trainable parameters, without a cache, and
    `cfg.remat` asks for it."""
    if cache is not None or not torch.is_grad_enabled() or not params.tok_embed.requires_grad:
        return False
    if cfg.remat not in ("none", "block", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return cfg.remat != "none"


def _dots_policy(ctx, op, *args, **kwargs):
    """`checkpoint_dots_with_no_batch_dims`: save a product without batch
    dims (`aten.mm`), recompute everything else."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(cfg: ModelConfig, block, *args):
    """`block(*args)` recomputed in the backward: whole ("block", "full"),
    or all but its `aten.mm` outputs ("dots")."""
    if cfg.remat == "dots":
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _dots_policy))
    return checkpoint(block, *args, use_reentrant=False)


def _layer(cache, i: int):
    """Layer i's entries of a stacked cache (views: written in place)."""
    if cache is None or isinstance(cache, torch.Tensor):
        return None if cache is None else cache[i]
    return {name: _layer(t, i) for name, t in cache.items()}


def _run_stack(params: LM, blocks, x: torch.Tensor, positions: torch.Tensor,
               cache: dict | None, cache_pos: int, enc_out: torch.Tensor | None = None):
    """x after each block of `blocks` in turn, layer i reading and writing
    layer i of the stacked `cache`; and the summed aux loss of the MoE
    layers (0-d fp32), or None without MoE."""
    cfg = params.cfg
    remat = _remat(cfg, params, cache)
    aux = None
    if cache is None:
        x = _constrain_act(x)
    for i, block in enumerate(blocks):
        if remat:
            x, a = _checkpoint(cfg, block, x, positions, None, cache_pos, enc_out)
        else:
            x, a = block(x, positions, _layer(cache, i), cache_pos, enc_out)
        x = _constrain_act(x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _run_hybrid(params: LM, x: torch.Tensor, positions: torch.Tensor, cache: dict | None,
                cache_pos: int) -> torch.Tensor:
    """The hybrid family's blocks: each super-block's in pattern order, then
    the tail's."""
    remat = _remat(params.cfg, params, cache)
    for j, sup in enumerate(params.super):
        for name, block in sup.items():
            if remat:
                x, _ = _checkpoint(params.cfg, block, x, positions, None, cache_pos)
            else:
                x, _ = block(x, positions, None if cache is None else _layer(cache["super"][name], j),
                             cache_pos)
    if hasattr(params, "tail"):
        x, _ = _run_stack(params, params.tail, x, positions,
                          None if cache is None else cache["tail"], cache_pos)
    return x


def _positions(B: int, S: int, start: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S) + start


def forward(cfg: ModelConfig, params: LM, batch: dict, cache: dict | None = None,
            cache_pos: int = 0):
    """Full-sequence forward (prefill): batch["tokens"] (B, S); for encdec
    batch["frames"] (B, Se, D), the encoder's input (run non-causal, RoPE
    on the frame positions 0 ... Se - 1); for vlm batch["patches"] (B, P,
    D), prepended to the token embeddings, positions 0 ... P + S - 1 (from
    0 whatever cache_pos, as the JAX package).  With a cache, the positions
    [cache_pos, cache_pos + S) (+ P) are written into it in place, and an
    encdec prefill writes the cross attention's k and v.  Returns (hidden
    (B, S (+ P), D), the MoE layers' summed aux loss (0-d fp32; 0.0
    without MoE), cache)."""
    tokens = batch["tokens"]
    with spmd.on_mesh(tokens):
        return _forward(cfg, params, batch, cache, cache_pos)


def _forward(cfg: ModelConfig, params: LM, batch: dict, cache: dict | None, cache_pos: int):
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = embed(cfg, params, tokens)
    positions = spmd.like(_positions(B, S, cache_pos, dev), tokens)
    aux = None
    if cfg.family == "encdec":
        enc_x = batch["frames"].to(_dt(cfg))
        pe = spmd.like(_positions(B, enc_x.shape[1], 0, dev), tokens)
        enc_out, _ = _run_stack(params, params.enc, enc_x, pe, None, 0)
        enc_out = ly.norm(cfg, params.enc_norm, enc_out)
        x, aux = _run_stack(params, params.dec, x, positions,
                            None if cache is None else cache["dec"], cache_pos, enc_out)
    elif cfg.family == "hybrid":
        x = _run_hybrid(params, x, positions, cache, cache_pos)
    else:
        if cfg.family == "vlm" and "patches" in batch:
            x = torch.cat([batch["patches"].to(_dt(cfg)), x], dim=1)
            positions = spmd.like(_positions(B, x.shape[1], 0, dev), tokens)
        x, aux = _run_stack(params, params.layers, x, positions,
                            None if cache is None else cache["layers"], cache_pos)
    x = ly.norm(cfg, params.final_norm, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, cache


def decode_step(cfg: ModelConfig, params: LM, cache: dict, tokens: torch.Tensor, pos: int):
    """One decode step: tokens (B, 1) at absolute position `pos` (for vlm,
    past its patch prefix: P + the token's index), attending over the
    cache, which it updates in place (encdec: cross attention over the
    prefill's cross_k / cross_v).  Returns (logits (B, vocab) fp32,
    cache)."""
    B = tokens.shape[0]
    with spmd.on_mesh(tokens):
        x = embed(cfg, params, tokens)
        positions = spmd.like(torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device),
                              tokens)
        if cfg.family == "hybrid":
            x = _run_hybrid(params, x, positions, cache, pos)
        else:
            root = "dec" if cfg.family == "encdec" else "layers"
            x, _ = _run_stack(params, getattr(params, root), x, positions, cache[root], pos)
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
    hidden = spmd.whole_tokens(hidden)       # on a mesh: gathered once, not a chunk at a time
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        logits = unembed(cfg, params, hidden[:, c0:c0 + chunk]).float()
        t = targets[:, c0:c0 + chunk].long()
        tok_nll = spmd.vocab_parallel_nll(logits.reshape(-1, logits.shape[-1]), t.reshape(-1))
        if tok_nll is None:
            lse = torch.logsumexp(logits, dim=-1)
            tok_nll = lse - torch.gather(logits, -1, t[..., None])[..., 0]
        else:
            tok_nll = tok_nll.view(t.shape)
        m = mask[:, c0:c0 + chunk]
        nll = nll + (tok_nll * m).sum()
        cnt = cnt + m.sum()
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params: LM, batch: dict):
    """Next-token cross-entropy of batch["tokens"] (B, S), each position
    predicting the next (the last position masked), times batch["mask"]
    where given, plus 0.01 times the MoE layers' summed aux loss (0
    without MoE).  The vlm family's hidden states at its patch positions
    (batch["patches"], prepended by `forward`) are dropped first, as the
    JAX package drops them: only tokens are predicted.  With
    `cfg.mtp_depth`, also 0.3 times the multi-token-prediction
    cross-entropy, as the JAX package computes it:
    the final hidden states beside the embeddings of the next tokens,
    through `mtp_proj`, `mtp_block` (no cache, no remat; its aux loss is
    dropped) and `mtp_norm`, each position predicting the token two ahead
    (the last two positions masked).  Returns (loss, {"ce", "aux"} and
    "mtp" with the head), 0-d fp32 tensors."""
    with spmd.on_mesh(batch["tokens"]):
        return _loss_fn(cfg, params, batch)


def _loss_fn(cfg: ModelConfig, params: LM, batch: dict):
    tokens = batch["tokens"]
    hidden, aux, _ = forward(cfg, params, batch)
    if cfg.family == "vlm" and "patches" in batch:
        hidden = hidden[:, batch["patches"].shape[1]:]
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    mask = spmd.like(mask, tokens)
    if "mask" in batch:
        mask = mask * batch["mask"]
    ce = chunked_ce(cfg, params, hidden, targets, mask)
    loss, metrics = ce + 0.01 * aux, {"ce": ce, "aux": aux}
    if cfg.mtp_depth:
        B, S = tokens.shape
        h = ly.dense(torch.cat([hidden, embed(cfg, params, targets)], dim=-1),
                     spmd.use(cfg, params.mtp_proj))
        h, _ = params.mtp_block(h, spmd.like(_positions(B, S, 0, tokens.device), tokens), None, 0)
        h = ly.norm(cfg, params.mtp_norm, h)
        t2 = torch.cat([tokens[:, 2:], tokens[:, :2]], dim=1)
        m2 = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
        m2[:, -2:] = 0.0
        m2 = spmd.like(m2, tokens) * mask
        mtp = chunked_ce(cfg, params, h, t2, m2)
        loss, metrics["mtp"] = loss + 0.3 * mtp, mtp
    return loss, metrics
