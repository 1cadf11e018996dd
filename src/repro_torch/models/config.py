"""Model / shape / run configuration dataclasses, the port's copy of the JAX
package's `repro.models.config` (pure data, no JAX).

Every architecture is a `ModelConfig`; the four benchmark shapes
(train_4k / prefill_32k / decode_32k / long_500k) are `ShapeConfig`s.
`reduced()` gives the family-preserving small config of the CPU tests.
Fields the port does not read yet (the training and parallelism knobs) are
kept so that a config compares equal across the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma: RG-LRU + local attention, pattern (rec, rec, attn)."""
    lru_width: int = 0           # 0 -> d_model
    conv_width: int = 4
    window: int = 2048
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    qk_norm: bool = False                   # qwen3
    nonparametric_norm: bool = False        # olmo
    window: Optional[int] = None            # sliding-window attention (mixtral)
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper): encoder consumes precomputed frame embeddings
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm (pixtral): prefix of precomputed patch embeddings
    num_patches: int = 0
    mtp_depth: int = 0                      # deepseek multi-token prediction
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training-memory knobs (per-arch defaults; the perf loop tunes these)
    remat: str = "block"                    # none | block | full
    optimizer: str = "adamw"                # adamw | adafactor
    opt_state_dtype: str = "float32"        # float32 | bfloat16
    grad_acc_dtype: str = "float32"         # microbatch gradient accumulator
    fsdp: bool = False                      # shard params over the data axis too
    num_micro_override: Optional[int] = None  # grad-accum count (None=auto)
    # "tp": megatron-style tensor parallel over 'model' (default)
    # "fsdp_sp": pure FSDP over ALL axes + sequence-parallel activations —
    #            for archs whose head counts don't divide the TP axis
    parallelism: str = "tp"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k shape? (paper-pool rule: only
        SSM / hybrid / sliding-window archs)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.window is not None
        )

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v, L = self.d_model, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        def attn_params():
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * H * qk          # q down/up
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)          # kv down
                p += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                p += H * m.v_head_dim * d                               # out
                return p
            return d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        def mlp_params(dff):
            return 3 * d * dff  # SwiGLU
        def moe_params():
            m = self.moe
            p = d * m.num_experts                                      # router
            p += m.num_experts * mlp_params(m.d_ff_expert)
            p += m.num_shared * mlp_params(m.d_ff_expert)
            return p
        if self.family == "ssm":
            s = self.ssm
            din = s.expand * d
            nh = din // s.head_dim
            per = d * (2 * din + 2 * s.d_state + nh) + din * s.d_conv + din * d + din
            n += L * per
        elif self.family == "hybrid":
            r = self.rglru
            w = r.lru_width or d
            rec = (2 * d * w + w * r.conv_width + 2 * w * w + w + w * d
                   + mlp_params(self.d_ff))
            att = attn_params() + mlp_params(self.d_ff)
            n_rec = L - L // len(r.pattern)  # 2 of 3 (+ tail)
            n_att = L // len(r.pattern)
            n += n_rec * rec + n_att * att
        else:
            per = attn_params() + (moe_params() if self.moe else mlp_params(self.d_ff))
            n += L * per
            if self.encoder_layers:
                n += self.encoder_layers * (attn_params() + mlp_params(self.d_ff))
                n += L * attn_params()  # cross attention in decoder
            if self.mtp_depth:
                n += self.mtp_depth * (2 * d * d + per)
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE uses top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff_expert
        inactive = self.num_layers * (m.num_experts - m.top_k) * per_expert
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"
    # decode shapes: one new token against a KV cache of seq_len
    microbatch: Optional[int] = None   # per-DP-rank microbatch for grad accum


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving tiny config for CPU smoke tests."""
    kw = dict(
        num_layers=min(cfg.num_layers, 2 * len(cfg.rglru.pattern) if cfg.rglru else 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
    )
    if cfg.moe:
        # capacity_factor E/k => capacity == num tokens: no drops, so smoke
        # tests can check exact prefill/decode consistency
        kw["moe"] = replace(cfg.moe, num_experts=4, top_k=2, d_ff_expert=128,
                            capacity_factor=2.0)
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
    if cfg.ssm:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.rglru:
        kw["rglru"] = replace(cfg.rglru, lru_width=128, window=64)
        kw["num_layers"] = 2 * len(cfg.rglru.pattern)
    if cfg.window:
        kw["window"] = 64
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 32
    if cfg.num_patches:
        kw["num_patches"] = 16
    return replace(cfg, **kw)
