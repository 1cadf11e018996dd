"""qwen3-1.7b [dense] — qk-norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
"""

from ..models.config import ModelConfig

ARCH = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=6144,
        vocab_size=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
        remat="block",
    )
