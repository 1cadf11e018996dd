"""phi3-mini-3.8b [dense] — RoPE + SwiGLU + GQA (kv == heads).
[arXiv:2404.14219; unverified]

32L d_model=3072 32H d_ff=8192 vocab=32064.
"""

from ..models.config import ModelConfig

ARCH = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        remat="block",
    )
