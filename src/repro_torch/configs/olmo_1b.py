"""olmo-1b [dense] — non-parametric LayerNorm, tied embeddings.
[arXiv:2402.00838; hf]

16L d_model=2048 16H d_ff=8192 vocab=50304.
"""

from ..models.config import ModelConfig

ARCH = "olmo-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        nonparametric_norm=True,
        tie_embeddings=True,
        remat="block",
    )
