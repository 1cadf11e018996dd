"""pixtral-12b [vlm] — mistral-nemo backbone; the pixtral ViT frontend is a
STUB (input_specs supplies precomputed patch embeddings (B, P, d_model)).
[hf:mistralai/Pixtral-12B-2409; unverified]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
Shapes: seq_len counts patches + text; we use 1024 patch positions.
"""

from ..models.config import ModelConfig

ARCH = "pixtral-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        head_dim=128,
        num_patches=1024,
        rope_theta=1e6,
        remat="block",
        fsdp=True,
    )
