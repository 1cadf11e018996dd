"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

24L d_model=768 vocab=50280, d_state=128, expand=2, head_dim=64.
"""

from ..models.config import ModelConfig, SSMConfig

ARCH = "mamba2-130m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=24,          # d_inner / head_dim (bookkeeping only)
        num_kv_heads=24,
        d_ff=0,
        vocab_size=50280,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        remat="block",
    )
