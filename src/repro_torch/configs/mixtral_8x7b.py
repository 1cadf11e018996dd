"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

32L d_model=4096 32H (GQA kv=8) d_ff(expert)=14336 vocab=32000, window 4096.
"""

from ..models.config import ModelConfig, MoEConfig

ARCH = "mixtral-8x7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        head_dim=128,
        window=4096,
        rope_theta=1e6,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
        remat="block",
        fsdp=True,
    )
