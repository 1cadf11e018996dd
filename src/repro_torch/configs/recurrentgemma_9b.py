"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, pattern 1 attn : 2
recurrent.  [arXiv:2402.19427; unverified]

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048.
38 = 12 x (rec, rec, attn) + 2 trailing recurrent blocks.
"""

from ..models.config import ModelConfig, RGLRUConfig

ARCH = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        head_dim=256,
        rglru=RGLRUConfig(lru_width=4096, conv_width=4, window=2048,
                          pattern=("rec", "rec", "attn")),
        remat="block",
        fsdp=True,
    )
