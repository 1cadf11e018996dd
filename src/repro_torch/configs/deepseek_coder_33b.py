"""deepseek-coder-33b [dense] — llama-architecture GQA decoder.
[arXiv:2401.14196; hf]

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""

from ..models.config import ModelConfig

ARCH = "deepseek-coder-33b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=62,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        head_dim=128,
        remat="block",
        fsdp=True,
        # fsdp, parallelism and num_micro_override are the JAX package's
        # training-layout choices, kept as data; the port reads none yet.
        parallelism="fsdp_sp",
        num_micro_override=8,
    )
