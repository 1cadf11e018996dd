"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 experts, MTP.
[arXiv:2412.19437; hf]

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
Note (DESIGN.md): the real model keeps the first 3 layers dense; we model all
layers as MoE (uniform scan stack).  Training memory uses adafactor +
bf16 states + FSDP — Adam-f32 on 671B params does not fit 256 x 16 GB.
"""

from ..models.config import MLAConfig, ModelConfig, MoEConfig

ARCH = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        d_ff=2048,
        vocab_size=129280,
        moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared=1,
                      capacity_factor=1.25),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        mtp_depth=1,
        remat="block",
        optimizer="adafactor",
        opt_state_dtype="bfloat16",
        grad_acc_dtype="bfloat16",
        fsdp=True,
        # the JAX package's microbatch count, kept as data.
        num_micro_override=4,
    )
