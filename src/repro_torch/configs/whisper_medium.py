"""whisper-medium [audio] — encoder-decoder; conv/mel frontend is a STUB
(input_specs supplies precomputed frame embeddings (B, 1500, d_model)).
[arXiv:2212.04356; unverified]

24L enc + 24L dec, d_model=1024 16H d_ff=4096 vocab=51865.
Deviation (DESIGN.md): RoPE replaces whisper's learned/sinusoidal positional
embeddings; decode_32k is a stress shape far beyond whisper's 448 positions.
"""

from ..models.config import ModelConfig

ARCH = "whisper-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="encdec",
        num_layers=24,
        encoder_layers=24,
        encoder_seq=1500,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        remat="block",
    )
