"""Architecture registry, the port's copy of the JAX package's
`repro.configs`.

`get_config(arch)` returns the architecture's `ModelConfig`, `get_shape`
a benchmark `ShapeConfig`, and `cell_supported` whether an (arch, shape)
cell runs: long_500k only for sub-quadratic archs (SSM / hybrid /
sliding-window).  The JAX package's `input_specs` and `all_cells`, which
build `jax.ShapeDtypeStruct` stand-ins for its dry-run tooling, wait for
that tooling's port (ROADMAP.md §1, item 6: the launch tooling).
"""

from __future__ import annotations

from ..models.config import SHAPES, ModelConfig, ShapeConfig, reduced
from . import (
    deepseek_coder_33b,
    deepseek_v3_671b,
    mamba2_130m,
    mixtral_8x7b,
    olmo_1b,
    phi3_mini_3_8b,
    pixtral_12b,
    qwen3_1_7b,
    recurrentgemma_9b,
    whisper_medium,
)

_MODULES = [
    deepseek_v3_671b,
    mixtral_8x7b,
    whisper_medium,
    recurrentgemma_9b,
    mamba2_130m,
    deepseek_coder_33b,
    olmo_1b,
    qwen3_1_7b,
    phi3_mini_3_8b,
    pixtral_12b,
]

ARCHS = {m.ARCH: m.config for m in _MODULES}
ARCH_NAMES = list(ARCHS.keys())


def get_config(arch: str) -> ModelConfig:
    return ARCHS[arch]()


def get_shape(shape: str) -> ShapeConfig:
    return SHAPES[shape]


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) a runnable cell?  Returns (ok, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention (skip: full attention)"
    return True, ""


__all__ = ["ARCHS", "ARCH_NAMES", "get_config", "get_shape", "cell_supported", "SHAPES",
           "reduced"]
