"""Architecture registry, the port's copy of the JAX package's
`repro.configs`.

`get_config(arch)` returns the architecture's `ModelConfig`, `get_shape`
a benchmark `ShapeConfig`, and `cell_supported` whether an (arch, shape)
cell runs: long_500k only for sub-quadratic archs (SSM / hybrid /
sliding-window).  `input_specs` gives `meta`-device stand-ins of a cell's
model inputs (the JAX package's `jax.ShapeDtypeStruct`s: shapes and dtypes,
no memory), which the dry run (`launch.dryrun`) and the roofline take;
`all_cells` lists the 40 (arch, shape) cells with their support status.
"""

from __future__ import annotations

import torch

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


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype: torch.dtype = torch.bfloat16):
    """Stand-ins on the `meta` device for the model inputs of this cell.

    train/prefill: the token batch (B, S) int32, with the encdec family's
    frames (B, encoder_seq, d_model) or the vlm family's patches (B, P,
    d_model), P = min(num_patches, S // 2), and then S - P tokens, in
    `dtype`; decode: one token a sequence (B, 1) (the cache's stand-ins
    come from `launch.serve.abstract_cache`)."""
    B, S = shape.global_batch, shape.seq_len

    def spec(*dims, dt=torch.int32):
        return torch.empty(dims, dtype=dt, device="meta")

    if shape.mode in ("train", "prefill"):
        if cfg.family == "encdec":
            return {"tokens": spec(B, S), "frames": spec(B, cfg.encoder_seq, cfg.d_model, dt=dtype)}
        if cfg.family == "vlm":
            P = min(cfg.num_patches, S // 2)
            return {"tokens": spec(B, S - P), "patches": spec(B, P, cfg.d_model, dt=dtype)}
        return {"tokens": spec(B, S)}
    return {"tokens": spec(B, 1)}


def all_cells():
    """Every (arch, shape name, supported, reason) of the 40 cells."""
    out = []
    for a in ARCH_NAMES:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = cell_supported(cfg, s)
            out.append((a, s.name, ok, why))
    return out


__all__ = ["ARCHS", "ARCH_NAMES", "get_config", "get_shape", "cell_supported", "input_specs",
           "all_cells", "SHAPES", "reduced"]
