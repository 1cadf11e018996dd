"""The LM family of the port: configs, layers and the dense decoder.

Exports what the JAX package's `repro.models` does, except `loss_fn`,
which belongs to the training slice (ROADMAP.md §1, slice 7)."""

from .config import (MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SHAPES, ShapeConfig,
                     SSMConfig, reduced)
from .lm import decode_step, forward, init_cache, init_params

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RGLRUConfig",
    "ShapeConfig", "SHAPES", "reduced",
    "init_params", "init_cache", "forward", "decode_step",
]
