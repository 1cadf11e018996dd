"""The LM family of the port: configs, layers and the LM of every family,
with the dense family's training loss.

Exports what the JAX package's `repro.models` does."""

from .config import (MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SHAPES, ShapeConfig,
                     SSMConfig, reduced)
from .lm import decode_step, forward, init_cache, init_params, loss_fn

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RGLRUConfig",
    "ShapeConfig", "SHAPES", "reduced",
    "init_params", "init_cache", "forward", "decode_step", "loss_fn",
]
