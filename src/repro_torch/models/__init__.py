"""The LM family of the port: configs, layers and the dense decoder, with its
training loss.

Exports what the JAX package's `repro.models` does."""

from .config import (MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SHAPES, ShapeConfig,
                     SSMConfig, reduced)
from .lm import decode_step, forward, init_cache, init_params, loss_fn

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RGLRUConfig",
    "ShapeConfig", "SHAPES", "reduced",
    "init_params", "init_cache", "forward", "decode_step", "loss_fn",
]
