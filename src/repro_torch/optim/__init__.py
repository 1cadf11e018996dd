"""Optimizers of the port: AdamW and Adafactor over trees of tensors, the
cosine schedule, and int8 gradient compression (counterpart of the JAX
package's `repro.optim`)."""

from .optimizers import (OptState, adafactor_update, adamw_update, apply_updates,
                         clip_by_global_norm, global_norm, init_opt_state)
from .schedule import cosine_schedule
from .compression import compress_int8, compressed_psum, decompress_int8

__all__ = [
    "OptState", "init_opt_state", "adamw_update", "adafactor_update",
    "apply_updates", "global_norm", "clip_by_global_norm", "cosine_schedule",
    "compress_int8", "decompress_int8", "compressed_psum",
]
