"""Checkpoints of the port: the JAX package's gathered layout (`store`, with
bfloat16 leaves and the async writer) and forest checkpoints (`forest_io`),
byte for byte."""

from .store import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
from .forest_io import load_forest, save_forest

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer",
           "save_forest", "load_forest"]
