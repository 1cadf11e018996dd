"""Structured errors of the port's wire codecs and forest checkpoints.

A dependency-free module so the element wire format (`core.types`), the
payload codec (`core.comm`) and the forest checkpoints
(`checkpoint.forest_io`) raise the same exception types as the JAX
package's `repro.core.errors`, without import cycles.
"""

from __future__ import annotations

__all__ = ["ResilienceError", "WireFormatError", "CheckpointIntegrityError"]


class ResilienceError(RuntimeError):
    """Base class of every structured fault-path error."""


class WireFormatError(ResilienceError, ValueError):
    """A wire buffer is not a well-formed payload.

    Raised by `core.comm.decode_payload` and `core.types.unpack_wire` for
    truncated, trailing-garbage, or structurally invalid buffers — never a
    bare `struct.error`, `KeyError`, or a silently misaligned column
    decode."""


class CheckpointIntegrityError(ResilienceError):
    """A forest checkpoint is unreadable, corrupted, or invalid on restore.

    Raised by `checkpoint.forest_io.load_forest` when a payload blob is
    truncated/garbage, a stored CRC32 disagrees with the bytes on disk, the
    element count contradicts the manifest, or the restored global forest
    fails `forest.validate`."""
