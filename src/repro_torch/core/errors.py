"""Structured errors of the port's wire codecs.

A dependency-free module so the element wire format (`core.types`) and the
payload codec (`core.comm`) raise the same exception types as the JAX
package's `repro.core.errors`, without import cycles.
"""

from __future__ import annotations

__all__ = ["ResilienceError", "WireFormatError"]


class ResilienceError(RuntimeError):
    """Base class of every structured fault-path error."""


class WireFormatError(ResilienceError, ValueError):
    """A wire buffer is not a well-formed payload.

    Raised by `core.comm.decode_payload` and `core.types.unpack_wire` for
    truncated, trailing-garbage, or structurally invalid buffers — never a
    bare `struct.error`, `KeyError`, or a silently misaligned column
    decode."""
