"""Structured errors of the port's wire codecs.

A dependency-free module so the element wire format (`core.types`) and the
payload codec (`core.comm`) raise the same exception types as the JAX
package's `repro.core.errors`, without import cycles.  `not_ported` builds
the error for a feature of the JAX package that a later port slice brings.
"""

from __future__ import annotations

__all__ = ["ResilienceError", "WireFormatError", "not_ported"]


class ResilienceError(RuntimeError):
    """Base class of every structured fault-path error."""


class WireFormatError(ResilienceError, ValueError):
    """A wire buffer is not a well-formed payload.

    Raised by `core.comm.decode_payload` and `core.types.unpack_wire` for
    truncated, trailing-garbage, or structurally invalid buffers — never a
    bare `struct.error`, `KeyError`, or a silently misaligned column
    decode."""


# The later slices of the port, in the order ROADMAP.md queues them.
SLICES = {
    "hex": 4,              # the hex element class
}


def not_ported(what: str, area: str) -> NotImplementedError:
    """The error for `what`, a feature of the JAX package that the port
    brings in the slice ROADMAP.md queues for `area`."""
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet: it comes with port slice "
        f"{SLICES[area]} (see ROADMAP.md)")
