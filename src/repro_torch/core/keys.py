"""Level-padded SFC keys as native int64.

A key holds d * MAXLEVEL <= 63 bits (60 for triangles, 63 for tetrahedra),
so it is never negative as an int64 and orders like the JAX package's uint64
keys.  That package carries keys as uint64 numpy arrays on the host and as
(hi, lo) uint32 word pairs on the device; these helpers convert between the
three forms.  No pair arithmetic is needed on this side.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_u64", "from_u64", "to_pair", "from_pair", "span_exponent", "span_mask"]

_LO_MASK = np.uint64(0xFFFFFFFF)


def to_u64(key: torch.Tensor) -> np.ndarray:
    """int64 key tensor -> host uint64 array (the JAX forest's key column)."""
    return key.detach().cpu().numpy().astype(np.uint64)


def from_u64(key, device) -> torch.Tensor:
    """uint64 keys (array or Python ints) -> int64 key tensor on `device`.
    Keys of 64 bits do not occur (at most 63), and are refused."""
    k = np.asarray(key, np.uint64)
    if k.size and int(k.max()) >> 63:
        raise ValueError("key does not fit 63 bits")
    return torch.from_numpy(k.astype(np.int64)).to(device)


def to_pair(key: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 key tensor -> host (hi, lo) uint32 words."""
    k = to_u64(key)
    return (k >> np.uint64(32)).astype(np.uint32), (k & _LO_MASK).astype(np.uint32)


def from_pair(hi, lo, device) -> torch.Tensor:
    """(hi, lo) uint32 words -> int64 key tensor on `device`."""
    k = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    return from_u64(k, device)


def span_exponent(d: int, L: int, level: torch.Tensor) -> torch.Tensor:
    """d*(L - level): the base-2 width of an element's key interval, int64,
    clamped to [0, 63].  The width itself, 2^63 at d = 3 and level 0, does
    not fit an int64; compare `(b - a) >> exponent` rather than a + width."""
    return (d * (L - level.to(torch.int64))).clamp(0, 63)


def span_mask(d: int, L: int, level: torch.Tensor) -> torch.Tensor:
    """2^(d*(L - level)) - 1 as int64: the offset of the last key of an
    element's key interval (keys are span aligned, so the interval of key k
    is [k, k | span_mask]).  Callers bound intervals by their last key and
    never compute k + span."""
    sb = span_exponent(d, L, level)
    return torch.bitwise_right_shift(torch.full_like(sb, (1 << 63) - 1), 63 - sb)
