"""Batched element ops: the one seam through which the forest reaches the
element math (counterpart of `BatchedOps` in the JAX package's
`repro.core.batch`).

Every method takes a `Simplex` (or keys) of shape (n,) on one device and goes
to the wrapper in `kernels.ops`, which launches the CUDA kernel for CUDA
tensors and runs the plain PyTorch version for CPU tensors.  There is no
backend knob: the device decides.  Outputs stay on the inputs' device.

`dispatch_counts()` counts calls per op since `reset_dispatch_counts()`,
whatever the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from .keys import to_u64
from .types import ECLASS_SIMPLEX, Simplex

__all__ = ["BatchedOps", "get_batch_ops", "dispatch_counts", "reset_dispatch_counts"]

_dispatch_counts: dict[str, int] = {}


def reset_dispatch_counts() -> None:
    """Zero the per-op dispatch counters."""
    _dispatch_counts.clear()


def dispatch_counts() -> dict[str, int]:
    """Snapshot of {op name: number of BatchedOps calls} since reset."""
    return dict(_dispatch_counts)


def _count(name: str) -> None:
    _dispatch_counts[name] = _dispatch_counts.get(name, 0) + 1


class BatchedOps:
    """Batched element ops over `Simplex` tensors of shape (n,)."""

    def __init__(self, d: int, eclass: int = ECLASS_SIMPLEX):
        self.d = d
        self.eclass = eclass

    def morton_key(self, s: Simplex) -> torch.Tensor:
        """Level-padded consecutive index (the mixed-level SFC sort key), int64."""
        _count("morton_key")
        return kops.morton_key(s.anchor, s.stype)

    def morton_key_np(self, s: Simplex) -> np.ndarray:
        """Host uint64 keys (the JAX package's forest key format)."""
        return to_u64(self.morton_key(s))

    def decode(self, key: torch.Tensor, level: torch.Tensor) -> Simplex:
        """Algorithm 4.8 from a level-padded key (inverse of `morton_key`)."""
        _count("decode")
        level = level.to(torch.int32)
        anchor, stype = kops.decode(self.d, key, level)
        return Simplex(anchor, level, stype)

    def parent(self, s: Simplex) -> Simplex:
        """Algorithm 4.3."""
        _count("parent")
        anchor, level, stype, _ = kops.parent(s.anchor, s.level, s.stype)
        return Simplex(anchor, level, stype)

    def parent_and_local_index(self, s: Simplex):
        """Algorithm 4.3 + Table 6 in one pass: (parent, TM child index) —
        the pair every family scan needs together."""
        _count("parent_and_local_index")
        anchor, level, stype, iloc = kops.parent(s.anchor, s.level, s.stype)
        return Simplex(anchor, level, stype), iloc

    def children(self, s: Simplex) -> Simplex:
        """All 2^d children in TM order: batch shape (n, 2^d)."""
        _count("children")
        return Simplex(*kops.children(s.anchor, s.level, s.stype))


_BOPS: dict = {}


def get_batch_ops(d: int, eclass: int = ECLASS_SIMPLEX) -> BatchedOps:
    """The batched element ops for dimension `d` and element class `eclass`."""
    b = _BOPS.get((d, eclass))
    if b is None:
        b = _BOPS[(d, eclass)] = BatchedOps(d, eclass)
    return b
