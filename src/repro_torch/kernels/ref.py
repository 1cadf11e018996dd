"""Plain PyTorch versions of the CUDA kernels, delegating to `core.ops`.

Same signatures and outputs as the wrappers in `kernels.ops`; they run on the
tensors' own device.  The wrappers call them for CPU tensors, the tests hold
them against the JAX package, and `chip_smoke.py` holds the kernels against
them on the card.  `call_counts` counts calls per function.
"""

from __future__ import annotations

import torch

from ..core.ops import get_ops
from ..core.types import Simplex

__all__ = ["morton_key", "decode", "parent", "children", "call_counts",
           "reset_call_counts"]

call_counts: dict[str, int] = {"morton_key": 0, "decode": 0, "parent": 0, "children": 0}


def reset_call_counts() -> None:
    for k in call_counts:
        call_counts[k] = 0


def morton_key(anchor: torch.Tensor, stype: torch.Tensor) -> torch.Tensor:
    """(n, d) anchor, (n,) type -> (n,) int64 level-padded keys.  The level
    plays no role in the padded key (the T_0-chain digits below an element's
    level are zero), so the key is evaluated at MAXLEVEL."""
    call_counts["morton_key"] += 1
    o = get_ops(anchor.shape[-1])
    level = torch.full_like(stype, o.L)
    return o.morton_key(Simplex(anchor, level, stype))


def decode(d: int, key: torch.Tensor, level: torch.Tensor):
    """(n,) int64 keys and int32 levels -> (anchor (n, d), type (n,))."""
    call_counts["decode"] += 1
    s = get_ops(d).decode_key(key, level)
    return s.anchor, s.stype


def parent(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """-> (parent anchor, parent level, parent type, local index)."""
    call_counts["parent"] += 1
    o = get_ops(anchor.shape[-1])
    s = Simplex(anchor, level, stype)
    p = o.parent(s)
    return p.anchor, p.level, p.stype, o.local_index(s)


def children(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """-> all 2^d children in SFC order: anchor (n, 2^d, d), level and type
    (n, 2^d)."""
    call_counts["children"] += 1
    kids = get_ops(anchor.shape[-1]).children_tm(Simplex(anchor, level, stype))
    return kids.anchor, kids.level, kids.stype
