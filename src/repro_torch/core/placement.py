"""The paper's weighted Partition rule (Sec. 5) in its host numpy form, and
the owner rank of a key against the partition markers.

Counterpart of `target_ranks_np` in the JAX package's `repro.core.placement`.
Prefix sums stay float64 on the host, in numpy's sequential order: a parallel
cumulative sum on the card rounds differently and would move rank
boundaries.  `owner_rank` is the marker compare-and-count of the JAX
package's `owner_rank_lex` (`repro.core.batch`), on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["target_ranks_np", "owner_rank"]


def target_ranks_np(cum_mid: np.ndarray, num_ranks: int,
                    total: float) -> np.ndarray:
    """Target rank of every element from its *global* midpoint prefix sum
    `cum_mid[i] = W_{<i} + w_i/2` (W_{<i} counts every element before i on
    ANY rank) and the world weight sum `total`: floor(P * cum_mid / total),
    clipped to [0, P), made monotone by a cumulative max so each destination
    rank's elements form one contiguous run.

    Every rank evaluating its own slice reproduces exactly the assignment a
    single rank would compute over the concatenated weights.  Returns int64
    (n,) ascending target ranks."""
    cum = np.asarray(cum_mid, np.float64)
    t = np.minimum((cum * num_ranks / max(total, 1e-300)).astype(np.int64),
                   num_ranks - 1)
    t = np.maximum(t, 0)
    return np.maximum.accumulate(t)


def owner_rank(tree: torch.Tensor, key: torch.Tensor, marker_tree: torch.Tensor,
               marker_key: torch.Tensor) -> torch.Tensor:
    """The rank whose partition range [marker_r, marker_{r+1}) holds each
    lex (tree, key): the number of the P markers lex-<= it, less one,
    clamped to 0 (keys before the first marker go to rank 0).  int32, the
    shape of `tree`; all tensors on one device.  The (query, marker)
    comparison matrix is built a slice of queries at a time, so memory
    stays bounded at any P."""
    t, k = tree.reshape(-1, 1), key.reshape(-1, 1)
    step = max(1, _PAIRS_PER_SLICE // max(marker_tree.shape[0], 1))
    out = torch.empty(t.shape[0], dtype=torch.int32, device=tree.device)
    for a in range(0, t.shape[0], step):
        ts, ks = t[a:a + step], k[a:a + step]
        le = (marker_tree < ts) | ((marker_tree == ts) & (marker_key <= ks))
        out[a:a + step] = le.sum(dim=1, dtype=torch.int32)
    return (out - 1).clamp(min=0).reshape(tree.shape)


_PAIRS_PER_SLICE = 1 << 27   # query-marker comparisons held at once
