"""The paper's weighted Partition rule (Sec. 5) in its host numpy form.

Counterpart of `target_ranks_np` in the JAX package's `repro.core.placement`.
Prefix sums stay float64 on the host, in numpy's sequential order: a parallel
cumulative sum on the card rounds differently and would move rank
boundaries.  The owner rank of a key against the partition markers is
`BatchedOps.owner_rank` (kernel `owner_rank`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["target_ranks_np"]


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
