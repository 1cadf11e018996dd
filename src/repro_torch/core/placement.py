"""The paper's weighted Partition rule (Sec. 5), for the forest and for LM
workloads.

Counterpart of the JAX package's `repro.core.placement`: the rule —
*weighted, contiguous splitting of a totally ordered item set in linear
time* — in its host numpy form over global prefix sums (`target_ranks_np`,
which `forest.repartition` and the weighted checkpoint restore route
through), and on tensors for LM workloads:

  1. MoE expert placement: experts ordered along the curve, partitioned onto
     devices by measured token load (`expert_placement`).
  2. Token/document packing: variable-length documents assigned to data-
     parallel ranks with balanced token counts (`document_partition`).
  3. KV-page layout: paged-attention block tables laid out in SFC order so
     consecutive pages of one request stay local (`page_order`).

The tensor functions compute on their input's device (host data goes to
the card unless the caller passes `device="cpu"`), in the reference's dtypes:
float32 prefix sums, int32 ranks.  A float32 cumulative sum adds in another
order on each backend, so a target rank can differ from the JAX package's
by one where `cum * P / total` lies within rounding of an integer; the
forest's own rule (`target_ranks_np`) stays float64 on the host, in numpy's
sequential order, so its rank boundaries equal the reference's.  The owner
rank of a key against the partition markers is `BatchedOps.owner_rank`
(kernel `owner_rank`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .types import resolve_device

__all__ = [
    "target_ranks",
    "target_ranks_np",
    "partition_offsets",
    "expert_placement",
    "document_partition",
    "page_order",
    "imbalance",
]


def _as(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """`x` as a `dtype` tensor: a tensor on its own device unless `device`
    is given, host data on `device` (the card by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(x.device if device is None else torch.device(device), dtype)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device)).to(dtype)


def target_ranks(weights, num_ranks: int, device=None) -> torch.Tensor:
    """Paper's Partition rule, vectorized: item i (in curve order) goes to rank
    floor(P * (W_{<i} + w_i/2) / W_total), clipped and made monotone.

    weights: (n,) nonnegative. Returns int32 (n,) target ranks, ascending.
    """
    w = _as(weights, torch.float32, device)
    cum = torch.cumsum(w, 0) - w / 2.0
    total = torch.clamp(w.sum(), min=1e-30)
    t = torch.floor(cum * (num_ranks / total)).to(torch.int32)
    t = torch.clamp(t, 0, num_ranks - 1)
    # cumulative max keeps assignment contiguous under zero-weight runs
    return torch.cummax(t, 0).values


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


def partition_offsets(weights, num_ranks: int, device=None) -> torch.Tensor:
    """(P+1,) int32 split offsets such that rank p owns items [off[p], off[p+1])."""
    t = target_ranks(weights, num_ranks, device)
    counts = torch.bincount(t.long(), minlength=num_ranks).to(torch.int32)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])


def imbalance(weights, t, num_ranks: int, device=None) -> torch.Tensor:
    """max rank load / mean rank load (1.0 = perfect), a float32 scalar."""
    w = _as(weights, torch.float32, device)
    t = _as(t, torch.int64, w.device)
    loads = torch.zeros(num_ranks, dtype=torch.float32, device=w.device).index_add_(0, t, w)
    return loads.max() / torch.clamp(loads.mean(), min=1e-30)


def expert_placement(expert_load, num_devices: int, device=None):
    """Contiguous expert->device map balancing measured token load.

    expert_load: (E,) tokens routed to each expert over a window.
    Returns (device_of_expert (E,), imbalance scalar).  Contiguity along the
    expert order keeps the all-to-all pattern block-structured (each device
    sends to a contiguous device range), exactly the property the SFC
    partition gives mesh elements in the paper.
    """
    w = _as(expert_load, torch.float32, device)
    t = target_ranks(w, num_devices)
    return t, imbalance(w, t, num_devices)


def document_partition(doc_tokens, num_ranks: int, device=None):
    """Assign documents (in corpus order) to DP ranks with balanced tokens.

    Returns (rank_of_doc, imbalance).  Linear time, order preserving —
    the data-pipeline analogue of partitioning mesh elements by weight.
    """
    w = _as(doc_tokens, torch.float32, device)
    t = target_ranks(w, num_ranks)
    return t, imbalance(w, t, num_ranks)


def _interleave_bits_2d(x: torch.Tensor, y: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(x)
    for i in range(bits):
        out = out | (((x >> i) & 1) << (2 * i)) | (((y >> i) & 1) << (2 * i + 1))
    return out


def page_order(num_pages_per_req: int, num_requests: int, device=None) -> torch.Tensor:
    """SFC (Morton) traversal order of the (request, page) grid for paged-KV
    block tables: consecutive pages of one request map to nearby physical
    blocks, and co-scheduled requests stay clustered.

    Returns int32 (num_requests, num_pages_per_req) physical order ranks.
    """
    dev = resolve_device(device)
    r = torch.arange(num_requests, dtype=torch.int32, device=dev)[:, None]
    p = torch.arange(num_pages_per_req, dtype=torch.int32, device=dev)[None, :]
    bits = max(math.ceil(math.log2(max(num_requests, 2))),
               math.ceil(math.log2(max(num_pages_per_req, 2))))
    key = _interleave_bits_2d(p.expand(num_requests, num_pages_per_req),
                              r.expand(num_requests, num_pages_per_req), bits)
    flat = key.reshape(-1)
    rank = torch.argsort(torch.argsort(flat, stable=True), stable=True).to(torch.int32)
    return rank.reshape(num_requests, num_pages_per_req)
