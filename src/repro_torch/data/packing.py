"""Document packing with SFC-balanced rank assignment (counterpart of the
JAX package's `repro.data.packing`).

Variable-length documents are packed into fixed-length rows; the
document -> data-parallel rank assignment is the paper's weighted
Partition rule (`core.placement.document_partition`), which balances token
counts across ranks in linear time while keeping corpus order.
"""

from __future__ import annotations

import numpy as np

from ..core import placement
from ..core.types import to_numpy

__all__ = ["pack_documents"]


def pack_documents(doc_lengths, seq_len: int, num_ranks: int, pad_id: int = 0, device=None):
    """(rank_of_doc int32 (n,) numpy, rows_per_rank, imbalance).

    rows_per_rank[r] is the list of (doc_id, offset, length, row, col)
    placements of rank r's documents, packed first-fit into rows of
    `seq_len`.  The assignment is computed on `device` (the card unless
    given) in float32, as `placement.document_partition` computes it."""
    doc_lengths = np.asarray(doc_lengths)
    rank_of_doc, imb = placement.document_partition(doc_lengths.astype(np.float32), num_ranks,
                                                    device=device)
    rank_of_doc = to_numpy(rank_of_doc)
    rows_per_rank = []
    for r in range(num_ranks):
        placements = []
        row, col = 0, 0
        for d in np.nonzero(rank_of_doc == r)[0]:
            remaining, off = int(doc_lengths[d]), 0
            while remaining > 0:
                take = min(seq_len - col, remaining)
                placements.append((int(d), off, take, row, col))
                col += take
                off += take
                remaining -= take
                if col == seq_len:
                    row, col = row + 1, 0
        rows_per_rank.append(placements)
    return rank_of_doc, rows_per_rank, float(imb)
