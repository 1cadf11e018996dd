"""The paper's technique inside the training stack: SFC-weighted partition
for MoE expert placement and token load balancing.

Simulates a skewed MoE routing distribution (Zipf over 256 experts, as seen
in real deepseek-scale training), then compares:
  * naive blocked placement (experts e*E/D .. (e+1)*E/D per device) vs
  * SFC-weighted contiguous partition over measured loads
and shows the documents->DP-ranks token balancing used by the data pipeline.

    python -m repro_torch.examples.sfc_expert_placement                # on the card
    python -m repro_torch.examples.sfc_expert_placement --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.placement import (document_partition, expert_placement,
                                        imbalance)
from repro_torch.core.types import resolve_device
from repro_torch.examples import cli


def run(E: int = 256, D: int = 16, docs: int = 4096, ranks: int = 32, seed: int = 0,
        device=None) -> dict:
    """Both placements on the example's `default_rng(seed)` draws; returns
    what `main` prints."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    load = torch.from_numpy((rng.zipf(1.3, size=E) % 4000 + 50).astype(np.float32)).to(dev)

    naive = torch.arange(D, device=dev).repeat_interleave(E // D)
    imb_naive = float(imbalance(load, naive, D))
    dev_of, imb_sfc = expert_placement(load, D)
    counts = torch.bincount(dev_of.long(), minlength=D)

    doc_lens = rng.lognormal(6.2, 1.1, size=docs).astype(np.float32)
    rank_of, imb = document_partition(torch.from_numpy(doc_lens).to(dev), ranks)
    per = np.bincount(rank_of.cpu().numpy(), weights=doc_lens, minlength=ranks)
    return {"imbalance_naive": imb_naive, "imbalance_sfc": float(imb_sfc),
            "experts_per_device": counts.tolist(), "document_imbalance": float(imb),
            "tokens_min": per.min(), "tokens_max": per.max(), "device_of_expert": dev_of}


def main(device=None) -> dict:
    r = run(device=device)
    print(f"expert load imbalance (max/mean): naive blocked {r['imbalance_naive']:.2f} "
          f"-> SFC weighted {r['imbalance_sfc']:.2f}")
    print("experts per device:", r["experts_per_device"])
    print()
    print(f"document->rank token balancing over 32 DP ranks: "
          f"imbalance {r['document_imbalance']:.3f} (min {r['tokens_min']:.0f} "
          f"max {r['tokens_max']:.0f} tokens)")
    return r


if __name__ == "__main__":
    cli(main)
