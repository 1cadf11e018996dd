"""Roofline of a step on the H100 (counterpart of the JAX package's
`repro.launch.roofline`, whose hardware model is the TPU v5e's).

Three terms a (arch x shape x mesh) cell, in seconds a device:

  compute    = FLOPs a device / peak FLOP/s
  memory     = bytes a device / HBM bandwidth
  collective = collective bytes a device over their links: NVLink for a
               group inside one node of NODE_SIZE ranks, the network
               (InfiniBand) for a group that leaves it, pods included

FLOPs, bytes and collective bytes come from `launch.op_cost`, the local ops
of one rank of the traced step.  XLA's HLO text, which the JAX package's
`parse_collectives` reads, has no counterpart here.

Hardware model: NVIDIA's data sheet for the H100 SXM ("NVIDIA H100 80GB
HBM3", 700 W): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, NVLink 4 at 900 GB/s a GPU both ways (450 GB/s a direction) among the
8 GPUs of a node, and one 400 Gb/s NDR InfiniBand port a GPU (50 GB/s)
across nodes.  Spec-sheet figures, not measurements; a card set below 700
W runs slower.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW", "NET_BW", "NODE_SIZE", "HBM_BYTES",
           "roofline_terms", "model_flops"]

PEAK_FLOPS_BF16 = 989e12        # a GPU, dense bf16
HBM_BW = 3.35e12                # bytes/s a GPU
NVLINK_BW = 450e9               # bytes/s a GPU a direction, inside a node
NET_BW = 50e9                   # bytes/s a GPU across nodes (400 Gb/s NDR)
NODE_SIZE = 8                   # GPUs a node (one NVLink domain)
HBM_BYTES = 80e9                # device memory


def roofline_terms(flops_per_dev: float, bytes_per_dev: float, coll_total_bytes: float,
                   cross_pod_bytes: float = 0.0, network_bytes: float | None = None) -> dict:
    """The three roofline terms, in seconds (a device, a step).
    `network_bytes`: the collective bytes of groups that leave a node
    (cross-pod ones included); None: only the cross-pod bytes do."""
    network = cross_pod_bytes if network_bytes is None else network_bytes
    nvlink = coll_total_bytes - network
    t_compute = flops_per_dev / PEAK_FLOPS_BF16
    t_memory = bytes_per_dev / HBM_BW
    t_coll = nvlink / NVLINK_BW + network / NET_BW
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "collective_intra_bytes": int(coll_total_bytes - cross_pod_bytes),
        "collective_cross_pod_bytes": int(cross_pod_bytes),
        "collective_nvlink_bytes": int(nvlink),
        "collective_network_bytes": int(network),
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    bound = max(t_compute, t_memory, t_coll)
    terms["roofline_fraction"] = float(t_compute / bound) if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6 N D for training (N = active params, D = tokens);
    2 N D for inference forward passes."""
    toks = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    n = cfg.active_param_count()
    mult = 6 if shape.mode == "train" else 2
    return float(mult) * n * toks
