"""Per-device cost of a traced step, from the local ops each rank runs (the
port's counterpart of the JAX package's `repro.launch.hlo_cost`, which
reads XLA's HLO text, a thing torch does not make).

`OpCost` is a `TorchDispatchMode` that sees the ops on each rank's local
tensors: under a DTensor it steps aside (returns NotImplemented), so
DTensor runs the op on the local shards, and those local ops come back
through it.  The ops DTensor runs to propagate shardings (on tensors of
the global shapes) are skipped.  Per op:

  flops       — torch's FLOP formulas (`torch.utils.flop_counter`: mm,
                bmm, addmm, the convolutions, SDPA), and for the attention
                kernel (row 12, `repro_torch::flash_attention`) 4 B H hd
                times the (query, key) pairs its mask keeps;
  bytes       — operand + output bytes of every op that is not a view (the
                eager model: every op reads its inputs from HBM and writes
                its outputs back; row 12 is one op, its scores never leave
                the chip);
  collectives — the c10d functional ops (all-gather, reduce-scatter,
                all-reduce, all-to-all) by kind, their output bytes (the
                JAX package's wire-bytes proxy), the bytes of groups that
                leave a node of `NODE_SIZE` ranks (the network, not NVLink)
                and of groups that span pods;
  memory      — the bytes of the storages the step's ops made that are
                alive at once, at most (`peak`: on top of what the step
                was given; no allocator rounding).

`analyze(cost)` returns the keys of the JAX package's `hlo_cost.analyze`.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from ..kernels import ops as _kops  # noqa: F401  (registers repro_torch::flash_attention)
from .roofline import NODE_SIZE

__all__ = ["OpCost", "analyze", "attention_flops"]

_KINDS = {"all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter", "all_reduce": "all-reduce",
          "all_reduce_coalesced": "all-reduce", "all_to_all_single": "all-to-all"}
# DTensor's functions that run an op on tensors of the global shapes for its
# output's shape (torch.distributed.tensor._sharding_prop)
_PROPAGATION = {"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"}
_FREE = {"empty", "empty_strided", "empty_like", "wait_tensor", "device", "_local_scalar_dense",
         "set_", "resize_", "lift_fresh"}


def attention_flops(B: int, S: int, H: int, hd: int, causal: bool, window: int) -> float:
    """4 B H hd times the (query, key) pairs the mask keeps (QK^T and PV, 2
    operations a pair and dim each); `window` 0 is none."""
    if not causal:
        pairs = S * S
    elif not window or window >= S:
        pairs = S * (S + 1) // 2
    else:
        pairs = window * (window + 1) // 2 + (S - window) * window
    return 4.0 * B * H * hd * pairs


if torch.ops.repro_torch.flash_attention not in flop_registry:
    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
        B, S, H, hd = q_shape
        return int(attention_flops(B, S, H, hd, causal, window))


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class OpCost(TorchDispatchMode):
    """Counts the local ops of this rank while it is entered, on real, fake
    or `meta` tensors.  `pod_size`: ranks a pod (the world with one)."""

    def __init__(self, pod_size: int | None = None):
        super().__init__()
        self.pod_size = pod_size
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_counts: dict = defaultdict(int)
        self.coll_bytes: dict = defaultdict(float)
        self.network_bytes = 0.0
        self.cross_pod_bytes = 0.0
        self._groups: dict = {}
        self.live = 0             # bytes of the storages the step made, alive now
        self.peak = 0             # and at most
        self._storages: dict = {}

    @staticmethod
    def _ours() -> bool:
        """Whether the op runs on the step's own tensors, not inside
        DTensor's sharding propagation (which runs it on tensors of the
        global shapes, to take its output's shape)."""
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_name in _PROPAGATION:
                return False
            f = f.f_back
        return True

    def _spans(self, group_name: str) -> tuple[bool, bool]:
        """(leaves a node, spans pods) of the process group `group_name`."""
        if group_name not in self._groups:
            from torch.distributed.distributed_c10d import _resolve_process_group
            ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
            pod = self.pod_size or dist.get_world_size()
            self._groups[group_name] = (len({r // NODE_SIZE for r in ranks}) > 1,
                                        len({r // pod for r in ranks}) > 1)
        return self._groups[group_name]

    def _hold(self, t: torch.Tensor) -> None:
        """Count the storage of an op's output while it lives (once, however
        many views share it)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._ours():
            return out
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        moved = _bytes(list(_tensors((args, kwargs)))) + _bytes(list(_tensors(out)))
        self.bytes += moved
        for t in _tensors(out):
            self._hold(t)
        if func.namespace == "_c10d_functional" and name in _KINDS:
            kind = _KINDS[name]
            b = _bytes(list(_tensors(out)))
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += b
            group = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
            network, pods = self._spans(group)
            self.network_bytes += b if network else 0
            self.cross_pod_bytes += b if pods else 0
        return out


def analyze(cost: OpCost) -> dict:
    """The JAX package's `hlo_cost.analyze` keys for one rank's step:
    flops, bytes (= bytes_cpu_granularity: operands and outputs of every
    op), the collectives by kind, their total and cross-pod bytes, and
    the bytes of groups that leave a node (`network_bytes`)."""
    return {
        "flops": cost.flops,
        "bytes": cost.bytes,
        "bytes_cpu_granularity": cost.bytes,
        "bytes_attention_internal": 0.0,
        "collective_counts": dict(cost.coll_counts),
        "collective_bytes_by_kind": dict(cost.coll_bytes),
        "collective_total_bytes": sum(cost.coll_bytes.values()),
        "cross_pod_bytes": cost.cross_pod_bytes,
        "network_bytes": cost.network_bytes,
    }
