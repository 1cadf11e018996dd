"""Wrappers around the CUDA kernels of `csrc/sfc.cu`: encode, decode,
parent and children (New -> Adapt -> Partition) and the face sweep, routing
eval and inside-root test (Balance -> Ghost -> validate).

Each wrapper checks dtype, shape and contiguity, then dispatches by device:
a CPU tensor goes to its plain version in `kernels.ref`; a CUDA tensor goes
to the kernel, or the call raises — there is no fallback.  On the card a
wrapper allocates the outputs with `torch.empty`, launches on
`torch.cuda.current_stream()`, raises if the launch returns a nonzero
`cudaError_t`, and adds one to `launch_counts` for the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import library

__all__ = ["morton_key", "decode", "parent", "children", "face_sweep", "eval_route",
           "inside_root", "launch_counts", "reset_launch_counts", "MAX_MARKERS"]

launch_counts: dict[str, int] = {"morton_key": 0, "decode": 0, "parent": 0, "children": 0,
                                 "face_sweep": 0, "eval_route": 0, "inside_root": 0}

# eval_route keeps the partition markers in 48 KB of shared memory
# (kMaxMarkers in csrc/sfc.cu).
MAX_MARKERS = 4096

_P = ctypes.c_void_p
_N = ctypes.c_int64
_ARGTYPES = {
    "sfc_morton_key": [ctypes.c_int, _P, _P, _P, _N, _P],
    "sfc_decode": [ctypes.c_int, _P, _P, _P, _P, _N, _P],
    "sfc_parent": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _N, _P],
    "sfc_children": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _N, _P],
    "sfc_face_sweep": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _N, _P],
    "sfc_eval_route": [ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int, _P, _P, _P, _N, _P],
    "sfc_inside_root": [ctypes.c_int, _P, _P, _P, _P, _N, _P],
}
_FNS: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _fn(name: str):
    f = _FNS.get(name)
    if f is None:
        f = getattr(library("sfc"), name)
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
        _FNS[name] = f
    return f


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU inputs (-> plain version), False for CUDA inputs on one
    card; raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _dim(anchor: torch.Tensor) -> int:
    if anchor.dim() != 2 or anchor.shape[1] not in (2, 3):
        raise ValueError(f"anchor must be (n, 2) or (n, 3), got {tuple(anchor.shape)}")
    return anchor.shape[1]


def _launch(name: str, kernel: str, d: int, *args) -> None:
    dev = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = _fn(kernel)(d, *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {err}")
    launch_counts[name] += 1


def morton_key(anchor: torch.Tensor, stype: torch.Tensor) -> torch.Tensor:
    """Level-padded int64 keys of (n, d) anchors and (n,) types."""
    d, n = _dim(anchor), anchor.shape[0]
    _check(anchor, "anchor", torch.int32, (n, d))
    _check(stype, "stype", torch.int32, (n,))
    if _on_cpu(anchor, stype):
        return ref.morton_key(anchor, stype)
    key = torch.empty(n, dtype=torch.int64, device=anchor.device)
    if n:
        _launch("morton_key", "sfc_morton_key", d, anchor, stype, key, n)
    return key


def decode(d: int, key: torch.Tensor, level: torch.Tensor):
    """Algorithm 4.8: (n,) int64 keys + int32 levels -> (anchor, type)."""
    if d not in (2, 3):
        raise ValueError(f"d must be 2 or 3, got {d}")
    n = key.shape[0]
    _check(key, "key", torch.int64, (n,))
    _check(level, "level", torch.int32, (n,))
    if _on_cpu(key, level):
        return ref.decode(d, key, level)
    anchor = torch.empty((n, d), dtype=torch.int32, device=key.device)
    stype = torch.empty(n, dtype=torch.int32, device=key.device)
    if n:
        _launch("decode", "sfc_decode", d, key, level, anchor, stype, n)
    return anchor, stype


def parent(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """Algorithm 4.3 + Table 6: (parent anchor, level, type, local index)."""
    d, n = _dim(anchor), anchor.shape[0]
    _check(anchor, "anchor", torch.int32, (n, d))
    _check(level, "level", torch.int32, (n,))
    _check(stype, "stype", torch.int32, (n,))
    if _on_cpu(anchor, level, stype):
        return ref.parent(anchor, level, stype)
    outs = (torch.empty((n, d), dtype=torch.int32, device=anchor.device),
            *(torch.empty(n, dtype=torch.int32, device=anchor.device) for _ in range(3)))
    if n:
        _launch("parent", "sfc_parent", d, anchor, level, stype, *outs, n)
    return outs


def children(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """Algorithm 4.5, all 2^d children in SFC order: anchor (n, 2^d, d),
    level and type (n, 2^d)."""
    d, n = _dim(anchor), anchor.shape[0]
    _check(anchor, "anchor", torch.int32, (n, d))
    _check(level, "level", torch.int32, (n,))
    _check(stype, "stype", torch.int32, (n,))
    if _on_cpu(anchor, level, stype):
        return ref.children(anchor, level, stype)
    nc = 1 << d
    dev = anchor.device
    outs = (torch.empty((n, nc, d), dtype=torch.int32, device=dev),
            torch.empty((n, nc), dtype=torch.int32, device=dev),
            torch.empty((n, nc), dtype=torch.int32, device=dev))
    if n:
        _launch("children", "sfc_children", d, anchor, level, stype, *outs, n)
    return outs


def face_sweep(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor):
    """For all d+1 faces of (n,) elements: the same-level neighbor's anchor
    (nf, n, d) int32, type and dual face (nf, n) int32, inside-root mask
    (nf, n) bool and key (nf, n) int64, face-major."""
    d, n = _dim(anchor), anchor.shape[0]
    _check(anchor, "anchor", torch.int32, (n, d))
    _check(level, "level", torch.int32, (n,))
    _check(stype, "stype", torch.int32, (n,))
    if _on_cpu(anchor, level, stype):
        return ref.face_sweep(anchor, level, stype)
    nf, dev = d + 1, anchor.device
    outs = (torch.empty((nf, n, d), dtype=torch.int32, device=dev),
            torch.empty((nf, n), dtype=torch.int32, device=dev),
            torch.empty((nf, n), dtype=torch.int32, device=dev),
            torch.empty((nf, n), dtype=torch.bool, device=dev),
            torch.empty((nf, n), dtype=torch.int64, device=dev))
    if n:
        _launch("face_sweep", "sfc_face_sweep", d, anchor, level, stype, *outs, n)
    return outs


def eval_route(d: int, tgt: torch.Tensor, key: torch.Tensor, level: torch.Tensor,
               marker_tree: torch.Tensor, marker_key: torch.Tensor):
    """Over the pairs of a face-major (d+1, n) sweep — target tree int32 and
    neighbor key int64 per pair, level int32 per element — against P
    partition markers (tree int32, key int64): the interval end key (int64)
    and first and last owner rank (int32), each (d+1, n)."""
    if d not in (2, 3):
        raise ValueError(f"d must be 2 or 3, got {d}")
    n, P = level.shape[0], marker_tree.shape[0]
    _check(tgt, "tgt", torch.int32, (d + 1, n))
    _check(key, "key", torch.int64, (d + 1, n))
    _check(level, "level", torch.int32, (n,))
    _check(marker_tree, "marker_tree", torch.int32, (P,))
    _check(marker_key, "marker_key", torch.int64, (P,))
    if not 1 <= P <= MAX_MARKERS:
        raise ValueError(f"need 1 to {MAX_MARKERS} partition markers, got {P}")
    if _on_cpu(tgt, key, level, marker_tree, marker_key):
        return ref.eval_route(d, tgt, key, level, marker_tree, marker_key)
    dev = key.device
    kend = torch.empty((d + 1, n), dtype=torch.int64, device=dev)
    first = torch.empty((d + 1, n), dtype=torch.int32, device=dev)
    last = torch.empty((d + 1, n), dtype=torch.int32, device=dev)
    if n:
        _launch("eval_route", "sfc_eval_route", d, tgt, key, level, marker_tree, marker_key,
                P, kend, first, last, n)
    return kend, first, last


def inside_root(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor) -> torch.Tensor:
    """Section 4.4 inside-root test of (n,) elements -> (n,) bool."""
    d, n = _dim(anchor), anchor.shape[0]
    _check(anchor, "anchor", torch.int32, (n, d))
    _check(level, "level", torch.int32, (n,))
    _check(stype, "stype", torch.int32, (n,))
    if _on_cpu(anchor, level, stype):
        return ref.inside_root(anchor, level, stype)
    inside = torch.empty(n, dtype=torch.bool, device=anchor.device)
    if n:
        _launch("inside_root", "sfc_inside_root", d, anchor, level, stype, inside, n)
    return inside
