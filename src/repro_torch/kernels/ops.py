"""Wrappers around the CUDA kernels of `csrc/sfc.cu`: encode, decode,
parent and children (New -> Adapt -> Partition), the face sweep, routing
eval and inside-root test (Balance -> Ghost -> validate), the tree
transform that carries face neighbors across glued tree faces (cmesh), and
the element queries owner rank, successor and single-face neighbor; and
around the attention kernel of `csrc/flash_attention.cu`, which the LM's
prefill and training forward run (`FlashAttentionFn` carries it under
autograd, with the plain backward of `kernels.ref`).

Every kernel with a body per element class takes `eclass` (simplex by
default) and passes it to the C entry point, which launches that class's
body: the hex bodies never read the type column and write it as 0.
`eval_route` reads its face count nf (d + 1 a simplex, 2d a hex) off its
inputs and launches one grid row per face plane; `owner_rank` has one body
for both classes.

Each wrapper checks dtype, shape and contiguity, then dispatches by device:
a CPU tensor goes to its plain version in `kernels.ref`; a CUDA tensor goes
to the kernel, or the call raises — there is no fallback.  On the card a
wrapper allocates the outputs with `torch.empty`, launches on
`torch.cuda.current_stream()`, raises if the launch returns a nonzero
`cudaError_t`, and adds one to `launch_counts` for the kernel and, for an
element kernel, to `class_launch_counts` for the kernel and the class
("simplex" or "hex").
"""

from __future__ import annotations

import ctypes

import torch

from ..core.cmesh import conn_row_width
from ..core.types import ECLASS_HEX, ECLASS_NAMES, ECLASS_SIMPLEX
from . import ref
from .build import library

__all__ = ["morton_key", "decode", "parent", "children", "face_sweep", "eval_route",
           "inside_root", "tree_transform", "owner_rank", "successor", "face_neighbor",
           "flash_attention", "FlashAttentionFn", "FLASH_HEAD_DIMS", "launch_counts",
           "class_launch_counts", "reset_launch_counts"]

_ELEMENT_KERNELS = ("morton_key", "decode", "parent", "children", "face_sweep",
                    "eval_route", "inside_root", "tree_transform", "owner_rank", "successor",
                    "face_neighbor")
launch_counts: dict[str, int] = dict.fromkeys((*_ELEMENT_KERNELS, "flash_attention"), 0)
class_launch_counts: dict[str, dict[str, int]] = {
    k: dict.fromkeys(ECLASS_NAMES.values(), 0) for k in _ELEMENT_KERNELS}

_P = ctypes.c_void_p
_N = ctypes.c_int64
_I = ctypes.c_int
_ARGTYPES = {
    "sfc_morton_key": [_I, _I, _P, _P, _P, _N, _P],
    "sfc_decode": [_I, _I, _P, _P, _P, _P, _N, _P],
    "sfc_parent": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _N, _P],
    "sfc_children": [_I, _I, _P, _P, _P, _P, _P, _P, _N, _P],
    "sfc_face_sweep": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _N, _P],
    "sfc_eval_route": [_I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _N, _P],
    "sfc_inside_root": [_I, _I, _P, _P, _P, _P, _N, _P],
    "sfc_tree_transform": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _N, _P],
    "sfc_owner_rank": [_P, _P, _P, _P, _I, _P, _N, _P],
    "sfc_successor": [_I, _I, _P, _P, _P, _P, _P, _N, _P],
    "sfc_face_neighbor": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _N, _P],
    "fa_flash_attention": [_I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                           _N, _N, _N, _N, _N, _N, _P],
}
_FNS: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    for k in class_launch_counts:
        class_launch_counts[k] = dict.fromkeys(ECLASS_NAMES.values(), 0)


def _fn(name: str):
    """The C entry point `name`: `fa_*` from `csrc/flash_attention.cu`,
    `sfc_*` from `csrc/sfc.cu`."""
    f = _FNS.get(name)
    if f is None:
        f = getattr(library("flash_attention" if name.startswith("fa_") else "sfc"), name)
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


def _class(eclass: int) -> int:
    if eclass not in ECLASS_NAMES:
        raise ValueError(f"unknown element class {eclass!r}")
    return eclass


def _nf(d: int, eclass: int) -> int:
    """Faces of an element: d + 1 a simplex, 2d a hex."""
    return 2 * d if eclass == ECLASS_HEX else d + 1


def _call(name: str, kernel: str, *args) -> None:
    """Call C entry point `kernel` with `args` (tensors as pointers) and the
    current stream of the tensors' card, raise on a nonzero `cudaError_t`,
    and count the launch under `name`."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    fn = _fn(kernel)
    if len(ptrs) + 1 != len(fn.argtypes):     # ctypes would pass extras unconverted
        raise TypeError(f"{kernel} takes {len(fn.argtypes)} arguments, got {len(ptrs) + 1}")
    with torch.cuda.device(dev):
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {err}")
    launch_counts[name] += 1


def _launch(name: str, eclass: int, kernel: str, *args) -> None:
    """`_call` for an element kernel, also counted for `eclass`."""
    _call(name, kernel, *args)
    class_launch_counts[name][ECLASS_NAMES[eclass]] += 1


def _elements(anchor: torch.Tensor, level: torch.Tensor | None, stype: torch.Tensor):
    """Check an (n, d) anchor, (n,) level (unless None) and (n,) type
    column; return (d, n)."""
    d, n = _dim(anchor), anchor.shape[0]
    _check(anchor, "anchor", torch.int32, (n, d))
    if level is not None:
        _check(level, "level", torch.int32, (n,))
    _check(stype, "stype", torch.int32, (n,))
    return d, n


def morton_key(anchor: torch.Tensor, stype: torch.Tensor,
               eclass: int = ECLASS_SIMPLEX) -> torch.Tensor:
    """Level-padded int64 keys of (n, d) anchors and (n,) types."""
    d, n = _elements(anchor, None, stype)
    ec = _class(eclass)
    if _on_cpu(anchor, stype):
        return ref.morton_key(anchor, stype, ec)
    key = torch.empty(n, dtype=torch.int64, device=anchor.device)
    if n:
        _launch("morton_key", ec, "sfc_morton_key", d, ec, anchor, stype, key, n)
    return key


def decode(d: int, key: torch.Tensor, level: torch.Tensor, eclass: int = ECLASS_SIMPLEX):
    """Algorithm 4.8: (n,) int64 keys + int32 levels -> (anchor, type)."""
    if d not in (2, 3):
        raise ValueError(f"d must be 2 or 3, got {d}")
    ec = _class(eclass)
    n = key.shape[0]
    _check(key, "key", torch.int64, (n,))
    _check(level, "level", torch.int32, (n,))
    if _on_cpu(key, level):
        return ref.decode(d, key, level, ec)
    anchor = torch.empty((n, d), dtype=torch.int32, device=key.device)
    stype = torch.empty(n, dtype=torch.int32, device=key.device)
    if n:
        _launch("decode", ec, "sfc_decode", d, ec, key, level, anchor, stype, n)
    return anchor, stype


def parent(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
           eclass: int = ECLASS_SIMPLEX):
    """Algorithm 4.3 + Table 6: (parent anchor, level, type, local index)."""
    d, n = _elements(anchor, level, stype)
    ec = _class(eclass)
    if _on_cpu(anchor, level, stype):
        return ref.parent(anchor, level, stype, ec)
    outs = (torch.empty((n, d), dtype=torch.int32, device=anchor.device),
            *(torch.empty(n, dtype=torch.int32, device=anchor.device) for _ in range(3)))
    if n:
        _launch("parent", ec, "sfc_parent", d, ec, anchor, level, stype, *outs, n)
    return outs


def children(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
             eclass: int = ECLASS_SIMPLEX):
    """Algorithm 4.5, all 2^d children in SFC order: anchor (n, 2^d, d),
    level and type (n, 2^d)."""
    d, n = _elements(anchor, level, stype)
    ec = _class(eclass)
    if _on_cpu(anchor, level, stype):
        return ref.children(anchor, level, stype, ec)
    nc = 1 << d
    dev = anchor.device
    outs = (torch.empty((n, nc, d), dtype=torch.int32, device=dev),
            torch.empty((n, nc), dtype=torch.int32, device=dev),
            torch.empty((n, nc), dtype=torch.int32, device=dev))
    if n:
        _launch("children", ec, "sfc_children", d, ec, anchor, level, stype, *outs, n)
    return outs


def face_sweep(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
               eclass: int = ECLASS_SIMPLEX):
    """For all nf faces of (n,) elements (d + 1 a simplex, 2d a hex): the
    same-level neighbor's anchor (nf, n, d) int32, type and dual face
    (nf, n) int32, inside-root mask (nf, n) bool and key (nf, n) int64,
    face-major."""
    d, n = _elements(anchor, level, stype)
    ec = _class(eclass)
    if _on_cpu(anchor, level, stype):
        return ref.face_sweep(anchor, level, stype, ec)
    nf, dev = _nf(d, ec), anchor.device
    outs = (torch.empty((nf, n, d), dtype=torch.int32, device=dev),
            torch.empty((nf, n), dtype=torch.int32, device=dev),
            torch.empty((nf, n), dtype=torch.int32, device=dev),
            torch.empty((nf, n), dtype=torch.bool, device=dev),
            torch.empty((nf, n), dtype=torch.int64, device=dev))
    if n:
        _launch("face_sweep", ec, "sfc_face_sweep", d, ec, anchor, level, stype, *outs, n)
    return outs


def eval_route(d: int, tgt: torch.Tensor, key: torch.Tensor, level: torch.Tensor,
               marker_tree: torch.Tensor, marker_key: torch.Tensor):
    """Over the pairs of a face-major (nf, n) sweep — nf = d + 1 (simplex)
    or 2d (hex) read off `tgt`; target tree int32 and neighbor key int64
    per pair, level int32 per element — against P lex-sorted partition
    markers (tree int32, key int64), any P >= 0 (with none, every rank is
    0): the interval end key (int64) and first and last owner rank
    (int32), each (nf, n).  On the card one O(log P) search a query
    (`csrc/sfc.cu`, `owner_count`), counted as an `eval_route` launch under
    the class whose face count nf is."""
    if d not in (2, 3):
        raise ValueError(f"d must be 2 or 3, got {d}")
    n, P = level.shape[0], marker_tree.shape[0]
    nf = tgt.shape[0] if tgt.dim() == 2 else -1
    if nf not in (d + 1, 2 * d):
        raise ValueError(f"tgt must be (d + 1, n) or (2d, n), got {tuple(tgt.shape)}")
    _check(tgt, "tgt", torch.int32, (nf, n))
    _check(key, "key", torch.int64, (nf, n))
    _check(level, "level", torch.int32, (n,))
    _check(marker_tree, "marker_tree", torch.int32, (P,))
    _check(marker_key, "marker_key", torch.int64, (P,))
    if _on_cpu(tgt, key, level, marker_tree, marker_key):
        return ref.eval_route(d, tgt, key, level, marker_tree, marker_key)
    dev = key.device
    kend = torch.empty((nf, n), dtype=torch.int64, device=dev)
    first = torch.empty((nf, n), dtype=torch.int32, device=dev)
    last = torch.empty((nf, n), dtype=torch.int32, device=dev)
    if n:
        ec = ECLASS_HEX if nf == 2 * d else ECLASS_SIMPLEX
        _launch("eval_route", ec, "sfc_eval_route", d, nf, tgt, key, level, marker_tree,
                marker_key, P, kend, first, last, n)
    return kend, first, last


def inside_root(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
                eclass: int = ECLASS_SIMPLEX) -> torch.Tensor:
    """Section 4.4 inside-root test of (n,) elements -> (n,) bool."""
    d, n = _elements(anchor, level, stype)
    ec = _class(eclass)
    if _on_cpu(anchor, level, stype):
        return ref.inside_root(anchor, level, stype, ec)
    inside = torch.empty(n, dtype=torch.bool, device=anchor.device)
    if n:
        _launch("inside_root", ec, "sfc_inside_root", d, ec, anchor, level, stype, inside, n)
    return inside


def tree_transform(conn: torch.Tensor, anchor: torch.Tensor, level: torch.Tensor,
                   stype: torch.Tensor, dual: torch.Tensor, table: torch.Tensor,
                   eclass: int = ECLASS_SIMPLEX):
    """(n,) elements, each across its own coarse-mesh connection: row
    conn[i] of the packed int32 connection table (C, W)
    (`core.cmesh.pack_connection`, rows of the elements' class).  Returns
    the element in the neighbor tree's frame — anchor (n, d), type — its
    dual face renumbered by the connection's face map, and the neighbor
    tree; all int32."""
    d, n = _elements(anchor, level, stype)
    ec = _class(eclass)
    _check(conn, "conn", torch.int32, (n,))
    _check(dual, "dual", torch.int32, (n,))
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"table must hold at least one connection row, got {tuple(table.shape)}")
    _check(table, "table", torch.int32, (table.shape[0], conn_row_width(d)))
    if _on_cpu(conn, anchor, level, stype, dual, table):
        return ref.tree_transform(conn, anchor, level, stype, dual, table, ec)
    dev = anchor.device
    outs = (torch.empty((n, d), dtype=torch.int32, device=dev),
            *(torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)))
    if n:
        _launch("tree_transform", ec, "sfc_tree_transform", d, ec, conn, anchor, level, stype,
                dual, table, table.shape[0], *outs, n)
    return outs


def owner_rank(tree: torch.Tensor, key: torch.Tensor, marker_tree: torch.Tensor,
               marker_key: torch.Tensor, eclass: int = ECLASS_SIMPLEX) -> torch.Tensor:
    """The owner rank of each (n,) lex (tree int32, key int64) against P
    lex-sorted partition markers (tree int32, key int64): the number of
    markers lex-<= it, less one, clamped to 0 (with no markers, 0); (n,)
    int32.  On the card one O(log P) search a key, as `eval_route`'s.  One
    body for both classes; `eclass` names the launch count."""
    ec = _class(eclass)
    n, P = tree.shape[0], marker_tree.shape[0]
    _check(tree, "tree", torch.int32, (n,))
    _check(key, "key", torch.int64, (n,))
    _check(marker_tree, "marker_tree", torch.int32, (P,))
    _check(marker_key, "marker_key", torch.int64, (P,))
    if _on_cpu(tree, key, marker_tree, marker_key):
        return ref.owner_rank(tree, key, marker_tree, marker_key, ec)
    rank = torch.empty(n, dtype=torch.int32, device=key.device)
    if n:
        _launch("owner_rank", ec, "sfc_owner_rank", tree, key, marker_tree, marker_key, P,
                rank, n)
    return rank


def successor(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
              eclass: int = ECLASS_SIMPLEX):
    """Algorithm 4.10: the next element along the curve at each element's
    own level, wrapping within the level (the last element's successor is
    element 0).  Returns (anchor (n, d), type), int32; the level is the
    input's."""
    d, n = _elements(anchor, level, stype)
    ec = _class(eclass)
    if _on_cpu(anchor, level, stype):
        return ref.successor(anchor, level, stype, ec)
    outs = (torch.empty((n, d), dtype=torch.int32, device=anchor.device),
            torch.empty(n, dtype=torch.int32, device=anchor.device))
    if n:
        _launch("successor", ec, "sfc_successor", d, ec, anchor, level, stype, *outs, n)
    return outs


def face_neighbor(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
                  face: torch.Tensor, eclass: int = ECLASS_SIMPLEX):
    """Algorithm 4.6 across face[i] of element i (face int32 (n,), below
    d + 1 for a simplex, 2d for a hex): the same-level neighbor's anchor
    (n, d) and type, and the dual face, all int32.  The neighbor may lie
    outside the root."""
    d, n = _elements(anchor, level, stype)
    ec = _class(eclass)
    _check(face, "face", torch.int32, (n,))
    if _on_cpu(anchor, level, stype, face):
        return ref.face_neighbor(anchor, level, stype, face, ec)
    outs = (torch.empty((n, d), dtype=torch.int32, device=anchor.device),
            *(torch.empty(n, dtype=torch.int32, device=anchor.device) for _ in range(2)))
    if n:
        _launch("face_neighbor", ec, "sfc_face_neighbor", d, ec, anchor, level, stype, face,
                *outs, n)
    return outs


FLASH_HEAD_DIMS = (32, 64, 96, 128, 256)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over k, v (B, S, KV, hd), H % KV == 0,
    query head h reading KV head h // (H // KV), with scale 1/sqrt(hd); a
    causal mask (kpos <= qpos) unless `causal` is False, and with `window`
    also kpos > qpos - window.  Scores, softmax and p.v in fp32 (the kernel
    rounds p to bf16/fp16 for the tensor cores); returns (B, S, H, hd) in
    q's dtype.  The function of the JAX package's Pallas `flash_attention`,
    for any S >= 1.

    q, k and v are contiguous, of one dtype (float32, bfloat16 or float16),
    with hd in FLASH_HEAD_DIMS — the kernel's domain, checked for CPU
    tensors too, so both devices take the same inputs.  A CPU tensor goes
    to the plain version (`kernels.ref.flash_attention`); a CUDA tensor to
    the kernel of `csrc/flash_attention.cu` (float32 on CUDA cores,
    bfloat16/float16 on the tensor cores), which reads the (B, S, H, hd)
    layout in place through its strides."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, hd), got {tuple(q.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2] if k.dim() == 4 else -1
    if KV < 1 or H % KV:
        raise ValueError(f"k must be (B, S, KV, hd) with H % KV == 0, got {tuple(k.shape)}")
    if q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"q: no kernel for {q.dtype}")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {FLASH_HEAD_DIMS}")
    if S < 1:
        raise ValueError("need at least one position")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check(q, "q", q.dtype, (B, S, H, hd))
    _check(k, "k", q.dtype, (B, S, KV, hd))
    _check(v, "v", q.dtype, (B, S, KV, hd))
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window or 0)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: int) -> torch.Tensor:
    """Row 12 as an operator of its own (window 0: none), so that fake
    tensors (the dry run's tracing) take its shape (`_flash_attention_fake`)
    and the cost model its operations (`launch.op_cost`), while a real
    tensor takes the kernel or, on the CPU, the plain version."""
    if _on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window or None)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries (16-byte loads)")
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    _call("flash_attention", "fa_flash_attention", _FLASH_DTYPES[q.dtype], B, S, H, k.shape[2],
          hd, int(causal), window, q, k, v, o, *q.stride()[:3], *k.stride()[:3])
    return o


@_flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window):
    return torch.empty_like(q)


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` under autograd: apply(q, k, v, causal, window).

    The forward is the wrapper above (the kernel for CUDA tensors, whose
    output carries no autograd history of its own; the plain version for
    CPU tensors), and the backward is `kernels.ref.flash_attention_backward`
    on both devices: plain by design, as the JAX package's Pallas kernel
    has no backward either.  It saves q, k and v (the backward recomputes
    the softmax and does not read the output)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_backward(q, k, v, do, causal=ctx.causal,
                                                  window=ctx.window)
        return dq, dk, dv, None, None
