"""Plain PyTorch versions of the CUDA kernels: the element kernels,
delegating to `core.ops`, and attention (`flash_attention`), with the
backward of attention (`flash_attention_backward`), which has no kernel.

Same signatures and outputs as the wrappers in `kernels.ops`; they run on the
tensors' own device.  The wrappers call them for CPU tensors, the tests hold
them against the JAX package, and `chip_smoke.py` holds the kernels against
them on the card.  Each function that has a body per element class takes
`eclass` (simplex by default); hex elements have type 0, which no hex
function reads and every hex function writes.  `eval_route` reads its
face count off its inputs, and `owner_rank` does not depend on the class.
`call_counts` counts calls per function, `class_call_counts` per element
function and class ("simplex" or "hex"; `owner_rank` under the class it is
given).
"""

from __future__ import annotations

import math

import torch

from ..core.keys import span_mask
from ..core.ops import get_ops
from ..core.tables import MAXLEVEL
from ..core.types import ECLASS_HEX, ECLASS_NAMES, ECLASS_SIMPLEX, Simplex

__all__ = ["morton_key", "decode", "parent", "children", "face_sweep", "eval_route",
           "inside_root", "tree_transform", "owner_rank", "successor", "face_neighbor",
           "flash_attention", "flash_attention_backward", "NEG_INF", "BACKWARD_BLOCK_BYTES",
           "call_counts", "class_call_counts", "reset_call_counts"]

_ELEMENT_FNS = ("morton_key", "decode", "parent", "children", "face_sweep", "eval_route",
                "inside_root", "tree_transform", "owner_rank", "successor", "face_neighbor")
call_counts: dict[str, int] = dict.fromkeys(
    (*_ELEMENT_FNS, "flash_attention", "flash_attention_backward"), 0)
class_call_counts: dict[str, dict[str, int]] = {
    k: dict.fromkeys(ECLASS_NAMES.values(), 0) for k in _ELEMENT_FNS}
NEG_INF = -1e30     # a masked score: finite, as in the JAX package
# The most bytes one fp32 (B, H, rows, keys) block of the attention backward
# may take; the backward holds about four such blocks at once.
BACKWARD_BLOCK_BYTES = 512 << 20


def reset_call_counts() -> None:
    for k in call_counts:
        call_counts[k] = 0
    for k in class_call_counts:
        class_call_counts[k] = dict.fromkeys(ECLASS_NAMES.values(), 0)


def _called(name: str, eclass: int) -> None:
    call_counts[name] += 1
    class_call_counts[name][ECLASS_NAMES[eclass]] += 1


def morton_key(anchor: torch.Tensor, stype: torch.Tensor,
               eclass: int = ECLASS_SIMPLEX) -> torch.Tensor:
    """(n, d) anchor, (n,) type -> (n,) int64 level-padded keys.  The level
    plays no role in the padded key (the T_0-chain digits below an element's
    level are zero; a hex key is the interleave of the anchor), so the key
    is evaluated at MAXLEVEL."""
    _called("morton_key", eclass)
    o = get_ops(anchor.shape[-1], eclass)
    level = torch.full_like(stype, o.L)
    return o.morton_key(Simplex(anchor, level, stype))


def decode(d: int, key: torch.Tensor, level: torch.Tensor, eclass: int = ECLASS_SIMPLEX):
    """(n,) int64 keys and int32 levels -> (anchor (n, d), type (n,))."""
    _called("decode", eclass)
    s = get_ops(d, eclass).decode_key(key, level)
    return s.anchor, s.stype


def parent(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
           eclass: int = ECLASS_SIMPLEX):
    """-> (parent anchor, parent level, parent type, local index)."""
    _called("parent", eclass)
    o = get_ops(anchor.shape[-1], eclass)
    s = Simplex(anchor, level, stype)
    p = o.parent(s)
    return p.anchor, p.level, p.stype, o.local_index(s)


def children(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
             eclass: int = ECLASS_SIMPLEX):
    """-> all 2^d children in SFC order: anchor (n, 2^d, d), level and type
    (n, 2^d)."""
    _called("children", eclass)
    kids = get_ops(anchor.shape[-1], eclass).children_tm(Simplex(anchor, level, stype))
    return kids.anchor, kids.level, kids.stype


def face_sweep(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
               eclass: int = ECLASS_SIMPLEX):
    """For every face f of every element (nf = d+1 a simplex, 2d a hex),
    composed per face from the element ops as the JAX package's
    `face_sweep_ref` is: the same-level neighbor (Algorithm 4.6), whether
    it lies inside the root, and its key.  Face-major outputs: neighbor
    anchor (nf, n, d) int32, type and dual face (nf, n) int32, inside
    (nf, n) bool, key (nf, n) int64.  Keys and types of neighbors outside
    the root are computed all the same."""
    _called("face_sweep", eclass)
    o = get_ops(anchor.shape[-1], eclass)
    s = Simplex(anchor, level, stype)
    cols = [[] for _ in range(5)]
    for f in range(o.nf):
        nb, dual = o.face_neighbor(s, f)
        for col, x in zip(cols, (nb.anchor, nb.stype, dual, o.is_inside_root(nb),
                                 o.morton_key(nb))):
            col.append(x)
    return tuple(torch.stack(col) for col in cols)


def eval_route(d: int, tgt: torch.Tensor, key: torch.Tensor, level: torch.Tensor,
               marker_tree: torch.Tensor, marker_key: torch.Tensor):
    """Over the (face, element) pairs of a face-major (nf, n) sweep, nf read
    off the inputs: the end key of each neighbor's interval,
    key | (2^(d(L - level)) - 1) (keys are span aligned; the exponent is
    clamped to [0, 63]), and the first and last owner rank of the interval
    against the P partition markers.  Returns (end key int64, first int32,
    last int32), each (nf, n).  Counted under the class whose face count
    nf is (2d a hex)."""
    _called("eval_route", ECLASS_HEX if tgt.shape[0] == 2 * d else ECLASS_SIMPLEX)
    kend = key | span_mask(d, MAXLEVEL[d], level)[None, :]
    return (kend, _owner_count(tgt, key, marker_tree, marker_key),
            _owner_count(tgt, kend, marker_tree, marker_key))


def _owner_count(tree: torch.Tensor, key: torch.Tensor, marker_tree: torch.Tensor,
                 marker_key: torch.Tensor) -> torch.Tensor:
    """The marker compare-and-count of the JAX package's `owner_rank_lex`
    (`repro.core.batch`), shared by `owner_rank` and `eval_route` as the
    Pallas kernels share `_owner_count_expr`: the number of the P markers
    lex-<= each (tree, key), less one, clamped to 0.  int32, the shape of
    `tree`.  The (query, marker) comparison matrix is built a slice of
    queries at a time, so memory stays bounded at any P."""
    t, k = tree.reshape(-1, 1), key.reshape(-1, 1)
    step = max(1, _PAIRS_PER_SLICE // max(marker_tree.shape[0], 1))
    out = torch.empty(t.shape[0], dtype=torch.int32, device=tree.device)
    for a in range(0, t.shape[0], step):
        ts, ks = t[a:a + step], k[a:a + step]
        le = (marker_tree < ts) | ((marker_tree == ts) & (marker_key <= ks))
        out[a:a + step] = le.sum(dim=1, dtype=torch.int32)
    return (out - 1).clamp(min=0).reshape(tree.shape)


_PAIRS_PER_SLICE = 1 << 27   # query-marker comparisons held at once


def owner_rank(tree: torch.Tensor, key: torch.Tensor, marker_tree: torch.Tensor,
               marker_key: torch.Tensor, eclass: int = ECLASS_SIMPLEX) -> torch.Tensor:
    """The rank whose partition range [marker_r, marker_{r+1}) holds each
    lex (tree, key): the number of the P lex-sorted markers lex-<= it, less
    one, clamped to 0 (keys before the first marker go to rank 0).  (n,)
    int32.  The same for every class; `eclass` only names the count."""
    _called("owner_rank", eclass)
    return _owner_count(tree, key, marker_tree, marker_key)


def successor(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
              eclass: int = ECLASS_SIMPLEX):
    """Algorithm 4.10 at each element's own level, wrapping within the
    level (`ElementOps.successor`): (anchor (n, d), type)."""
    _called("successor", eclass)
    s = get_ops(anchor.shape[-1], eclass).successor(Simplex(anchor, level, stype))
    return s.anchor, s.stype


def face_neighbor(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
                  face: torch.Tensor, eclass: int = ECLASS_SIMPLEX):
    """Algorithm 4.6 across one face per element, face[i] of element i:
    the same-level neighbor's (anchor (n, d), type) and the dual face, all
    int32.  The neighbor may lie outside the root."""
    _called("face_neighbor", eclass)
    nb, dual = get_ops(anchor.shape[-1], eclass).face_neighbor(Simplex(anchor, level, stype),
                                                               face)
    return nb.anchor, nb.stype, dual


def inside_root(anchor: torch.Tensor, level: torch.Tensor, stype: torch.Tensor,
                eclass: int = ECLASS_SIMPLEX) -> torch.Tensor:
    """Section 4.4: (n,) bool, does each element lie inside the root simplex
    (the root cube for hexes)."""
    _called("inside_root", eclass)
    return get_ops(anchor.shape[-1], eclass).is_inside_root(Simplex(anchor, level, stype))


def tree_transform(conn: torch.Tensor, anchor: torch.Tensor, level: torch.Tensor,
                   stype: torch.Tensor, dual: torch.Tensor, table: torch.Tensor,
                   eclass: int = ECLASS_SIMPLEX):
    """Each element (n,) across its own connection: row conn[i] of the
    packed connection table (`core.cmesh.pack_connection`) gives the
    gluing's (M, c, typemap), applied by `ElementOps.tree_transform`, the
    face map that renumbers the dual face (a hex row's 2d entries sit where
    a simplex row's type-0 entries do), and the neighbor tree.  A hex keeps
    type 0.  Returns (anchor (n, d), type, dual face, tree), int32."""
    _called("tree_transform", eclass)
    n, d = anchor.shape
    o = get_ops(d, eclass)
    nt = get_ops(d).nt
    row = table[conn.long()].long()
    code = row[:, :d]
    sign = 1 - 2 * ((code >> 2) & 1)
    M = torch.zeros((n, d, d), dtype=torch.int64, device=anchor.device)
    M.scatter_(2, (code & 3)[:, :, None], sign[:, :, None])
    if eclass == ECLASS_HEX:
        stype = torch.zeros_like(stype)
        typemap = torch.zeros((n, 1), dtype=torch.int64, device=anchor.device)
        at = dual.long()
    else:
        typemap = row[:, 2 * d:2 * d + nt]
        at = stype.long() * o.nf + dual.long()
    s2 = o.tree_transform(Simplex(anchor, level, stype), M, row[:, d:2 * d], typemap)
    dual2 = torch.gather(row[:, 2 * d + nt:-1], 1, at[:, None])[:, 0]
    return s2.anchor, s2.stype, dual2.to(torch.int32), row[:, -1].to(torch.int32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over k, v (B, S, KV, hd), the function
    of the attention kernel: scores q.k / sqrt(hd) in fp32, masked to the
    finite NEG_INF (causal: kpos <= qpos; with `window` also
    kpos > qpos - window), softmax, p.v in fp32, cast to q's dtype.  The
    whole (S, S) score matrix at once, no online softmax."""
    call_counts["flash_attention"] += 1
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / math.sqrt(hd))
    mask = _band_mask(0, S, 0, S, causal, window, q.device)
    p = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _band_mask(q0: int, q1: int, k0: int, k1: int, causal: bool, window, device):
    """The (q1 - q0, k1 - k0) mask of query rows [q0, q1) over keys
    [k0, k1): kpos <= qpos if causal, and kpos > qpos - window with a
    window."""
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True, window: int | None = None):
    """The gradients (dq, dk, dv) of `flash_attention(q, k, v, causal,
    window)` for the output's gradient `do`, in q's, k's and v's dtypes.

    Plain by design (the JAX package differentiates jnp attention; its
    Pallas kernel has no backward).  In fp32, a block of query rows at a
    time: P = softmax(q.k^T scale, masked) is recomputed over the keys the
    block can see (up to its last row if causal, from its first row's
    window start), then dV += P^T dO, dP = dO V^T, dS = P (dP - rowsum(P dP)),
    dQ = dS K scale and dK += dS^T Q scale; the G = H / KV query heads of
    a KV head add into its dK and dV.  rowsum(P dP) is rowsum(dO o) for the
    exact output o: taken from the fp32 P, it does not carry the rounding
    of a bf16/fp16 output (which, in the rows whose gradient nearly cancels,
    the first rows of a causal band, outweighs the gradient itself).  A
    block holds at most BACKWARD_BLOCK_BYTES a (B, H, rows, keys) fp32
    tensor, so the transient memory stays bounded whatever S is.  Keys a
    block cannot see have P = 0 exactly in fp32, so the blocks compute what
    one (S, S) pass would."""
    call_counts["flash_attention_backward"] += 1
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, S, KV, G, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, S, KV, G, hd)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    rows = max(1, min(S, BACKWARD_BLOCK_BYTES // (4 * B * H * S)))
    for q0 in range(0, S, rows):
        q1 = min(S, q0 + rows)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        k1 = q1 if causal else S
        qb, dob = qf[:, q0:q1], dof[:, q0:q1]
        kb, vb = kf[:, k0:k1], vf[:, k0:k1]
        s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb) * scale
        mask = _band_mask(q0, q1, k0, k1, causal, window, q.device)
        p = torch.softmax(s.masked_fill_(~mask, NEG_INF), dim=-1)
        del s
        dv[:, k0:k1] += torch.einsum("bkgqs,bqkgh->bskh", p, dob)
        ds = torch.einsum("bqkgh,bskh->bkgqs", dob, vb)
        delta = torch.einsum("bkgqs,bkgqs->bkgq", p, ds)
        ds.sub_(delta[..., None]).mul_(p)
        del p, delta
        dq[:, q0:q1] = torch.einsum("bkgqs,bskh->bqkgh", ds, kb) * scale
        dk[:, k0:k1] += torch.einsum("bkgqs,bqkgh->bskh", ds, qb) * scale
        del ds
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
