"""Element batches as PyTorch tensors, and their byte encodings.

A `Simplex` is the paper's `Tet` data type (Remark 20) in structure-of-arrays
form: anchor coordinates `(..., d)` int32, refinement level and type int32,
all on one device.  The at-rest blobs (`pack`/`unpack`, 10 bytes per triangle
and 14 per tetrahedron) and the 13-byte wire triples and 14-byte quads
(`pack_wire`/`unpack_wire`) are host numpy buffers, byte-identical to the
JAX package's for simplices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .errors import WireFormatError, not_ported

# The element class tags of the wire format, those of the JAX package
# (simplex 0, hex 1), so wire bytes agree and unknown tags are refused
# alike.  Only simplices are ported so far.
ECLASS_SIMPLEX = 0
ECLASS_HEX = 1
NUM_ECLASSES = 2


class Simplex(NamedTuple):
    """A batch of d-simplices (triangles or tetrahedra).

    anchor: (..., d) int32 — anchor node coordinates in [0, 2^MAXLEVEL).
    level:  (...,)  int32 — refinement level, 0 <= level <= MAXLEVEL.
    stype:  (...,)  int32 — type in [0, d!), cf. paper Definition 5.
    """

    anchor: torch.Tensor
    level: torch.Tensor
    stype: torch.Tensor

    @property
    def d(self) -> int:
        return self.anchor.shape[-1]

    @property
    def shape(self):
        return self.level.shape

    @property
    def device(self) -> torch.device:
        return self.anchor.device


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card, and raises if there
    is none (pass device="cpu" to run on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def simplex(anchor, level, stype, device=None) -> Simplex:
    """A `Simplex` from array-likes or tensors, as int32: on `device`, else
    on the anchor's own device if it is a tensor, else on the card
    (`resolve_device`).  Level and type are broadcast to the anchor's batch
    shape as contiguous columns."""
    if device is None and isinstance(anchor, torch.Tensor):
        device = anchor.device
    anchor = torch.as_tensor(anchor, device=resolve_device(device)).to(torch.int32)

    def col(x):
        x = torch.as_tensor(x, device=anchor.device).to(torch.int32)
        return x.expand(anchor.shape[:-1]).contiguous()

    return Simplex(anchor, col(level), col(stype))


def root(d: int, device=None) -> Simplex:
    """The root simplex T_d^0 (type 0, level 0, anchor at the origin), on
    `device` (the card by default, see `resolve_device`)."""
    dev = resolve_device(device)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return Simplex(torch.zeros(d, dtype=torch.int32, device=dev), z, z.clone())


def concat(simplices, dim: int = 0) -> Simplex:
    """Batches joined along `dim`."""
    return Simplex(*(torch.cat([getattr(s, k) for s in simplices], dim=dim)
                     for k in Simplex._fields))


def take(s: Simplex, idx) -> Simplex:
    """The elements `idx` of a batch (an index, slice, mask or index tensor)."""
    return Simplex(s.anchor[idx], s.level[idx], s.stype[idx])


def nbytes_at_rest(s: Simplex, eclass: int = ECLASS_SIMPLEX) -> int:
    """Storage per paper Remark 20: 4*d + 2 bytes a simplex (coordinates,
    level and type), so 10 a triangle and 14 a tetrahedron."""
    if eclass == ECLASS_HEX:
        raise not_ported("the at-rest size of hex elements", "hex")
    if eclass != ECLASS_SIMPLEX:
        raise ValueError(f"unknown element class {eclass!r}")
    return s.level.numel() * (4 * s.d + 2)


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (copied off the device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pack(s: Simplex) -> dict:
    """At-rest encoding (paper Remark 20): int32 coords + int8 level + int8
    type — 10 bytes per triangle, 14 per tetrahedron."""
    return {
        "anchor": to_numpy(s.anchor).astype(np.int32),
        "level": to_numpy(s.level).astype(np.int8),
        "stype": to_numpy(s.stype).astype(np.int8),
    }


def unpack(blob: dict, device) -> Simplex:
    """Inverse of `pack`, onto `device`."""
    def col(name):
        return torch.from_numpy(np.array(blob[name], dtype=np.int32)).to(device)

    return Simplex(col("anchor"), col("level"), col("stype"))


# ----------------------------------------------------------- wire encoding
# An element reference on the wire is the Remark-20 low-memory encoding: the
# level-padded key plus the level determine the element (Algorithm 4.8
# recovers anchor and type), so a (tree, key, level) triple is 13 bytes.  An
# optional extra byte rides along as a 14-byte quad (Ghost ships the dual
# face index in it).  The element class rides in bits 6-7 of the level byte
# (levels fit in six bits): 0 for the simplices of this port.  Unknown class
# bits are rejected like any other out-of-domain field; hex entries (class 1)
# wait for the hex slice.
WIRE_TRIPLE_BYTES = 13  # uint64 key + int32 tree + uint8 (eclass<<6 | level)
WIRE_QUAD_BYTES = 14    # ... + uint8 extra
WIRE_LEVEL_MASK = 0x3F
WIRE_ECLASS_SHIFT = 6


def _wire_dtype(with_extra: bool) -> np.dtype:
    fields = [("key", "<u8"), ("tree", "<i4"), ("level", "u1")]
    if with_extra:
        fields.append(("extra", "u1"))
    return np.dtype(fields)


def pack_wire(tree, key, level, extra=None) -> np.ndarray:
    """Pack (tree, key, level[, extra]) columns of simplices — tensors or
    arrays; keys int64 or uint64, never negative — into a flat uint8 wire
    buffer of 13-byte little-endian triples (14-byte quads with `extra`),
    byte-identical to the JAX package's."""
    tree = to_numpy(tree).astype(np.int32)
    key = to_numpy(key).astype(np.uint64)
    rec = np.empty(len(key), _wire_dtype(extra is not None))
    rec["key"], rec["tree"] = key, tree
    rec["level"] = to_numpy(level).astype(np.uint8)   # class bits 0: simplex
    if extra is not None:
        rec["extra"] = to_numpy(extra).astype(np.uint8)
    return rec.view(np.uint8).reshape(-1)


def unpack_wire(buf: np.ndarray, with_extra: bool = False):
    """Inverse of `pack_wire`: host numpy columns (tree int32, key uint64,
    level int32[, extra int32]).

    A buffer that is not a whole number of entries, a non-byte buffer, or
    entries with a negative tree or an unknown element class raise
    `WireFormatError`; hex entries raise NotImplementedError."""
    try:
        buf = np.asarray(buf, np.uint8).reshape(-1)
    except (ValueError, TypeError) as e:
        raise WireFormatError(f"wire buffer is not a byte array: {e}") from e
    dt = _wire_dtype(with_extra)
    if buf.size % dt.itemsize != 0:
        raise WireFormatError(
            f"wire buffer of {buf.size} byte(s) is not a whole number of "
            f"{dt.itemsize}-byte entries")
    rec = buf.view(dt)
    tree = rec["tree"].astype(np.int32)
    lv_byte = rec["level"].astype(np.int32)
    ec = lv_byte >> WIRE_ECLASS_SHIFT
    if rec.size:
        if int(tree.min()) < 0:
            raise WireFormatError(
                f"wire entries carry negative tree ids (min {int(tree.min())})")
        if int(ec.max()) >= NUM_ECLASSES:
            raise WireFormatError(
                f"wire entries carry an unknown element class "
                f"(max {int(ec.max())} >= {NUM_ECLASSES})")
        if (ec == ECLASS_HEX).any():
            raise not_ported("hex wire entries", "hex")
    out = (tree, rec["key"].astype(np.uint64), lv_byte & WIRE_LEVEL_MASK)
    if with_extra:
        out = out + (rec["extra"].astype(np.int32),)
    return out
