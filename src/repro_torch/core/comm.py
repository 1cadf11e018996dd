"""Communication layer for the forest algorithms, in-process part.

The forest code (`core.forest`) is written SPMD style: every rank computes
its own view, and all cross-rank data moves through two collectives,
`allgather` and `alltoallv`, over per-local-rank payload lists.  `Comm`
meters the bytes that would cross a rank boundary into per-phase counters
(`comm.phase("partition")`, `bytes_for`) at post time; `SimComm(P)` hosts
all P ranks in this process and `LocalComm()` is the single-rank world.
Each collective also exists nonblocking (`iallgather`/`ialltoallv` return a
`CommHandle`); the in-process bindings complete at post.

Payloads are nested tuples/lists/dicts of host numpy arrays and scalars —
the element wire triples of `core.types.pack_wire`, never device tensors.
`encode_payload`/`decode_payload` are the wire codec, byte-identical to the
JAX package's `repro.core.comm`, so per-phase byte counts agree with it.
"""

from __future__ import annotations

import contextlib
import struct
from typing import Callable, Sequence

import numpy as np

from .errors import WireFormatError

__all__ = [
    "Comm",
    "CommHandle",
    "SimComm",
    "LocalComm",
    "payload_nbytes",
    "encode_payload",
    "decode_payload",
    "WireFormatError",
]


# ------------------------------------------------------------- byte metering
def payload_nbytes(obj) -> int:
    """Wire size of a nested payload (arrays dominate; scalars count 8)."""
    if obj is None:
        return 1
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, str):
        return len(obj.encode())
    if isinstance(obj, (bool, int, float, np.integer, np.floating, np.bool_)):
        return 8
    if isinstance(obj, dict):
        return sum(payload_nbytes(k) + payload_nbytes(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return sum(payload_nbytes(v) for v in obj)
    raise TypeError(f"unsupported payload type {type(obj)!r}")


# ------------------------------------------------------- wire serialization
# Self-describing tagged format for the payload types above, byte for byte
# the JAX package's codec (the bytes a rank ships are part of the result).
# No pickle: only data, no code.
def _enc(obj, out: list) -> None:
    if obj is None:
        out.append(b"N")
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"T" if obj else b"F")
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if 0 <= v < 1 << 64:
            out.append(b"u" + struct.pack("<Q", v))
        elif -(1 << 63) <= v < 1 << 63:
            out.append(b"i" + struct.pack("<q", v))
        else:  # arbitrary precision fallback
            s = str(v).encode()
            out.append(b"I" + struct.pack("<I", len(s)) + s)
    elif isinstance(obj, (float, np.floating)):
        out.append(b"f" + struct.pack("<d", float(obj)))
    elif isinstance(obj, str):
        s = obj.encode()
        out.append(b"s" + struct.pack("<I", len(s)) + s)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(b"y" + struct.pack("<I", len(obj)) + bytes(obj))
    elif isinstance(obj, np.ndarray):
        if obj.dtype.names is not None:
            raise TypeError("structured dtypes are not wire types")
        dt = obj.dtype.str.encode()
        a = np.ascontiguousarray(obj)
        out.append(b"a" + struct.pack("<B", len(dt)) + dt
                   + struct.pack("<B", a.ndim)
                   + struct.pack(f"<{a.ndim}I", *a.shape)
                   + a.tobytes())
    elif isinstance(obj, (list, tuple)):
        out.append((b"l" if isinstance(obj, list) else b"t")
                   + struct.pack("<I", len(obj)))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, dict):
        out.append(b"d" + struct.pack("<I", len(obj)))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    else:
        raise TypeError(f"unsupported payload type {type(obj)!r}")


def encode_payload(obj) -> bytes:
    out: list = []
    _enc(obj, out)
    return b"".join(out)


def _need(buf: bytes, off: int, n: int, what: str) -> None:
    """Bounds check: the next `n` bytes must exist, else the buffer is
    truncated — a structured `WireFormatError`, never an IndexError or a
    short `struct.error` read."""
    if n < 0 or off + n > len(buf):
        raise WireFormatError(
            f"truncated wire payload: need {n} byte(s) for {what} at "
            f"offset {off}, have {len(buf) - off}")


def _dec(buf: bytes, off: int):
    _need(buf, off, 1, "tag")
    tag = buf[off:off + 1]
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"u":
        _need(buf, off, 8, "u64")
        return struct.unpack_from("<Q", buf, off)[0], off + 8
    if tag == b"i":
        _need(buf, off, 8, "i64")
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if tag == b"I":
        _need(buf, off, 4, "bigint length")
        n = struct.unpack_from("<I", buf, off)[0]
        _need(buf, off + 4, n, "bigint digits")
        try:
            v = int(buf[off + 4:off + 4 + n].decode())
        except (UnicodeDecodeError, ValueError) as e:
            raise WireFormatError(
                f"malformed bigint in wire payload at offset {off}: {e}"
            ) from e
        return v, off + 4 + n
    if tag == b"f":
        _need(buf, off, 8, "f64")
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if tag == b"s":
        _need(buf, off, 4, "string length")
        n = struct.unpack_from("<I", buf, off)[0]
        _need(buf, off + 4, n, "string bytes")
        try:
            s = buf[off + 4:off + 4 + n].decode()
        except UnicodeDecodeError as e:
            raise WireFormatError(
                f"malformed utf-8 string in wire payload at offset {off}: {e}"
            ) from e
        return s, off + 4 + n
    if tag == b"y":
        _need(buf, off, 4, "bytes length")
        n = struct.unpack_from("<I", buf, off)[0]
        _need(buf, off + 4, n, "bytes body")
        return buf[off + 4:off + 4 + n], off + 4 + n
    if tag == b"a":
        _need(buf, off, 1, "dtype length")
        dl = struct.unpack_from("<B", buf, off)[0]
        off += 1
        _need(buf, off, dl, "dtype string")
        try:
            dt = np.dtype(buf[off:off + dl].decode())
        except (UnicodeDecodeError, TypeError, ValueError) as e:
            raise WireFormatError(
                f"bad array dtype in wire payload at offset {off}: {e}"
            ) from e
        if dt.hasobject:
            raise WireFormatError(
                f"object dtype {dt!r} is not a wire type (offset {off})")
        off += dl
        _need(buf, off, 1, "ndim")
        ndim = struct.unpack_from("<B", buf, off)[0]
        off += 1
        _need(buf, off, 4 * ndim, "shape")
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
        off += 4 * ndim
        n = 1
        for s in shape:
            n *= int(s)
        if not ndim:
            n = 1
        nb = n * dt.itemsize
        _need(buf, off, nb, f"array body {dt.str}{tuple(shape)}")
        try:
            arr = np.frombuffer(buf[off:off + nb], dt).reshape(shape).copy()
        except (ValueError, TypeError) as e:
            raise WireFormatError(
                f"malformed array in wire payload at offset {off}: {e}"
            ) from e
        return arr, off + nb
    if tag in (b"l", b"t"):
        _need(buf, off, 4, "sequence count")
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        # every element takes >= 1 byte, so a count beyond the remaining
        # bytes is garbage — reject before allocating or looping on it
        _need(buf, off, n, f"{n} sequence element(s)")
        items = []
        for _ in range(n):
            v, off = _dec(buf, off)
            items.append(v)
        return (items if tag == b"l" else tuple(items)), off
    if tag == b"d":
        _need(buf, off, 4, "dict count")
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        _need(buf, off, 2 * n, f"{n} dict item(s)")
        d = {}
        for _ in range(n):
            k, off = _dec(buf, off)
            v, off = _dec(buf, off)
            try:
                d[k] = v
            except TypeError as e:  # unhashable decoded key
                raise WireFormatError(
                    f"unhashable dict key in wire payload at offset {off}: {e}"
                ) from e
        return d, off
    raise WireFormatError(f"bad wire tag {tag!r} at offset {off - 1}")


def decode_payload(buf: bytes):
    """Decode one `encode_payload` buffer.  Malformed input of ANY shape —
    truncation, trailing garbage, bad tags, bogus counts/dtypes — raises a
    structured `WireFormatError` (a ValueError subclass); it never leaks a
    bare `struct.error`, never returns silently wrong columns."""
    buf = bytes(buf)
    try:
        obj, off = _dec(buf, 0)
    except WireFormatError:
        raise
    except (struct.error, ValueError, TypeError, OverflowError,
            MemoryError, RecursionError) as e:
        raise WireFormatError(f"malformed wire payload: {e}") from e
    if off != len(buf):
        raise WireFormatError(
            f"trailing bytes in wire payload: decoded {off} of {len(buf)}")
    return obj


# ------------------------------------------------------------------ handles
class CommHandle:
    """Waitable result of a nonblocking collective (`iallgather` /
    `ialltoallv`): `wait()` delivers the collective's result (idempotent).
    Handles of one communicator are waited in posting order, identically on
    every rank."""

    __slots__ = ("_complete", "_result", "_done")

    def __init__(self, complete: Callable | None = None, result=None, done: bool = False):
        self._complete = complete
        self._result = result
        self._done = done

    @classmethod
    def ready(cls, result) -> "CommHandle":
        """An already-completed handle (immediate transports, e.g. SimComm)."""
        return cls(result=result, done=True)

    def done(self) -> bool:
        """True once the collective's data is available."""
        return self._done

    def wait(self):
        """Deliver the result, blocking if the exchange is still in flight."""
        if not self._done:
            self._result = self._complete()
            self._complete = None
            self._done = True
        return self._result


# ----------------------------------------------------------------- the seam
class Comm:
    """Abstract communicator: rank/size plus the two forest collectives.

    `local_ranks` lists the global ranks resident in this process; every
    collective consumes a list with one payload per local rank and returns,
    per local rank, the global view (`allgather`: length-P list; `alltoallv`:
    length-P list of what each global rank sent here).  Subclasses implement
    `_allgather` / `_alltoallv` (and optionally the nonblocking forms, which
    default to completion at post); the base class meters byte volume into
    per-phase counters at post time.
    """

    size: int
    rank: int            # first (usually only) local rank
    local_ranks: range

    def __init__(self):
        self.counters: dict = {}
        self._phases: list[str] = []

    # -- metering ----------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute subsequent traffic to `name` (nested phases stack; the
        innermost label wins)."""
        self._phases.append(name)
        try:
            yield self
        finally:
            self._phases.pop()

    def _bucket(self) -> dict:
        name = self._phases[-1] if self._phases else "default"
        return self.counters.setdefault(
            name, {"allgather_bytes": 0, "alltoallv_bytes": 0,
                   "allgather_calls": 0, "alltoallv_calls": 0})

    def bytes_for(self, phase: str | None = None) -> int:
        """Total bytes crossing rank boundaries (one phase, or all)."""
        buckets = ([self.counters.get(phase, {})] if phase is not None
                   else list(self.counters.values()))
        return sum(b.get("allgather_bytes", 0) + b.get("alltoallv_bytes", 0)
                   for b in buckets)

    # -- collectives -------------------------------------------------------
    def allgather(self, per_local: Sequence) -> list:
        """per_local[i] from local rank i -> full per-global-rank list."""
        return self.iallgather(per_local).wait()

    def alltoallv(self, send: Sequence[Sequence]) -> list:
        """send[i][q]: payload from local rank i to global rank q.
        Returns recv[i][p]: what global rank p sent to local rank i."""
        return self.ialltoallv(send).wait()

    def iallgather(self, per_local: Sequence) -> CommHandle:
        """Nonblocking `allgather`: posts the exchange, meters its bytes to
        the phase active NOW, and returns a waitable `CommHandle`."""
        if len(per_local) != len(self.local_ranks):
            raise ValueError("need one payload per local rank")
        b = self._bucket()
        b["allgather_calls"] += 1
        b["allgather_bytes"] += sum(
            payload_nbytes(x) * (self.size - 1) for x in per_local)
        return self._iallgather(list(per_local))

    def ialltoallv(self, send: Sequence[Sequence]) -> CommHandle:
        """Nonblocking `alltoallv`: posts, meters at post time, returns a
        `CommHandle` delivering recv[i][p] on `wait()`."""
        if len(send) != len(self.local_ranks) or any(len(r) != self.size for r in send):
            raise ValueError("need one row of P payloads per local rank")
        b = self._bucket()
        b["alltoallv_calls"] += 1
        for i, g in enumerate(self.local_ranks):
            b["alltoallv_bytes"] += sum(
                payload_nbytes(x) for q, x in enumerate(send[i]) if q != g)
        return self._ialltoallv([list(row) for row in send])

    def barrier(self) -> None:
        """Wait until every rank reaches this point (a no-op in one
        process: `SimComm` and `LocalComm` host every rank here)."""

    def _allgather(self, per_local: list) -> list:
        raise NotImplementedError

    def _alltoallv(self, send: list) -> list:
        raise NotImplementedError

    def _iallgather(self, per_local: list) -> CommHandle:
        return CommHandle.ready(self._allgather(per_local))

    def _ialltoallv(self, send: list) -> CommHandle:
        return CommHandle.ready(self._alltoallv(send))


class SimComm(Comm):
    """All P ranks in this process.  Collectives are list shuffles; the byte
    counters still meter what WOULD cross rank boundaries."""

    def __init__(self, num_ranks: int):
        super().__init__()
        self.size = num_ranks
        self.rank = 0
        self.local_ranks = range(num_ranks)

    def _allgather(self, per_local: list) -> list:
        return list(per_local)

    def _alltoallv(self, send: list) -> list:
        P = self.size
        return [[send[p][q] for p in range(P)] for q in range(P)]


class LocalComm(SimComm):
    """Degenerate single-rank world: every collective is the identity."""

    def __init__(self):
        super().__init__(1)
