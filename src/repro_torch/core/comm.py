"""Communication layer for the forest algorithms: one `Comm` surface,
three bindings.

The forest code (`core.forest`) is written SPMD style: every rank computes
its own view, and all cross-rank data moves through two collectives,
`allgather` and `alltoallv`, over per-local-rank payload lists.  A process
may host one rank or all P ranks; `local_ranks` says which global ranks are
resident, so the same forest code runs unchanged under either hosting:

  SimComm(P)   all P ranks in this process; collectives are list shuffles.
  LocalComm()  the degenerate single-rank world.
  DistComm()   one rank a process, bound to mpi4py when an initialized world
               of more than one process exists, otherwise to a
               `torch.distributed.TCPStore` (each payload travels through the
               store's key-value space).

Every collective also exists nonblocking (`iallgather` / `ialltoallv` return
a `CommHandle` whose `wait()` delivers what the blocking call would; the
blocking calls are post + wait).  `SimComm` handles complete at post,
`DistComm` posts store writes or MPI exchanges and blocks only in `wait()`,
and `LatencyComm` simulates a round-trip time so overlap can be measured in
one process.  Handles of one communicator are waited in posting order, the
same on every rank; a handle that polls `done() == True` has a free
`wait()`.  With a deadline (`set_deadline`), a wait past it raises a
`CommTimeoutError` naming the phase, the collective and the pending peers.

Payloads are nested tuples/lists/dicts of host numpy arrays and scalars —
the element wire triples of `core.types.pack_wire`, never device tensors.
`encode_payload`/`decode_payload` are the wire codec and `frame_blob` /
`unframe_blob` its integrity frame, byte-identical to the JAX package's
`repro.core.comm`, so per-phase byte counts (metered at post time into
`comm.phase(...)` counters) and wire digests agree with it.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import os
import random
import struct
import time
import zlib
from typing import Callable, Sequence

import numpy as np

from .errors import CommTimeoutError, WireFormatError, WireIntegrityError

__all__ = [
    "Comm",
    "CommHandle",
    "SimComm",
    "LocalComm",
    "LatencyComm",
    "DistComm",
    "payload_nbytes",
    "encode_payload",
    "decode_payload",
    "frame_blob",
    "unframe_blob",
    "WireFormatError",
    "WireIntegrityError",
    "CommTimeoutError",
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


# ---------------------------------------------------------- integrity frame
# Every blob a DistComm transport moves travels inside a 16-byte integrity
# frame: magic, u64 body length, CRC32 of the body.  `unframe_blob` turns
# corruption, truncation and duplication into a typed `WireIntegrityError`
# instead of a downstream mis-decode.  Framing lives strictly BETWEEN the
# codec and the transport: byte meters and `wire_digest()` both see the
# unframed payload blobs, so digests stay comparable across bindings and
# with the in-process simulators.  Byte for byte the JAX package's frame.
_FRAME = struct.Struct("<4sQI")
_FRAME_MAGIC = b"RW01"


def frame_blob(blob: bytes) -> bytes:
    """Wrap a payload blob for the wire: magic + length + CRC32 header."""
    blob = bytes(blob)
    return _FRAME.pack(_FRAME_MAGIC, len(blob), zlib.crc32(blob)) + blob


def unframe_blob(buf: bytes, *, where: str = "") -> bytes:
    """Verify and strip a `frame_blob` header; raises `WireIntegrityError`
    (tagged with `where`: phase/generation/peer) on any mismatch."""
    buf = bytes(buf)
    if len(buf) < _FRAME.size:
        raise WireIntegrityError("frame shorter than header", where=where,
                                 expected=_FRAME.size, actual=len(buf))
    magic, length, crc = _FRAME.unpack_from(buf, 0)
    if magic != _FRAME_MAGIC:
        raise WireIntegrityError("bad frame magic", where=where,
                                 expected=_FRAME_MAGIC, actual=magic)
    body = buf[_FRAME.size:]
    if len(body) != length:
        raise WireIntegrityError("frame length mismatch", where=where,
                                 expected=int(length), actual=len(body))
    got = zlib.crc32(body)
    if got != crc:
        raise WireIntegrityError("frame checksum mismatch", where=where,
                                 expected=int(crc), actual=int(got))
    return body


# ------------------------------------------------------------------ handles
class CommHandle:
    """Waitable result of a nonblocking collective (`iallgather` /
    `ialltoallv`).

    `wait()` blocks until delivery and returns the collective's result
    (idempotent).  `done()` polls without blocking and also drives the
    transport's progress; once it returns True, `wait()` performs no
    further transport round-trips.  Handles are waited in posting order,
    identically on every rank.

    The posting `Comm` stamps every handle with the `phase` active at post
    time, a monotonically increasing `seq` and, when the comm has a deadline
    (`comm.set_deadline(s)`, off by default), a wall-clock deadline.  A
    deadlined `wait()` drives the poll in an exponential-backoff + jitter
    loop and raises a `CommTimeoutError` (phase, seq, elapsed, retries,
    pending peers, liveness detail) instead of hanging; without a deadline
    `wait()` is the single blocking transport call.
    """

    __slots__ = ("_complete", "_poll", "_result", "_done",
                 "phase", "seq", "_deadline", "_pending", "_diagnose")

    def __init__(self, complete: Callable | None = None,
                 poll: Callable[[], bool] | None = None,
                 result=None, done: bool = False):
        self._complete = complete
        self._poll = poll
        self._result = result
        self._done = done
        self.phase = "default"
        self.seq = -1
        self._deadline = None    # absolute time.monotonic() bound, or None
        self._pending = None     # () -> [peer ranks not yet delivered]
        self._diagnose = None    # () -> detail dict for CommTimeoutError

    @classmethod
    def ready(cls, result) -> "CommHandle":
        """An already-completed handle (immediate transports, e.g. SimComm)."""
        return cls(result=result, done=True)

    def done(self) -> bool:
        """True once the collective's data is available — `wait()` will not
        block on peers and performs no transport round-trips.  A deferred
        handle whose binding supplied no poll reports False."""
        if self._done:
            return True
        if self._poll is not None:
            return self._poll()
        return False

    def wait(self, timeout: float | None = None):
        """Deliver the result, blocking if the exchange is still in flight.

        With a deadline (stamped at post time, or the tighter of that and
        an explicit `timeout`), completion is driven through the poll with
        exponential backoff + jitter and expiry raises `CommTimeoutError`;
        with none (the default), this is one blocking transport call."""
        if self._done:
            return self._result
        deadline = self._deadline
        if timeout is not None:
            t = time.monotonic() + timeout
            deadline = t if deadline is None else min(deadline, t)
        if deadline is not None and self._poll is not None:
            start = time.monotonic()
            retries = 0
            delay = 0.0005
            while not self._poll():
                now = time.monotonic()
                if now >= deadline:
                    raise CommTimeoutError(
                        phase=self.phase, seq=self.seq,
                        elapsed_s=now - start, retries=retries,
                        pending=self._pending() if self._pending else None,
                        detail=self._diagnose() if self._diagnose else None)
                retries += 1
                time.sleep(min(delay, deadline - now) * (0.5 + random.random()))
                delay = min(delay * 2.0, 0.05)
        self._result = self._complete()
        self._complete = self._poll = None
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
    per-phase counters at post time and stamps every handle.
    """

    size: int
    rank: int            # first (usually only) local rank
    local_ranks: range
    deadline_s: float | None = None   # per-collective wait budget (opt-in)

    def __init__(self):
        self.counters: dict = {}
        self._phases: list[str] = []
        self._hseq = 0

    def set_deadline(self, seconds: float | None) -> None:
        """Give every subsequently posted collective a wall-clock wait
        budget: `wait()` past it raises `CommTimeoutError` naming the phase,
        seq, and (where the transport knows) the pending peers.  `None` (the
        default) restores plain blocking waits."""
        self.deadline_s = seconds

    def _stamp(self, h: CommHandle) -> CommHandle:
        """Tag a freshly posted handle with phase/seq/deadline context."""
        self._hseq += 1
        h.seq = self._hseq
        h.phase = self._phases[-1] if self._phases else "default"
        if self.deadline_s is not None and not h._done:
            h._deadline = time.monotonic() + self.deadline_s
        return h

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

    def stats(self) -> dict:
        """The per-phase counters, copied, plus "total_bytes"."""
        out = {k: dict(v) for k, v in self.counters.items()}
        out["total_bytes"] = self.bytes_for()
        return out

    def reset_counters(self) -> None:
        self.counters.clear()

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
        return self._stamp(self._iallgather(list(per_local)))

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
        return self._stamp(self._ialltoallv([list(row) for row in send]))

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


class LatencyComm(SimComm):
    """SimComm plus a simulated per-collective round-trip time.

    A collective's result is not deliverable until `latency_s` after it was
    posted: blocking calls pay the full latency, while a nonblocking handle
    matures in the background and `wait()` sleeps only what the caller's
    compute did not already cover.  Results are bit-identical to `SimComm`;
    only timing changes.
    """

    def __init__(self, num_ranks: int, latency_s: float = 0.0):
        super().__init__(num_ranks)
        self.latency_s = latency_s

    def _delayed(self, result) -> CommHandle:
        ready_at = time.monotonic() + self.latency_s

        def complete():
            rem = ready_at - time.monotonic()
            if rem > 0:
                time.sleep(rem)
            return result

        return CommHandle(complete, poll=lambda: time.monotonic() >= ready_at)

    def _iallgather(self, per_local: list) -> CommHandle:
        return self._delayed(self._allgather(per_local))

    def _ialltoallv(self, send: list) -> CommHandle:
        return self._delayed(self._alltoallv(send))


# ------------------------------------------------------------- DistComm
# TCPStore's libuv server refuses a value past 8 MiB; a blob past one chunk
# travels as sub-keys (see `DistComm._kv_post`).
_KV_CHUNK = 1 << 20
_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# One store a rendezvous a process (rank 0 hosts the server, so a second
# instance could not bind its port): every DistComm made from the same
# rendezvous variables shares it, as the reference's instances share the
# process's jax.distributed client.
_ENV_STORES: dict = {}


def _env_store(timeout_s: float):
    """(store, rank, size) from torch's rendezvous variables; rank 0 hosts
    the store.  Raises RuntimeError naming the variables when one is
    missing."""
    missing = [v for v in _RENDEZVOUS if v not in os.environ]
    if missing:
        raise RuntimeError(
            "DistComm needs a torch.distributed.TCPStore (store=, with rank= and "
            "size=), torch's rendezvous variables MASTER_ADDR, MASTER_PORT, RANK and "
            f"WORLD_SIZE (missing: {', '.join(missing)}), or an initialized mpi4py "
            "world of more than one process")
    addr, port = os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    key = (addr, port, rank, size)
    store = _ENV_STORES.get(key)
    if store is None:
        from torch.distributed import TCPStore  # noqa: PLC0415

        store = _ENV_STORES[key] = TCPStore(
            addr, port, size, is_master=rank == 0,
            timeout=datetime.timedelta(seconds=timeout_s), wait_for_workers=False)
    return store, rank, size


def _store_miss():
    """The error type a TCPStore raises for a key that is not there (yet)."""
    from torch.distributed import DistStoreError  # noqa: PLC0415

    return DistStoreError


class DistComm(Comm):
    """One rank a process, over mpi4py or a `torch.distributed.TCPStore`.

    Binding order: an initialized mpi4py world with more than one process
    wins; otherwise payloads travel through a TCPStore — the one passed as
    `store=` (with `rank=` and `size=`), or one made from torch's
    rendezvous variables
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE, hosted by rank 0.  Each
    exchange posts one key per peer per generation, deleted by its single
    reader right after the fetch, so no cleanup barrier is needed anywhere.
    Either way the surface is `SimComm`'s with `local_ranks == [rank]`, so
    the forest algorithms run unmodified.

    Both transports move exactly the `encode_payload` buffers inside their
    integrity frames (the mpi4py binding as MPI.BYTE point-to-point pairs
    and native Iallgather + Iallgatherv, never pickle), so the bindings are
    byte-for-byte interchangeable with each other and with the JAX package's
    `DistComm`; `wire_digest()` is a running sha256 over every posted
    payload blob.

    Nonblocking: `iallgather`/`ialltoallv` post and return a `CommHandle`;
    the receive side runs in `wait()`, and `done()` polls (it drives MPI's
    progress, or probes the store without blocking and caches what it
    fetches).
    Once `done()` is True, `wait()` is free.  `namespace` isolates several
    instances sharing one store or MPI world (an overlapped and a
    serialized run): it prefixes the keys, and gives the mpi4py binding its
    own duplicated communicator.  `beacon` (store only, opt-in) leaves a
    breadcrumb key per posted generation, so a survivor's
    `CommTimeoutError` reports each dead peer's last-alive generation.  The
    store's own timeout is set to `timeout_s`.
    """

    def __init__(self, timeout_s: float = 120.0, namespace: str = "",
                 beacon: bool = False, *, store=None, rank: int | None = None,
                 size: int | None = None):
        super().__init__()
        self._timeout_ms = int(timeout_s * 1000)
        self._ns = namespace
        self._gen = 0
        self._mpi = None
        self._MPI = None
        self._store = None
        self._wire = hashlib.sha256()
        self.retry_counts: dict[str, int] = {}
        mpi = self._try_mpi()
        if mpi is not None:
            from mpi4py import MPI  # noqa: PLC0415

            # a namespaced instance needs its own tag-matching space: MPI
            # matches by (source, tag, communicator), and two instances with
            # independent generation counters would cross-match on a shared
            # communicator (Dup is collective — every rank builds its
            # instances in the same order).  `close()` frees the dup.
            self._owns_mpi = bool(namespace)
            self._mpi = mpi.Dup() if namespace else mpi
            self._MPI = MPI
            self.rank = mpi.Get_rank()
            self.size = mpi.Get_size()
        else:
            if store is None:
                store, rank, size = _env_store(timeout_s)
            elif rank is None or size is None:
                raise RuntimeError("DistComm(store=...) needs rank= and size=")
            store.set_timeout(datetime.timedelta(seconds=timeout_s))
            self._store = store
            self.rank, self.size = int(rank), int(size)
        self._beacon = bool(beacon) and self._store is not None
        self.local_ranks = range(self.rank, self.rank + 1)

    @classmethod
    def _testing_instance(cls, rank: int, size: int, *, mpi=None, MPI=None,
                          store=None, timeout_s: float = 5.0,
                          namespace: str = "", beacon: bool = False) -> "DistComm":
        """Build a DistComm over injected transports (a fake MPI module and
        communicator, or an object with TCPStore's interface) without a
        runtime — the offline transport tests."""
        self = cls.__new__(cls)
        Comm.__init__(self)
        self._timeout_ms = int(timeout_s * 1000)
        self._ns = namespace
        self._gen = 0
        self._mpi = mpi
        self._MPI = MPI
        self._store = store
        self._wire = hashlib.sha256()
        self.retry_counts = {}
        self._beacon = bool(beacon) and store is not None
        self.rank = rank
        self.size = size
        self.local_ranks = range(rank, rank + 1)
        return self

    @staticmethod
    def _try_mpi():
        try:
            from mpi4py import MPI  # noqa: PLC0415
        except ImportError:
            return None
        if not MPI.Is_initialized() or MPI.COMM_WORLD.Get_size() < 2:
            return None
        return MPI.COMM_WORLD

    @property
    def store(self):
        """The bound TCPStore (None under mpi4py): pass it as `store=` to a
        second instance in another namespace."""
        return self._store

    def close(self) -> None:
        """Release owned transport resources: frees the communicator a
        namespaced mpi4py binding Dup()ed (collective — close on every rank,
        after all handles are waited).  The store binding holds nothing
        beyond per-generation keys, which each exchange already cleans."""
        if getattr(self, "_owns_mpi", False) and self._mpi is not None:
            self._mpi.Free()
            self._mpi = None
            self._owns_mpi = False

    # -- wire accounting ---------------------------------------------------
    def _wire_update(self, outbox: dict[int, bytes]) -> None:
        """Fold every posted payload blob into the running wire digest, in
        deterministic (peer, length, bytes) order — transport independent."""
        for q in sorted(outbox):
            self._wire.update(struct.pack("<II", q, len(outbox[q])))
            self._wire.update(outbox[q])

    def wire_digest(self) -> str:
        """sha256 over every payload blob this rank has posted so far; equal
        runs over either transport yield equal digests."""
        return self._wire.hexdigest()

    # -- key-value (TCPStore) transport ------------------------------------
    # Every exchange posts one payload key per peer (both collectives build
    # a full outbox — an empty alltoallv row still encodes as b"N"), so the
    # key's presence IS the posted signal, and cleanup is reader-side (rank
    # q deletes `p>q` right after fetching it — one reader per key).  A
    # framed blob longer than _KV_CHUNK is split: its chunks 1.. go under
    # `<key>/1`, `<key>/2`, ... first, then chunk 0 (which holds the frame
    # header, and so the blob's length) under the key itself.  Fetched blobs
    # are cached in the exchange state, so once the poll has seen every
    # peer (`done() == True`), `wait()` touches the store zero times.
    def _key(self, gen: int, tag: str, rest: str) -> str:
        return f"repro_comm/{self._ns}{gen}/{tag}/{rest}"

    def _bkey(self, rank: int, gen: int) -> str:
        return f"repro_beacon/{self._ns}/{rank}/{gen}"

    @staticmethod
    def _nchunks(first: bytes) -> int:
        """How many chunks the blob starting with `first` spans: one unless
        `first` is a full chunk carrying a well-formed frame header."""
        if len(first) < _KV_CHUNK:
            return 1
        magic, length, _crc = _FRAME.unpack_from(first, 0)
        if magic != _FRAME_MAGIC:
            return 1
        return max(1, -(-(_FRAME.size + int(length)) // _KV_CHUNK))

    def _kv_post(self, outbox: dict[int, bytes], tag: str):
        """Publish outbox[q] for each rank q; the exchange state carries the
        inbox cache that the poll and the wait fill cooperatively."""
        s = self._store
        gen = self._gen
        self._gen += 1
        me = self.rank
        for q, blob in outbox.items():
            key = self._key(gen, tag, f"{me}>{q}")
            for i in range(1, -(-len(blob) // _KV_CHUNK)):
                s.set(f"{key}/{i}", blob[i * _KV_CHUNK:(i + 1) * _KV_CHUNK])
            s.set(key, blob[:_KV_CHUNK])
        if self._beacon:
            s.set(self._bkey(me, gen), frame_blob(struct.pack("<Q", gen)))
        return {"gen": gen, "tag": tag, "inbox": {},
                "phase": self._phases[-1] if self._phases else "default"}

    def _kv_fetch(self, st, p: int, timeout_ms: int) -> None:
        """Fetch-and-delete peer p's payload into the inbox cache: wait up
        to `timeout_ms` for its key (raises the store's DistStoreError on
        timeout), then read and delete the key and its chunk keys (the
        single-reader delete is the exchange's only cleanup)."""
        s = self._store
        key = self._key(st["gen"], st["tag"], f"{p}>{self.rank}")
        s.wait([key], datetime.timedelta(milliseconds=timeout_ms))
        first = s.get(key)
        rest = [f"{key}/{i}" for i in range(1, self._nchunks(first))]
        st["inbox"][p] = b"".join([first, *(s.get(k) for k in rest)])
        for k in (key, *rest):
            s.delete_key(k)

    def _kv_complete(self, st) -> dict[int, bytes]:
        """Blocking receive side: fetch whatever the poll has not already
        cached — short probes in a bounded exponential-backoff + jitter loop,
        so a dead peer surfaces as a `CommTimeoutError` carrying the phase,
        the generation, the pending peers and (beacon on) each one's
        last-alive generation.  Returns {p: payload_from_p}; no barrier, and
        no store traffic at all when the handle already polled done."""
        miss = _store_miss()
        missing = [p for p in range(self.size)
                   if p != self.rank and p not in st["inbox"]]
        if not missing:
            return st["inbox"]
        start = time.monotonic()
        deadline = start + self._timeout_ms / 1000.0
        probe_ms = max(1, min(50, self._timeout_ms))
        retries = 0
        delay = 0.0005
        while True:
            for p in list(missing):
                try:
                    self._kv_fetch(st, p, probe_ms)
                    missing.remove(p)
                except miss:  # not posted yet
                    pass
            if not missing:
                if retries:
                    ph = st["phase"]
                    self.retry_counts[ph] = self.retry_counts.get(ph, 0) + retries
                return st["inbox"]
            now = time.monotonic()
            if now >= deadline:
                ph = st["phase"]
                self.retry_counts[ph] = self.retry_counts.get(ph, 0) + retries
                raise CommTimeoutError(
                    phase=ph, seq=st["gen"], elapsed_s=now - start,
                    retries=retries, rank=self.rank, size=self.size,
                    pending=missing, detail=self._beacon_probe(missing))
            retries += 1
            time.sleep(min(delay, deadline - now) * (0.5 + random.random()))
            delay = min(delay * 2.0, 0.05)

    def _beacon_probe(self, peers) -> dict:
        """Last-alive generation per stalled peer (-1 if none seen in the
        probe window).  Beacon keys are write-only breadcrumbs, never deleted
        while the run lives, so this is a read-only diagnosis."""
        if not self._beacon:
            return {}
        out = {}
        lo = max(0, self._gen - 16)
        for p in peers:
            out[int(p)] = next((g for g in range(self._gen, lo - 1, -1)
                                if self._store.check([self._bkey(p, g)])), -1)
        return {"last_alive_gen": out}

    def _kv_ready(self, st) -> bool:
        """The poll, which drives progress: probe the missing peers' keys
        without blocking (`check`) and cache (and clean up) whatever has
        landed, so a True return means `wait()` is store-free."""
        for p in range(self.size):
            if p == self.rank or p in st["inbox"]:
                continue
            if not self._store.check([self._key(st["gen"], st["tag"], f"{p}>{self.rank}")]):
                return False
            self._kv_fetch(st, p, self._timeout_ms)   # posted: returns at once
        return True

    # -- mpi4py transport --------------------------------------------------
    # Point-to-point packed exchange (alltoallv): each peer gets an 8-byte
    # length header then the framed blob, both as MPI.BYTE-class buffers (no
    # pickle).  Sends and header receives post immediately; payload receives
    # post once the headers have sized their buffers (in wait() or the
    # poll).  Allgather rides the native nonblocking collectives instead
    # (O(log P) fan-out), over the same blobs and the same wire digest.
    def _mpi_post(self, outbox: dict[int, bytes]):
        MPI, w = self._MPI, self._mpi
        gen = self._gen
        self._gen += 1
        t_hdr = (2 * gen) % 32000
        t_pay = t_hdr + 1
        keep, sreqs = [], []
        for q, blob in outbox.items():
            hdr = np.array([len(blob)], np.int64)
            buf = np.frombuffer(blob, np.uint8) if blob else np.zeros(0, np.uint8)
            keep.append((hdr, buf))
            sreqs.append(w.Isend([hdr, MPI.INT64_T], dest=q, tag=t_hdr))
            sreqs.append(w.Isend([buf, MPI.BYTE], dest=q, tag=t_pay))
        peers = [p for p in range(self.size) if p != self.rank]
        rhdr = {p: np.empty(1, np.int64) for p in peers}
        rreq = [w.Irecv([rhdr[p], MPI.INT64_T], source=p, tag=t_hdr)
                for p in peers]
        return {"keep": keep, "sreqs": sreqs, "peers": peers,
                "rhdr": rhdr, "rreq": rreq, "t_pay": t_pay}

    def _mpi_payload_recvs(self, st) -> None:
        """Once the headers are in, size the buffers and post the payload
        receives (idempotent; shared by the poll and the blocking wait)."""
        if "bufs" in st:
            return
        MPI, w = self._MPI, self._mpi
        st["bufs"] = {p: np.empty(int(st["rhdr"][p][0]), np.uint8)
                      for p in st["peers"]}
        st["preq"] = [w.Irecv([st["bufs"][p], MPI.BYTE], source=p,
                              tag=st["t_pay"])
                      for p in st["peers"]]

    def _mpi_complete(self, st) -> dict[int, bytes]:
        MPI = self._MPI
        if "bufs" not in st:
            MPI.Request.Waitall(st["rreq"])
            self._mpi_payload_recvs(st)
        MPI.Request.Waitall(st["preq"])
        MPI.Request.Waitall(st["sreqs"])
        return {p: st["bufs"][p].tobytes() for p in st["peers"]}

    def _mpi_test(self, st) -> bool:
        """The nonblocking poll, which drives progress: posts the payload
        receives as soon as the headers have completed, and reports True
        only when payloads AND sends are done — `wait()` will not block."""
        MPI = self._MPI
        if "bufs" not in st:
            if not MPI.Request.Testall(st["rreq"]):
                return False
            self._mpi_payload_recvs(st)
        return (bool(MPI.Request.Testall(st["preq"]))
                and bool(MPI.Request.Testall(st["sreqs"])))

    # Native-collective allgather: one Iallgather of the int64 blob sizes,
    # then one Iallgatherv of the payload bytes sized by it.  MPI matches
    # nonblocking collectives by posting order, so pending payload posts
    # drain through a FIFO — every rank posts them in the same order no
    # matter which handle's poll or wait drives progress.
    def _mpi_iag_post(self, blob: bytes):
        MPI, w = self._MPI, self._mpi
        hdr = np.array([len(blob)], np.int64)
        counts = np.zeros(self.size, np.int64)
        sbuf = np.frombuffer(blob, np.uint8) if blob else np.zeros(0, np.uint8)
        st = {"hdr": hdr, "counts": counts, "sbuf": sbuf,
              "hreq": w.Iallgather([hdr, MPI.INT64_T], [counts, MPI.INT64_T])}
        if not hasattr(self, "_iag_fifo"):
            self._iag_fifo = []
        self._iag_fifo.append(st)
        return st

    def _mpi_iag_drain(self) -> None:
        """Post payload Iallgatherv's for every pending exchange whose size
        collective has completed, in FIFO order; stop at the first that has
        not (posting a later one first would mismatch across ranks)."""
        MPI, w = self._MPI, self._mpi
        while self._iag_fifo:
            st = self._iag_fifo[0]
            if not MPI.Request.Testall([st["hreq"]]):
                return
            counts = st["counts"]
            displs = np.zeros(self.size, np.int64)
            np.cumsum(counts[:-1], out=displs[1:])
            st["rbuf"] = np.empty(int(counts.sum()), np.uint8)
            st["displs"] = displs
            st["preq"] = w.Iallgatherv(
                [st["sbuf"], MPI.BYTE],
                [st["rbuf"], counts.tolist(), displs.tolist(), MPI.BYTE])
            self._iag_fifo.pop(0)

    def _mpi_iag_complete(self, st) -> dict[int, bytes]:
        MPI = self._MPI
        if "preq" not in st:
            MPI.Request.Waitall([st["hreq"]])
            self._mpi_iag_drain()
            if "preq" not in st:
                raise RuntimeError("iallgather waited out of posting order")
        MPI.Request.Waitall([st["preq"]])
        d, c, buf = st["displs"], st["counts"], st["rbuf"]
        return {p: buf[int(d[p]):int(d[p]) + int(c[p])].tobytes()
                for p in range(self.size)}

    def _mpi_iag_test(self, st) -> bool:
        self._mpi_iag_drain()
        return ("preq" in st
                and bool(self._MPI.Request.Testall([st["preq"]])))

    # -- collectives -------------------------------------------------------
    def barrier(self) -> None:
        """Every rank waits here for all.  Over the store: a counter that
        each arrival increments, and a release key the last arrival sets,
        under the generation-numbered name and the comm's timeout (expiry
        raises `CommTimeoutError`)."""
        if self._mpi is not None:
            self._mpi.Barrier()
            return
        gen = self._gen
        self._gen += 1
        name = f"repro_comm_{self._ns}{gen}_b"
        s = self._store
        start = time.monotonic()
        if s.add(f"{name}/arrived", 1) == self.size:
            s.set(f"{name}/open", b"1")
        try:
            s.wait([f"{name}/open"], datetime.timedelta(milliseconds=self._timeout_ms))
        except _store_miss() as e:
            raise CommTimeoutError(
                phase=self._phases[-1] if self._phases else "default", seq=gen,
                elapsed_s=time.monotonic() - start, rank=self.rank,
                size=self.size) from e

    def _post(self, outbox: dict[int, bytes], tag: str):
        """Post one packed exchange on whichever transport is bound; returns
        (complete, poll, pending, diagnose) — closures delivering/probing
        {p: blob_from_p}, naming the undelivered peers, and (beacon on)
        reporting their last-alive generations.  The digest and the byte
        meters see the raw codec blobs; each transport value travels inside
        an integrity frame that `complete` verifies and strips, so a
        corrupted/truncated/duplicated wire byte surfaces as a
        `WireIntegrityError` naming the phase, generation and peer."""
        self._wire_update(outbox)
        phase = self._phases[-1] if self._phases else "default"
        gen = self._gen
        framed = {q: frame_blob(b) for q, b in outbox.items()}
        if self._mpi is not None:
            st = self._mpi_post(framed)
            raw, poll = (lambda: self._mpi_complete(st)), \
                        (lambda: self._mpi_test(st))
            pending = None
        else:
            st = self._kv_post(framed, tag)
            raw, poll = (lambda: self._kv_complete(st)), \
                        (lambda: self._kv_ready(st))
            pending = lambda: [p for p in range(self.size)  # noqa: E731
                               if p != self.rank and p not in st["inbox"]]

        def complete():
            return {p: unframe_blob(
                        b, where=f"{phase}:{tag}:gen{gen}:{p}->{self.rank}")
                    for p, b in raw().items()}

        diagnose = ((lambda: self._beacon_probe(pending()))
                    if (pending is not None and self._beacon) else None)
        return complete, poll, pending, diagnose

    def _iallgather(self, per_local: list) -> CommHandle:
        x = per_local[0]
        blob = encode_payload(x)
        outbox = {q: blob for q in range(self.size) if q != self.rank}
        if self._mpi is not None:
            # native collective path over the SAME per-peer logical blobs:
            # the digest folds them exactly as the store binding does
            self._wire_update(outbox)
            phase = self._phases[-1] if self._phases else "default"
            gen = self._gen
            st = self._mpi_iag_post(frame_blob(blob))

            def deliver():
                parts = self._mpi_iag_complete(st)
                out = [decode_payload(unframe_blob(
                           parts[p],
                           where=f"{phase}:iag:gen{gen}:{p}->{self.rank}"))
                       for p in range(self.size)]
                out[self.rank] = x
                return out

            return CommHandle(deliver, poll=lambda: self._mpi_iag_test(st))
        complete, poll, pending, diagnose = self._post(outbox, "ag")

        def deliver():
            out = [None] * self.size
            out[self.rank] = x
            for p, b in complete().items():
                out[p] = decode_payload(b)
            return out

        h = CommHandle(deliver, poll=poll)
        h._pending = pending
        h._diagnose = diagnose
        return h

    def _ialltoallv(self, send: list) -> CommHandle:
        row = send[0]
        outbox = {q: encode_payload(row[q])
                  for q in range(self.size) if q != self.rank}
        complete, poll, pending, diagnose = self._post(outbox, "a2a")

        def deliver():
            recv = [None] * self.size
            recv[self.rank] = row[self.rank]
            for p, b in complete().items():
                recv[p] = decode_payload(b)
            return [recv]

        h = CommHandle(deliver, poll=poll)
        h._pending = pending
        h._diagnose = diagnose
        return h
