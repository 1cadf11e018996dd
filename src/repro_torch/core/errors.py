"""Structured errors of the fault-tolerant runtime.

A dependency-free module so every layer — the wire codecs (`core.types`,
`core.comm`), the transports (`DistComm`), the chaos harness
(`core.resilience`), the forest checkpoints (`checkpoint.forest_io`) and the
subprocess launcher (`launch.multiproc`) — raises and catches the same
exception types as the JAX package's `repro.core.errors`, without import
cycles.  `core.resilience` re-exports them as the user-facing surface.

The hierarchy turns the failure modes of the distributed pipeline — a bare
`struct.error` from a malformed buffer, a silent wrong decode, a flat hang
with no diagnosis — into typed errors that carry enough context (phase,
peer, generation, retry counts, checksum mismatch) to reproduce and route
around the fault.
"""

from __future__ import annotations

__all__ = [
    "ResilienceError",
    "WireFormatError",
    "WireIntegrityError",
    "CommTimeoutError",
    "CheckpointIntegrityError",
    "InjectedCrash",
    "RankTimeoutError",
]


class ResilienceError(RuntimeError):
    """Base class of every structured fault-path error."""


class WireFormatError(ResilienceError, ValueError):
    """A wire buffer is not a well-formed payload.

    Raised by `core.comm.decode_payload` and `core.types.unpack_wire` for
    truncated, trailing-garbage, or structurally invalid buffers — never a
    bare `struct.error`, `KeyError`, or a silently misaligned column
    decode."""


class WireIntegrityError(ResilienceError):
    """A framed transport payload failed its integrity check.

    Every `DistComm` transport blob travels as `frame_blob` output — a
    (magic, length, CRC32) header plus the raw `encode_payload` bytes — and
    `unframe_blob` raises this when the magic, length, or checksum does not
    match (corruption, truncation, or duplication on the wire)."""

    def __init__(self, reason: str, *, where: str = "",
                 expected=None, actual=None):
        self.reason = reason
        self.where = where
        self.expected = expected
        self.actual = actual
        msg = f"wire integrity failure: {reason}"
        if expected is not None or actual is not None:
            msg += f" (expected {expected!r}, got {actual!r})"
        if where:
            msg += f" [{where}]"
        super().__init__(msg)


class CommTimeoutError(ResilienceError, TimeoutError):
    """A collective did not complete before its deadline.

    Carries what a survivor needs to diagnose (and its caller needs to
    recover from) a dead or stalled peer: the `phase` the pipeline was in,
    the collective's `seq` (posting generation), how long it waited and how
    many poll retries ran, and — where the transport knows — which
    `pending` peers never delivered, plus a `detail` dict (e.g. the last
    liveness-beacon generation seen per peer)."""

    def __init__(self, *, phase: str = "default", seq: int = -1,
                 elapsed_s: float = 0.0, retries: int = 0,
                 rank: int | None = None, size: int | None = None,
                 pending=None, detail: dict | None = None):
        self.phase = phase
        self.seq = seq
        self.elapsed_s = elapsed_s
        self.retries = retries
        self.rank = rank
        self.size = size
        self.pending = None if pending is None else sorted(int(p) for p in pending)
        self.detail = detail or {}
        who = "" if rank is None else f" on rank {rank}" + (
            f"/{size}" if size is not None else "")
        peers = ("" if self.pending is None
                 else f"; still waiting on peers {self.pending}")
        extra = f"; {self.detail}" if self.detail else ""
        super().__init__(
            f"collective #{seq} in phase '{phase}' timed out after "
            f"{elapsed_s:.3f}s{who} ({retries} poll retries){peers}{extra}")


class CheckpointIntegrityError(ResilienceError):
    """A forest checkpoint is unreadable, corrupted, or invalid on restore.

    Raised by `checkpoint.forest_io.load_forest` when a payload blob is
    truncated/garbage, a stored CRC32 disagrees with the bytes on disk, the
    element count contradicts the manifest, or the restored global forest
    fails `forest.validate`."""


class InjectedCrash(ResilienceError):
    """A `ChaosComm` crash-at-collective fault fired (in-process mode).

    Runs of one rank a process use a hard `os._exit` instead, so the process
    dies exactly like a real rank failure; in-process (SimComm-hosted) runs
    raise this so a caller can catch the crash and exercise `recover`."""

    def __init__(self, *, phase: str, seq: int, rank: int):
        self.phase = phase
        self.seq = seq
        self.rank = rank
        super().__init__(
            f"injected crash at collective #{seq} in phase '{phase}' "
            f"on rank {rank}")


class RankTimeoutError(ResilienceError, TimeoutError):
    """`run_ranks` hit its wall-clock budget and killed the fleet.

    Carries every rank's exit state and captured stderr tail, so a hung
    subprocess run fails fast with a diagnosis instead of stalling;
    `per_rank` maps rank -> (state, stderr_tail)."""

    def __init__(self, message: str, per_rank: dict | None = None):
        self.per_rank = per_rank or {}
        super().__init__(message)
