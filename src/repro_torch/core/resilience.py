"""Fault injection and recovery for the distributed forest runtime.

The counterpart of the JAX package's `repro.core.resilience`.  Three pieces:

`ChaosComm` wraps any `Comm` (SimComm, LatencyComm, DistComm) and conforms
to the full surface — blocking and nonblocking collectives, phase meters
(shared with the inner comm, so byte attribution is unchanged), wire
digest, barrier — while injecting seeded, per-phase faults at the layer a
real wire would corrupt them: the framed byte stream.  Fault kinds: payload
corruption (a byte flip), truncation, duplication, delivery delay, rank
stall (a handle that never matures — it surfaces through the deadline as
`CommTimeoutError`), and crash-at-collective (`InjectedCrash` in one
process, a hard `os._exit(2)` when each rank is a process, so the process
dies like a real rank).  Every byte fault goes through `frame_blob` ->
mutate -> `unframe_blob` / `decode_payload`, the path production traffic
takes; a detected fault is retried (a transient fault) up to `max_retries`
and counted in `fault_counts`, so a chaos run either delivers results equal
to the fault-free run or raises a typed error — never a silently wrong
forest.

`Autosaver` is a `forest.RESILIENCE_HOOKS` hook that checkpoints the forest
with `save_forest` every N `balance()` / `repartition()` entries, so a
crash mid-collective always has a consistent pre-phase checkpoint behind it.

`recover(path, comm)` restores the forest elastically onto whatever comm the
survivors rebuilt — typically at a smaller P after a rank death — with the
checkpoint's integrity checked and `validate()` run on the restored world.

Reproducing a failure is one seed: `ChaosConfig(seed=...)` draws its stream
from `np.random.default_rng([seed, rank])` in the reference's order, so an
in-process SimComm run, a run of one rank a process, and the JAX package's
`ChaosComm` inject the same fault sequence per rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np

from .comm import (
    _FRAME,
    Comm,
    CommHandle,
    decode_payload,
    encode_payload,
    frame_blob,
    unframe_blob,
)
from .errors import (
    CheckpointIntegrityError,
    CommTimeoutError,
    InjectedCrash,
    RankTimeoutError,
    ResilienceError,
    WireFormatError,
    WireIntegrityError,
)

__all__ = [
    "ChaosConfig",
    "ChaosComm",
    "Autosaver",
    "recover",
    "ResilienceError",
    "WireFormatError",
    "WireIntegrityError",
    "CommTimeoutError",
    "CheckpointIntegrityError",
    "InjectedCrash",
    "RankTimeoutError",
]

_BYTE_FAULTS = ("corrupt", "truncate", "duplicate")


@dataclasses.dataclass
class ChaosConfig:
    """Seeded fault plan for a `ChaosComm`.

    Rates are per delivered payload (byte faults) or per posted collective
    (delay); `stall_after` / `crash_at` count collectives posted in an
    eligible phase.  `phases=None` makes every phase eligible; `max_faults`
    bounds the byte faults injected in all; `max_retries` bounds the
    redelivery loop (exhaustion re-raises the detection error)."""

    seed: int = 0
    p_corrupt: float = 0.0
    p_truncate: float = 0.0
    p_duplicate: float = 0.0
    p_delay: float = 0.0
    delay_s: float = 0.001
    stall_after: int | None = None   # collectives before handles stop maturing
    crash_at: int | None = None      # collective index that kills crash_ranks
    crash_ranks: tuple = ()
    hard_exit: bool = False          # os._exit(2) instead of InjectedCrash
    phases: tuple | None = None      # eligible phase names, None = all
    max_faults: int | None = None
    max_retries: int = 3
    # transient faults (default): a detected fault's redelivery is pristine,
    # so every byte fault costs one bounded retry.  persistent_faults
    # re-rolls the fault on every redelivery — a rotten link — which proves
    # the retry loop bounded (exhaustion re-raises).
    persistent_faults: bool = False


class ChaosComm(Comm):
    """A `Comm` that injects the configured faults between post and
    delivery.  Meters, phases and (for a DistComm inner) the wire digest are
    the wrapped comm's; results under byte faults equal the fault-free run's
    because detection triggers redelivery of the pristine payload."""

    def __init__(self, inner: Comm, config: ChaosConfig | None = None, **kw):
        super().__init__()
        self.inner = inner
        self.cfg = config if config is not None else ChaosConfig(**kw)
        # share the metering state: one phase stack, one counter table
        self.counters = inner.counters
        self._phases = inner._phases
        self.size = inner.size
        self.rank = inner.rank
        self.local_ranks = inner.local_ranks
        self.fault_counts = {k: 0 for k in
                             (*_BYTE_FAULTS, "delay", "stall", "crash",
                              "detected", "retries")}
        self._ncoll: dict[str, int] = {}
        self._rng = np.random.default_rng([int(self.cfg.seed), int(inner.rank)])
        self._wire = hashlib.sha256()

    def barrier(self) -> None:
        self.inner.barrier()

    def wire_digest(self) -> str:
        if hasattr(self.inner, "wire_digest"):
            return self.inner.wire_digest()
        return self._wire.hexdigest()

    def injected(self) -> int:
        """Byte faults injected so far (the `max_faults` budget)."""
        return sum(self.fault_counts[k] for k in _BYTE_FAULTS)

    # -- fault plan --------------------------------------------------------
    def _phase_name(self) -> str:
        return self._phases[-1] if self._phases else "default"

    def _eligible(self, ph: str) -> bool:
        return self.cfg.phases is None or ph in self.cfg.phases

    def _me_crashes(self) -> bool:
        if not self.cfg.crash_ranks:
            return False
        if len(self.local_ranks) > 1:   # an in-process world hosts the victim
            return True
        return self.rank in self.cfg.crash_ranks

    def _pre_post(self, ph: str) -> dict:
        """Advance the per-phase collective counter; fire crash faults and
        decide stall/delay for the handle about to be posted."""
        plan = {"stall": False, "delay": False}
        if not self._eligible(ph):
            return plan
        n = self._ncoll.get(ph, 0) + 1
        self._ncoll[ph] = n
        cfg = self.cfg
        if cfg.crash_at is not None and n >= cfg.crash_at and self._me_crashes():
            self.fault_counts["crash"] += 1
            victim = (self.rank if self.rank in cfg.crash_ranks
                      else int(cfg.crash_ranks[0]))
            if cfg.hard_exit:
                os._exit(2)
            raise InjectedCrash(phase=ph, seq=n, rank=victim)
        if cfg.stall_after is not None and n > cfg.stall_after:
            plan["stall"] = True
            self.fault_counts["stall"] += 1
        elif cfg.p_delay and float(self._rng.random()) < cfg.p_delay:
            plan["delay"] = True
            self.fault_counts["delay"] += 1
        return plan

    def _roll_byte_fault(self, ph: str) -> str | None:
        cfg = self.cfg
        if not self._eligible(ph):
            return None
        if cfg.max_faults is not None and self.injected() >= cfg.max_faults:
            return None
        u = float(self._rng.random())
        if u < cfg.p_corrupt:
            return "corrupt"
        if u < cfg.p_corrupt + cfg.p_truncate:
            return "truncate"
        if u < cfg.p_corrupt + cfg.p_truncate + cfg.p_duplicate:
            return "duplicate"
        return None

    def _mutate(self, framed: bytes, kind: str) -> bytes:
        rng = self._rng
        if kind == "corrupt":
            # flip one body byte: the CRC32 in the header must catch it
            idx = _FRAME.size + int(rng.integers(0, len(framed) - _FRAME.size))
            flip = 1 + int(rng.integers(0, 255))
            b = bytearray(framed)
            b[idx] ^= flip
            return bytes(b)
        if kind == "truncate":
            k = 1 + int(rng.integers(0, max(1, len(framed) // 4)))
            return framed[:-k]
        if kind == "duplicate":
            return framed + framed[_FRAME.size:]
        raise ValueError(f"unknown byte fault {kind!r}")

    def _deliver(self, val, ph: str, where: str):
        """Round-trip one payload through the seeded wire.  A rolled fault
        mutates the framed bytes; detection (the production unframe/decode
        path) counts and redelivers — pristine bytes are re-faulted only
        with `persistent_faults`, and `max_retries` bounds the loop."""
        last_err = None
        for attempt in range(self.cfg.max_retries + 1):
            kind = (self._roll_byte_fault(ph)
                    if (attempt == 0 or self.cfg.persistent_faults) else None)
            if kind is None:
                if attempt:
                    self.fault_counts["retries"] += attempt
                return val
            framed = self._mutate(frame_blob(encode_payload(val)), kind)
            self.fault_counts[kind] += 1
            try:
                # a mutation that passed both the frame check and the codec
                # would be delivered decoded; these fault kinds never do
                return decode_payload(unframe_blob(framed, where=where))
            except (WireIntegrityError, WireFormatError) as e:
                self.fault_counts["detected"] += 1
                last_err = e
        self.fault_counts["retries"] += self.cfg.max_retries
        raise last_err

    # -- handle wrapping ---------------------------------------------------
    def _stalled(self, ph: str, seq: int) -> CommHandle:
        """A handle that never matures: `done()` stays False and a deadlined
        `wait()` raises `CommTimeoutError` naming the phase; an undeadlined
        `wait()` blocks forever, as a stalled peer would."""

        def complete():
            while True:
                time.sleep(0.01)

        h = CommHandle(complete, poll=lambda: False)
        h.phase, h.seq = ph, seq
        return h

    def _wrap(self, h: CommHandle, plan: dict, transform) -> CommHandle:
        ready_at = (time.monotonic() + self.cfg.delay_s
                    if plan["delay"] else None)

        def poll() -> bool:
            if ready_at is not None and time.monotonic() < ready_at:
                return False
            return h.done()

        def complete():
            if ready_at is not None:
                rem = ready_at - time.monotonic()
                if rem > 0:
                    time.sleep(rem)
            return transform(h.wait())

        nh = CommHandle(complete, poll=poll)
        # keep the transport's per-peer diagnostics visible through the
        # wrapper: a deadlined wait() must still name WHO is missing
        nh._pending = h._pending
        nh._diagnose = h._diagnose
        return nh

    # -- collectives -------------------------------------------------------
    def iallgather(self, per_local):
        ph = self._phase_name()
        plan = self._pre_post(ph)
        if not hasattr(self.inner, "wire_digest"):
            for x in per_local:
                self._wire.update(encode_payload(x))
        h = self.inner.iallgather(per_local)
        if plan["stall"]:
            # the inner comm metered what WOULD have been posted
            return self._stamp(self._stalled(ph, self._hseq + 1))
        sim = len(self.local_ranks) > 1   # in-process: self rows fault too

        def transform(out):
            return [self._deliver(v, ph, f"{ph}:ag:{p}->{self.rank}")
                    if (sim or p != self.rank) else v
                    for p, v in enumerate(out)]

        return self._stamp(self._wrap(h, plan, transform))

    def ialltoallv(self, send):
        ph = self._phase_name()
        plan = self._pre_post(ph)
        if not hasattr(self.inner, "wire_digest"):
            for i, g in enumerate(self.local_ranks):
                for q, x in enumerate(send[i]):
                    if q != g:
                        self._wire.update(encode_payload(x))
        h = self.inner.ialltoallv(send)
        if plan["stall"]:
            return self._stamp(self._stalled(ph, self._hseq + 1))
        locs = list(self.local_ranks)

        def transform(rows):
            return [[self._deliver(v, ph, f"{ph}:a2a:{p}->{g}")
                     if p != g else v
                     for p, v in enumerate(row)]
                    for g, row in zip(locs, rows)]

        return self._stamp(self._wrap(h, plan, transform))


# ------------------------------------------------------------- checkpointing
class Autosaver:
    """A `forest.RESILIENCE_HOOKS` hook: `save_forest` snapshots at every
    `every`-th of the `events` (balance and repartition entry by default),
    so a rank crash mid-collective always has a consistent pre-phase
    checkpoint to `recover` from.  Saves run under their own "checkpoint"
    comm phase (inside `save_forest`), so autosave traffic never enters the
    balance / repartition byte counts."""

    def __init__(self, path, *, every: int = 1,
                 events=("balance:begin", "repartition:begin"),
                 step0: int = 0):
        self.path = path
        self.every = max(1, int(every))
        self.events = tuple(events)
        self.count = 0
        self.step = int(step0)
        self.saved_steps: list[int] = []

    def __call__(self, event: str, forests, comm) -> None:
        if event not in self.events:
            return
        self.count += 1
        if (self.count - 1) % self.every:
            return
        from ..checkpoint.forest_io import save_forest  # noqa: PLC0415

        save_forest(self.path, forests, comm, step=self.step)
        self.saved_steps.append(self.step)
        self.step += 1

    def install(self) -> "Autosaver":
        from . import forest  # noqa: PLC0415

        forest.RESILIENCE_HOOKS.append(self)
        return self

    def uninstall(self) -> None:
        from . import forest  # noqa: PLC0415

        if self in forest.RESILIENCE_HOOKS:
            forest.RESILIENCE_HOOKS.remove(self)


def recover(path, comm, *, step: int | None = None, cmesh=None,
            weights=None, verify: bool = True, device=None):
    """Restore the forest from the last (or a given) checkpoint onto `comm`
    and `device` (the card unless given `device="cpu"`) — elastically: the
    survivors' world may be smaller than the world that saved.  Integrity
    is checked (stored CRC32s, counts) and the restored global forest is
    validated before slicing; any failure is a `CheckpointIntegrityError`,
    never a silently wrong forest."""
    from ..checkpoint.forest_io import load_forest  # noqa: PLC0415

    return load_forest(path, comm, step=step, cmesh=cmesh, weights=weights,
                       verify=verify, device=device)
