"""The port's Comm surface against the JAX package's, on the CPU.

The integrity frame (`frame_blob` / `unframe_blob`) gives the JAX
package's bytes on the payloads of `tests/core/test_wire_integrity.py`,
and every single-byte flip, truncation and duplication of a framed blob
raises `WireIntegrityError` with the reference's `reason`.  A handle under
a deadline raises `CommTimeoutError` with its phase and seq, as the
reference's does.  `stats()` equals the JAX package's dict after the same
small pipeline on `SimComm(4)`, and `reset_counters` clears it.
`LatencyComm` changes timing only.
"""

import functools
import time

import numpy as np
import pytest

from repro.core import batch as jbatch
from repro.core import cmesh as JC
from repro.core import comm as jcomm
from repro.core import forest as JF
from repro.core.errors import WireIntegrityError as JWireIntegrityError
from repro_torch.core import cmesh as TC
from repro_torch.core import comm as tcomm
from repro_torch.core import forest as TF
from repro_torch.core.errors import WireIntegrityError
from _torch_ranks import corner_cb


def _sample_payloads():
    """The payloads of the JAX package's `test_wire_integrity.py`."""
    rng = np.random.default_rng(7)
    return [
        None, True, -17, 1 << 70, 3.25, "balance:q", b"\x00\x01\x02",
        np.arange(33, dtype=np.uint64),
        rng.integers(0, 100, (5, 3)).astype(np.int32),
        [np.float64(1.5), "x", None, (2, 3)],
        {"tree": np.arange(4, dtype=np.int32), "lvl": 2,
         "nested": {"k": [b"ab", False]}},
    ]


@pytest.mark.parametrize("i", range(len(_sample_payloads())))
def test_frame_gives_the_reference_bytes(i):
    obj = _sample_payloads()[i]
    blob = tcomm.encode_payload(obj)
    assert blob == jcomm.encode_payload(obj)
    framed = tcomm.frame_blob(blob)
    assert framed == jcomm.frame_blob(blob)
    assert len(framed) == len(blob) + tcomm._FRAME.size == len(blob) + jcomm._FRAME.size
    assert tcomm.unframe_blob(framed) == blob


def _reason(mod, err, buf):
    with pytest.raises(err) as ei:
        mod.unframe_blob(buf, where="w")
    assert ei.value.where == "w"
    return ei.value.reason, ei.value.expected, ei.value.actual


def _mutations(framed):
    """Every single-byte flip, every truncation, and the duplications."""
    for idx in range(len(framed)):
        bad = bytearray(framed)
        bad[idx] ^= 0x5A
        yield bytes(bad)
    for cut in range(1, len(framed) + 1):
        yield framed[:-cut]
    yield framed + framed[tcomm._FRAME.size:]
    yield framed + framed
    yield b"XX99" + framed[4:]


def test_every_flip_truncation_and_duplication_raises_the_reference_reason():
    framed = tcomm.frame_blob(tcomm.encode_payload(
        {"a": np.arange(9, dtype=np.int32), "b": "xyz"}))
    reasons = set()
    for bad in _mutations(framed):
        got = _reason(tcomm, WireIntegrityError, bad)
        assert got == _reason(jcomm, JWireIntegrityError, bad)
        reasons.add(got[0])
    assert reasons == {"frame shorter than header", "bad frame magic",
                       "frame length mismatch", "frame checksum mismatch"}


@pytest.mark.parametrize("binding", ["latency", "never"])
def test_a_deadlined_handle_raises_with_its_phase_and_seq(binding):
    """A collective that does not mature before the deadline: the port's
    and the reference's waits raise with the same phase, seq and (no peer
    knowledge in one process) no pending list."""
    errs = []
    for mod in (tcomm, jcomm):
        comm = mod.LatencyComm(2, latency_s=30.0)
        comm.set_deadline(0.05)
        with comm.phase("balance"):
            comm.iallgather([1, 2])
        with comm.phase("ghost"):
            h = comm.ialltoallv([[1, 2], [3, 4]])
        if binding == "never":
            h._poll = lambda: False
        t0 = time.monotonic()
        with pytest.raises(mod.CommTimeoutError) as ei:
            h.wait()
        assert time.monotonic() - t0 < 5.0
        e = ei.value
        errs.append((e.phase, e.seq, e.pending, e.retries > 0, e.elapsed_s >= 0.04))
    assert errs[0] == errs[1] == ("ghost", 2, None, True, True)


def _pipeline(F, comm, cm, cb):
    fs = F.new_uniform(2, cm.num_trees, 2, comm, cmesh=cm, **(
        {"device": "cpu"} if F is TF else {}))
    fs = [F.adapt(f, cb, recursive=True) for f in fs]
    fs = F.partition(fs, comm)
    fs = F.balance(fs, comm)
    F.ghost(fs, comm)
    F.count_global(fs, comm)
    return fs


@functools.lru_cache(maxsize=None)
def _jax_stats():
    def cb(tree, e):
        return ((np.asarray(e.anchor).sum(1) == 0) & (np.asarray(e.level) < 4)).astype(np.int32)

    with jbatch.use_backend("jnp"):
        comm = JF.SimComm(4)
        _pipeline(JF, comm, JC.cmesh_brick(2, (2, 1)), cb)
    return comm.stats()


def test_stats_equal_the_reference_and_reset_clears_them():
    comm = TF.SimComm(4)
    _pipeline(TF, comm, TC.cmesh_brick(2, (2, 1)), corner_cb())
    got = comm.stats()
    assert got == _jax_stats()
    assert set(got) == {"partition", "balance", "ghost", "default", "total_bytes"}
    assert got["total_bytes"] == comm.bytes_for() > 0
    got["balance"]["allgather_calls"] = -1      # a copy, not the live table
    assert comm.counters["balance"]["allgather_calls"] > 0
    comm.reset_counters()
    assert comm.stats() == {"total_bytes": 0} and comm.bytes_for("balance") == 0


def test_latencycomm_changes_timing_only():
    """Balance and Ghost over LatencyComm equal SimComm's, overlapped and
    serialized; a handle is not done() before its latency has passed."""
    cm = TC.cmesh_brick(2, (2, 1))
    ref_comm = TF.SimComm(2)
    ref = _pipeline(TF, ref_comm, cm, corner_cb())
    for overlap in (True, False):
        lc = TF.LatencyComm(2, 1e-3)
        fs = TF.new_uniform(2, cm.num_trees, 2, lc, cmesh=cm, device="cpu")
        fs = [TF.adapt(f, corner_cb(), recursive=True) for f in fs]
        fs = TF.balance(TF.partition(fs, lc), lc, overlap=overlap)
        TF.ghost(fs, lc, overlap=overlap)
        for a, b in zip(fs, ref):
            for k in ("anchor", "level", "stype", "tree", "keys"):
                assert np.array_equal(getattr(a, k).numpy(), getattr(b, k).numpy()), k
        assert lc.bytes_for("balance") == ref_comm.bytes_for("balance")
    lc = tcomm.LatencyComm(2, latency_s=0.2)
    t0 = time.monotonic()
    h = lc.iallgather([1, 2])
    assert not h.done()
    assert h.wait() == [1, 2] and time.monotonic() - t0 >= 0.2 and h.done()
