"""The port's `DistComm` against the JAX package's, on the CPU.

(a) Offline, over fakes: the port's `DistComm` over a dict-backed fake with
TCPStore's interface, or over the JAX package's fake mpi4py surface (copied
here), and the JAX `DistComm` over its `FakeKVClient` (copied here) on the
same collective sequence: the same framed bytes under the same keys, and
the same `wire_digest()`, per rank.  The cases of the JAX package's
`tests/core/test_comm_async.py`: collectives, poll-driven progress, a wait
after `done()` that touches the store 0 times, namespaces, and the MPI
allgather on native collectives.  (b) A real TCPStore, two instances in
one process, with a payload past the store's 8 MiB value limit.  (c) Two
real processes (`run_ranks`) run the JAX package's
`tests/substrate/test_distcomm.py` pipeline; (d) four run the skewed
repartition through `Forest.repartition`.  Both against `SimComm` runs of
the port, and (c) against the JAX package's `SimComm(2)`, bit for bit.
"""

import datetime
import functools
import hashlib
import struct

import numpy as np
import pytest
import torch
from torch.distributed import DistStoreError, TCPStore

from repro.core import batch as jbatch
from repro.core import comm as jcomm
from repro.core import forest as JF
from repro_torch.core import cmesh as TC
from repro_torch.core import comm as tcomm
from repro_torch.core import forest as TF
from repro_torch.launch.multiproc import SKEW_BRICK_SETUP, free_port, run_ranks
from _torch_ranks import (GHOST_FIELDS, PIPELINE_SCRIPT, assert_ranks_equal, corner_cb,
                          load_ranks, summed_bytes)


# --------------------------------------------------------------- fakes
class FakeStore:
    """Dict-backed stand-in for a `torch.distributed.TCPStore`: a miss
    raises `DistStoreError` as the store's `get` and `wait` do.  Deletes
    tombstone (the graveyard), so a late reader of a cleaned key is a
    visible protocol bug.  `log` records every `set`, `calls` every call."""

    def __init__(self):
        self.data: dict = {}
        self.graveyard: dict = {}
        self.log: list = []
        self.calls = 0

    def set(self, k, v):
        self.calls += 1
        self.data[k] = bytes(v)
        self.log.append((k, bytes(v)))

    def get(self, k):
        self.calls += 1
        if k in self.data:
            return self.data[k]
        raise DistStoreError(f"no key {k}")

    def check(self, keys):
        self.calls += 1
        return all(k in self.data for k in keys)

    def wait(self, keys, timeout=None):
        self.calls += 1
        if not all(k in self.data for k in keys):
            raise DistStoreError(f"wait timeout on {keys}")

    def delete_key(self, k):
        self.calls += 1
        if k in self.data:
            self.graveyard[k] = self.data.pop(k)
            return True
        return False

    def add(self, k, n):
        self.calls += 1
        v = int(self.data.get(k, b"0")) + n
        self.data[k] = str(v).encode()
        return v

    def set_timeout(self, timeout):
        pass


class FakeKVClient:
    """The JAX package's fake of the jax.distributed KV client (from
    `tests/core/test_comm_async.py`), plus a `log` of every set."""

    def __init__(self):
        self.store: dict = {}
        self.graveyard: dict = {}
        self.barriers: list[str] = []
        self.log: list = []
        self.calls = 0

    def key_value_set_bytes(self, k, v):
        self.calls += 1
        self.store[k] = bytes(v)
        self.log.append((k, bytes(v)))

    def blocking_key_value_get_bytes(self, k, timeout_ms):
        self.calls += 1
        return self.store[k] if k in self.store else self.graveyard[k]

    def key_value_delete(self, k):
        self.calls += 1
        if k in self.store:
            self.graveyard[k] = self.store.pop(k)

    def wait_at_barrier(self, name, timeout_ms):
        self.calls += 1
        self.barriers.append(name)


class _FakeReq:
    def __init__(self, deliver=None, test=None):
        self._deliver = deliver
        self._test = test
        self._done = deliver is None

    def Wait(self):
        if not self._done:
            self._deliver()
            self._done = True


class _FakeRequestNS:
    @staticmethod
    def Waitall(reqs):
        for r in reqs:
            r.Wait()

    @staticmethod
    def Testall(reqs):
        if all(r._done or (r._test is not None and r._test()) for r in reqs):
            for r in reqs:
                r.Wait()
            return True
        return False


class FakeMPIModule:
    BYTE = "BYTE"
    INT64_T = "INT64_T"
    Request = _FakeRequestNS


class FakeMPIComm:
    """The JAX package's mailbox fake of an mpi4py communicator (from
    `tests/core/test_comm_async.py`): p2p messages keyed by (dst, src, tag),
    native nonblocking collectives as slots keyed by posting order."""

    def __init__(self, rank, size, mailbox):
        self._rank, self._size, self._box = rank, size, mailbox
        self._ncoll = 0

    def Get_rank(self):
        return self._rank

    def Get_size(self):
        return self._size

    def Isend(self, spec, dest, tag):
        buf, _ = spec
        self._box.setdefault((dest, self._rank, tag), []).append(np.array(buf, copy=True))
        return _FakeReq()

    def Irecv(self, spec, source, tag):
        buf, _ = spec
        key = (self._rank, source, tag)

        def deliver():
            q = self._box.get(key)
            if not q:
                raise RuntimeError(f"no message posted for {key}")
            msg = q.pop(0)
            buf[: len(msg)] = msg

        return _FakeReq(deliver, test=lambda: bool(self._box.get(key)))

    def _collective(self, sendbuf, deliver_all):
        slot = self._box.setdefault(("coll", self._ncoll), {})
        self._ncoll += 1
        slot[self._rank] = np.array(sendbuf, copy=True)

        def deliver():
            if len(slot) < self._size:
                raise RuntimeError("collective waited before every rank posted it")
            deliver_all(slot)

        return _FakeReq(deliver, test=lambda: len(slot) == self._size)

    def Iallgather(self, sendspec, recvspec):
        sbuf, rbuf = sendspec[0], recvspec[0]
        n = len(sbuf)

        def deliver_all(slot):
            for r, part in slot.items():
                rbuf[r * n:(r + 1) * n] = part

        return self._collective(sbuf, deliver_all)

    def Iallgatherv(self, sendspec, recvspec):
        sbuf = sendspec[0]
        rbuf, counts, displs, _ = recvspec

        def deliver_all(slot):
            for r, part in slot.items():
                rbuf[displs[r]:displs[r] + counts[r]] = part

        return self._collective(sbuf, deliver_all)


def _store_pair(namespace="", beacon=False, store=None):
    store = store if store is not None else FakeStore()
    return [tcomm.DistComm._testing_instance(r, 2, store=store, namespace=namespace,
                                             beacon=beacon) for r in range(2)], store


def _jax_kv_pair(namespace="", beacon=False, client=None):
    client = client if client is not None else FakeKVClient()
    return [jcomm.DistComm._testing_instance(r, 2, client=client, namespace=namespace,
                                             beacon=beacon) for r in range(2)], client


def _mpi_pair(mod):
    box: dict = {}
    return [mod.DistComm._testing_instance(r, 2, mpi=FakeMPIComm(r, 2, box), MPI=FakeMPIModule)
            for r in range(2)], box


PAYLOAD = [
    {"a": np.arange(7, dtype=np.uint64) * 2**40, "b": [None, True, -5, 1.5]},
    (np.zeros((0, 3), np.int32), b"\x00\xff", "text"),
]


def _sequence(comms):
    """The collective sequence both packages run: post both ranks, then
    wait both (the single-threaded protocol), in a "balance" phase."""
    out = []
    with comms[0].phase("balance"), comms[1].phase("balance"):
        hs = [comms[r].iallgather([PAYLOAD[r]]) for r in range(2)]
        for h in hs:
            h.done()
        out.append([h.wait() for h in hs])
        rows = [[(r, q, np.full(3, 10 * r + q, np.int32)) for q in range(2)] for r in range(2)]
        hs = [comms[r].ialltoallv([rows[r]]) for r in range(2)]
        out.append([h.wait() for h in hs])
        hs = [comms[r].ialltoallv([[PAYLOAD[0], None]]) for r in range(2)]
        out.append([h.wait() for h in hs])
    return out


def _same_results(a, b):
    assert jcomm.encode_payload(a) == tcomm.encode_payload(b)


@pytest.mark.parametrize("beacon", [False, True], ids=["plain", "beacon"])
def test_store_binding_posts_the_reference_bytes_under_the_reference_keys(beacon):
    """Over a fake store and the JAX fake KV client, the same sequence
    stores the same framed bytes under the same keys, in the same order
    (beacon keys included), and leaves the same digests and results."""
    tc, store = _store_pair(namespace="ns.", beacon=beacon)
    jc, client = _jax_kv_pair(namespace="ns.", beacon=beacon)
    got, want = _sequence(tc), _sequence(jc)
    _same_results(want, got)
    assert store.log == client.log and len(store.log) == 3 * 2 * (2 if beacon else 1)
    for r in range(2):
        assert tc[r].wire_digest() == jc[r].wire_digest()
        assert tc[r].counters == jc[r].counters
    assert not store.data or beacon and all(k.startswith("repro_beacon/") for k in store.data)
    assert sorted(store.graveyard) == sorted(client.graveyard)


def test_mpi_binding_moves_the_reference_bytes():
    """Over the fake mpi4py surface both packages leave the same mailbox
    traffic, results and digests; and the store binding's digests equal
    the MPI binding's (transport independent)."""
    tm, tbox = _mpi_pair(tcomm)
    jm, jbox = _mpi_pair(jcomm)
    got, want = _sequence(tm), _sequence(jm)
    _same_results(want, got)
    assert sorted(tbox, key=str) == sorted(jbox, key=str)
    ts, _ = _store_pair()
    _sequence(ts)
    for r in range(2):
        assert tm[r].wire_digest() == jm[r].wire_digest() == ts[r].wire_digest()


def _expected_digest(blob_seq):
    h = hashlib.sha256()
    for q, blob in blob_seq:
        h.update(struct.pack("<II", q, len(blob)))
        h.update(blob)
    return h.hexdigest()


@pytest.mark.parametrize("binding", ["mpi", "store"])
def test_collectives_match_simcomm_and_the_codec(binding):
    """allgather/alltoallv through each binding match SimComm, and the
    digest recomputes from `encode_payload` alone (no pickle)."""
    comms = _mpi_pair(tcomm)[0] if binding == "mpi" else _store_pair()[0]
    sim = tcomm.SimComm(2)
    hs = [comms[r].iallgather([PAYLOAD[r]]) for r in range(2)]
    for h in hs:
        h.done()
    want = sim.allgather(list(PAYLOAD))
    for r in range(2):
        _same_results(want, hs[r].wait())
    rows = [[(r, q, np.full(3, 10 * r + q, np.int32)) for q in range(2)] for r in range(2)]
    hs = [comms[r].ialltoallv([rows[r]]) for r in range(2)]
    wantv = sim.alltoallv(list(rows))
    for r in range(2):
        _same_results(wantv[r], hs[r].wait()[0])
        peer = 1 - r
        assert comms[r].wire_digest() == _expected_digest(
            [(peer, tcomm.encode_payload(PAYLOAD[r])),
             (peer, tcomm.encode_payload(rows[r][peer]))])


def test_mpi_poll_drives_progress_and_allgather_uses_native_collectives():
    comms, box = _mpi_pair(tcomm)
    h0 = comms[0].iallgather([7])
    assert not h0.done()
    h1 = comms[1].iallgather([8])
    h0.done(), h1.done()
    assert h0.done() and h1.done()
    assert h0.wait() == [7, 8] and h1.wait() == [7, 8]
    assert all(k[0] == "coll" for k in box), f"p2p keys leaked: {sorted(box, key=str)}"
    hs = [comms[r].ialltoallv([[None, "x"] if r == 0 else ["y", None]]) for r in range(2)]
    for h in hs:
        h.wait()
    assert any(k[0] != "coll" for k in box), "alltoallv should stay p2p"


def test_store_poll_cleanup_and_wait_after_done_is_free():
    """`done()` is a real poll (false before the peer posts), every key is
    deleted by its single reader, no barrier is taken, and once a handle
    polled done its `wait()` touches the store 0 times."""
    (c0, c1), store = _store_pair()
    h0 = c0.iallgather([10])
    assert not h0.done()
    h1 = c1.iallgather([20])
    assert h0.done() and h1.done()
    calls = store.calls
    assert h0.wait() == [10, 20] and h1.wait() == [10, 20]
    assert store.calls == calls, f"wait() after done() hit the store {store.calls - calls} times"
    assert not store.data, f"leaked keys: {sorted(store.data)}"
    assert not any("_b" in k for k, _ in store.log)


def test_namespaces_isolate_keys():
    store = FakeStore()
    a, _ = _store_pair(namespace="a.", store=store)
    b, _ = _store_pair(namespace="b.", store=store)
    ha = [a[r].iallgather([("A", r)]) for r in range(2)]
    hb = [b[r].iallgather([("B", r)]) for r in range(2)]
    assert ha[0].wait() == [("A", 0), ("A", 1)]
    assert hb[0].wait() == [("B", 0), ("B", 1)]
    ha[1].wait(), hb[1].wait()
    assert not store.data
    assert {k.split("/")[1] for k in store.graveyard} == {"a.0", "b.0"}


def test_a_blob_past_one_chunk_travels_as_sub_keys():
    """A framed blob longer than one store value goes as chunk keys under
    its key; it arrives whole, and every chunk key is cleaned."""
    (c0, c1), store = _store_pair()
    big = np.arange(3 * tcomm._KV_CHUNK // 8 + 5, dtype=np.int64)
    hs = [c0.ialltoallv([[None, big]]), c1.ialltoallv([[None, None]])]
    got = hs[1].wait()[0][0]
    np.testing.assert_array_equal(got, big)
    hs[0].wait()
    keys = [k for k, _ in store.log]
    assert keys[:4] == [f"repro_comm/0/a2a/0>1/{i}" for i in (1, 2, 3)] + ["repro_comm/0/a2a/0>1"]
    assert max(len(v) for _, v in store.log) == tcomm._KV_CHUNK
    assert not store.data


def test_deadline_names_the_missing_peer_and_the_beacon():
    """A peer that stops posting: a deadlined wait raises `CommTimeoutError`
    with the phase, the seq, the pending peer and (beacon on) its last-alive
    generation; without a deadline the transport's own timeout does."""
    (c0, c1), _ = _store_pair(beacon=True)
    for h in [c.iallgather([r]) for r, c in enumerate((c0, c1))]:
        h.wait()                     # generation 0: both ranks alive
    c0.set_deadline(0.05)
    with c0.phase("ghost"):
        h = c0.iallgather([0])       # generation 1: rank 1 never posts it
    with pytest.raises(tcomm.CommTimeoutError) as ei:
        h.wait()
    e = ei.value
    assert (e.phase, e.seq, e.pending) == ("ghost", 2, [1])
    assert e.detail == {"last_alive_gen": {1: 0}} and e.retries > 0
    (d0, _d1), _ = _store_pair()
    d0._timeout_ms = 30
    with pytest.raises(tcomm.CommTimeoutError) as ei:
        d0.allgather([0])
    assert (ei.value.pending, ei.value.rank, ei.value.size) == ([1], 0, 2)
    assert ei.value.retries > 0


def test_without_a_store_or_mpi_world_it_raises(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT, RANK"):
        tcomm.DistComm()
    with pytest.raises(RuntimeError, match="rank= and size="):
        tcomm.DistComm(store=FakeStore())


def test_real_tcpstore_two_instances_in_one_process():
    """Two DistComms over a real TCPStore in one process: post both, then
    wait both — an allgather, an alltoallv with a payload past the store's
    8 MiB value limit, and a barrier that both reach (on two threads)."""
    import threading

    port = free_port()
    master = TCPStore("localhost", port, 2, is_master=True, wait_for_workers=False,
                      timeout=datetime.timedelta(seconds=30))
    client = TCPStore("localhost", port, 2, timeout=datetime.timedelta(seconds=30))
    c = [tcomm.DistComm(timeout_s=20, store=s, rank=r, size=2)
         for r, s in enumerate((master, client))]
    hs = [c[r].iallgather([np.full(4, r, np.int32)]) for r in range(2)]
    assert [[int(x[0]) for x in h.wait()] for h in hs] == [[0, 1], [0, 1]]
    big = np.arange((9 << 20) // 8, dtype=np.int64)
    hs = [c[0].ialltoallv([[None, big]]), c[1].ialltoallv([["x", None]])]
    np.testing.assert_array_equal(hs[1].wait()[0][0], big)
    assert hs[0].wait()[0][1] == "x"
    assert not master.check(["repro_comm/1/a2a/0>1"])
    errs = []

    def barrier(comm):
        try:
            comm.barrier()
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errs.append(e)

    ts = [threading.Thread(target=barrier, args=(x,)) for x in c]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errs and not any(t.is_alive() for t in ts)


# ------------------------------------------------------ real processes
@functools.lru_cache(maxsize=None)
def _jax_pipeline_p2():
    """The JAX package's SimComm(2) run of the two-process pipeline."""
    def corner(tree, e, cap=4):
        return ((np.asarray(e.anchor).sum(1) == 0) & (np.asarray(e.level) < cap)).astype(np.int32)

    with jbatch.use_backend("jnp"):
        sim = JF.SimComm(2)
        fs = JF.new_uniform(2, 2, 2, sim)
        fs = [JF.adapt(f, corner, recursive=True) for f in fs]
        fs = JF.balance(fs, sim)
        gh = JF.ghost(fs, sim)
        n = JF.count_global(fs, sim)
        fs = JF.partition(fs, sim)
        assert JF.count_global(fs, sim) == n
    return fs, gh, n, {k: sim.bytes_for(k) for k in sim.counters}


def test_two_processes_equal_simcomm_and_the_reference(tmp_path):
    run_ranks(PIPELINE_SCRIPT, 2, extra_args=(tmp_path, "cpu"), timeout=120.0)
    arrays, facts = load_ranks(tmp_path, 2)
    sim = TF.SimComm(2)
    fs = TF.new_uniform(2, 2, 2, sim, device="cpu")
    fs = [TF.adapt(f, corner_cb(), recursive=True) for f in fs]
    fs = TF.balance(fs, sim)
    gh = TF.ghost(fs, sim)
    n = TF.count_global(fs, sim)
    fs = TF.partition(fs, sim)
    assert TF.count_global(fs, sim) == n
    assert_ranks_equal(arrays, fs, gh)
    jfs, jgh, jn, jbytes = _jax_pipeline_p2()
    for r in range(2):
        for k in ("anchor", "level", "stype", "tree"):
            np.testing.assert_array_equal(arrays[r][f"f_{k}"], getattr(jfs[r], k), err_msg=k)
        np.testing.assert_array_equal(arrays[r]["f_keys"].astype(np.uint64), jfs[r].keys)
        for k in GHOST_FIELDS:
            np.testing.assert_array_equal(arrays[r][f"g_{k}"], np.asarray(jgh[r][k]), err_msg=k)
    assert [f["n_global"] for f in facts] == [n, n] and n == jn
    assert summed_bytes(facts) == {k: sim.bytes_for(k) for k in sim.counters} == jbytes


REPART_SCRIPT = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
port, pid, outdir, device = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
from repro_torch.core import cmesh as C
from repro_torch.core import forest as F
from repro_torch.core.comm import DistComm
from repro_torch.launch.multiproc import SKEW_BRICK_SETUP

P = 4
comm_ov = DistComm(timeout_s=60, namespace="rp.ov.")
comm_ser = DistComm(timeout_s=60, namespace="rp.ser.")
comm_h = DistComm(timeout_s=60, namespace="rp.h.")   # keeps the digests pure
exec(SKEW_BRICK_SETUP)
assert F.load_imbalance(fs0, comm_h) > 1.5
out = fs0[0].repartition(comm_ov)
out_ser = fs0[0].repartition(comm_ser, overlap=False)
for k in ("keys", "level", "tree", "anchor", "stype"):
    assert torch.equal(getattr(out, k), getattr(out_ser, k)), k
digests = [comm_ov.wire_digest(), comm_ser.wire_digest()]
assert digests[0] == digests[1], "overlap changed the migration bytes"
assert F.load_imbalance([out], comm_h) <= 1.1
bal = F.balance([out], comm_ov)
gh = F.ghost(bal, comm_ov)
np.savez(f"{outdir}/rank{pid}.npz",
         **{f"f_{k}": getattr(bal[0], k).cpu().numpy() for k in
            ("anchor", "level", "stype", "tree", "keys")},
         **{f"r_{k}": getattr(out, k).cpu().numpy() for k in
            ("anchor", "level", "stype", "tree", "keys")},
         **{f"g_{k}": gh[0][k].cpu().numpy() for k in
            ("anchor", "level", "stype", "tree", "owner")})
with open(f"{outdir}/rank{pid}.json", "w") as f:
    json.dump({"counters": comm_ov.counters, "digests": digests}, f)
comm_h.barrier()
print(f"rank {pid}: repartition OK", flush=True)
"""


def test_four_processes_repartition_equals_simcomm(tmp_path):
    """The skewed repartition through `Forest.repartition` on four
    processes: overlapped == serialized with equal digests, imbalance <= 1.1,
    and the repartitioned, balanced forests and ghosts equal `SimComm(4)`'s
    rank for rank, bytes included."""
    run_ranks(REPART_SCRIPT, 4, extra_args=(tmp_path, "cpu"), timeout=120.0)
    arrays, facts = load_ranks(tmp_path, 4)
    ns = {"torch": torch, "C": TC, "F": TF, "P": 4, "device": "cpu",
          "comm_ov": TF.SimComm(4)}
    exec(SKEW_BRICK_SETUP, ns)
    sim = ns["comm_ov"]
    rep = TF.repartition(ns["fs0"], sim)
    bal = TF.balance(rep, sim)
    gh = TF.ghost(bal, sim)
    assert_ranks_equal(arrays, bal, gh)
    for r in range(4):
        for k in ("anchor", "level", "stype", "tree", "keys"):
            np.testing.assert_array_equal(arrays[r][f"r_{k}"], getattr(rep[r], k).numpy())
        assert facts[r]["digests"][0] == facts[r]["digests"][1]
    assert summed_bytes(facts) == {k: sim.bytes_for(k) for k in sim.counters}
    assert sim.bytes_for("repartition") > 0
