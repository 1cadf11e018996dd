"""Chaos injection, deadlines, crash recovery: the port against the JAX
package's `repro.core.resilience`, on the CPU.

The cases of the JAX package's `tests/core/test_resilience.py`, on its
brick pipeline (a 2 x 1 Kuhn brick, corner adapt to level 4, Balance), each
run by the port's `ChaosComm` and the JAX package's on the same seed and
scenario: equal forests, equal `fault_counts`, equal meters; a stall
surfaces as a `CommTimeoutError` named by its phase and seq, a crash as an
`InjectedCrash` with the same phase, seq and rank.  `Autosaver` and
`recover`: a crash mid-Balance on `SimComm(4)`, restored onto `SimComm(3)`
and balanced, equals a fresh `SimComm(3)` run and the JAX package's; a
corrupted checkpoint blob is refused.  Last, the kill-one-rank run of the
JAX package's `tests/substrate/test_resilience_recovery.py` with real
processes: rank 3 of four dies mid-Balance, ranks 0-2 name it in a
`CommTimeoutError`, and a fresh world of three recovers the checkpoint.
"""

import functools

import numpy as np
import pytest

from repro.core import batch as jbatch
from repro.core import cmesh as JC
from repro.core import forest as JF
from repro.core import resilience as jres
from repro_torch.checkpoint import save_forest
from repro_torch.core import cmesh as TC
from repro_torch.core import forest as TF
from repro_torch.core.errors import (CheckpointIntegrityError, CommTimeoutError, InjectedCrash,
                                     WireIntegrityError)
from repro_torch.core.resilience import Autosaver, ChaosComm, ChaosConfig, recover
from repro_torch.launch.multiproc import run_ranks
from _torch_ranks import corner_cb, load_ranks

CHAOS_RATES = dict(p_corrupt=0.2, p_truncate=0.1, p_duplicate=0.1, p_delay=0.05)
WORLD = ("tree", "anchor", "level", "stype")


def _jcorner(tree, e, cap=4):
    return ((np.asarray(e.anchor).sum(1) == 0) & (np.asarray(e.level) < cap)).astype(np.int32)


def _adapted(comm):
    cm = TC.cmesh_brick(2, (2, 1))
    fs = TF.new_uniform(2, cm.num_trees, 2, comm, cmesh=cm, device="cpu")
    return [TF.adapt(f, corner_cb(), recursive=True) for f in fs]


def _jadapted(comm):
    cm = JC.cmesh_brick(2, (2, 1))
    fs = JF.new_uniform(2, cm.num_trees, 2, comm, cmesh=cm)
    return [JF.adapt(f, _jcorner, recursive=True) for f in fs]


def _world(fs):
    """Global (rank-major == SFC-order) concatenation: independent of the
    partition, so elastic restores compare against fresh runs."""
    return {k: np.concatenate([np.asarray(getattr(f, k)) for f in fs]) for k in WORLD}


def _assert_world_equal(a, b):
    for k in WORLD:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_raises(run, err):
    try:
        run()
    except err as e:
        return e
    raise AssertionError(f"the reference raised no {err.__name__}")


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's side of every case, run once (jnp backend):
    worlds, fault counts, meters and the raised errors' fields."""
    out = {}
    with jbatch.use_backend("jnp"):
        for seed in (7, 8):
            ch = jres.ChaosComm(JF.SimComm(4), seed=seed, **CHAOS_RATES)
            out[seed] = (_world(JF.balance(_jadapted(ch), ch)), dict(ch.fault_counts),
                         {k: dict(v) for k, v in ch.counters.items()})
        ch = jres.ChaosComm(JF.SimComm(4), stall_after=2, phases=("balance",))
        ch.set_deadline(0.3)
        fs = _jadapted(ch)
        e = _jax_raises(lambda: JF.balance(fs, ch), jres.CommTimeoutError)
        out["stall"] = (e.phase, e.seq, dict(ch.fault_counts))
        ch = jres.ChaosComm(JF.SimComm(4), crash_at=3, crash_ranks=(3,), phases=("balance",))
        fs = _jadapted(ch)
        e = _jax_raises(lambda: JF.balance(fs, ch), jres.InjectedCrash)
        out["crash"] = (e.phase, e.seq, e.rank, dict(ch.fault_counts))
        ch = jres.ChaosComm(JF.SimComm(2), config=jres.ChaosConfig(
            seed=0, p_corrupt=1.0, persistent_faults=True, max_retries=3))
        _jax_raises(lambda: ch.allgather([np.arange(4, dtype=np.int64), "payload"]),
                    jres.WireIntegrityError)
        out["persistent"] = dict(ch.fault_counts)
        c3 = JF.SimComm(3)
        out["fresh3"] = _world(JF.balance(_jadapted(c3), c3))
    return out


def test_chaos_byte_faults_detected_and_equal_to_the_reference():
    """Byte faults at these rates are all detected and retried: the chaos
    run equals the fault-free run, and the JAX package's chaos run on the
    same seed, with the same fault counts and meters."""
    cc = TF.SimComm(4)
    clean = TF.balance(_adapted(cc), cc)
    inner = TF.SimComm(4)
    ch = ChaosComm(inner, seed=7, **CHAOS_RATES)
    noisy = TF.balance(_adapted(ch), ch)
    _assert_world_equal(_world(noisy), _world(clean))
    jworld, jcounts, jcounters = _jax()[7]
    _assert_world_equal(_world(noisy), jworld)
    assert ch.fault_counts == jcounts
    inj = ch.injected()
    assert inj > 0 and ch.fault_counts["detected"] == inj == ch.fault_counts["retries"]
    assert ch.fault_counts["delay"] > 0
    assert ch.counters is inner.counters and ch.counters == cc.counters == jcounters
    assert ch.size == 4 and len(ch.local_ranks) == 4 and ch.wire_digest()


def test_the_seed_is_the_scenario():
    counts = []
    for _ in range(2):
        ch = ChaosComm(TF.SimComm(4), seed=7, **CHAOS_RATES)
        TF.balance(_adapted(ch), ch)
        counts.append(dict(ch.fault_counts))
    assert counts[0] == counts[1]
    ch8 = ChaosComm(TF.SimComm(4), seed=8, **CHAOS_RATES)
    TF.balance(_adapted(ch8), ch8)
    assert ch8.fault_counts != counts[0] and ch8.fault_counts == _jax()[8][1]


def test_a_persistent_fault_exhausts_the_bounded_retries():
    ch = ChaosComm(TF.SimComm(2), config=ChaosConfig(
        seed=0, p_corrupt=1.0, persistent_faults=True, max_retries=3))
    with pytest.raises(WireIntegrityError):
        ch.allgather([np.arange(4, dtype=np.int64), "payload"])
    assert ch.fault_counts["corrupt"] == ch.fault_counts["detected"] == 4
    assert ch.fault_counts["retries"] == 3
    assert ch.fault_counts == _jax()["persistent"]


def test_a_stall_surfaces_as_a_timeout_named_by_its_phase():
    ch = ChaosComm(TF.SimComm(4), stall_after=2, phases=("balance",))
    ch.set_deadline(0.3)
    fs = _adapted(ch)
    with pytest.raises(CommTimeoutError) as ei:
        TF.balance(fs, ch)
    e = ei.value
    assert e.phase == "balance" and e.seq > 2 and e.elapsed_s > 0 and e.retries > 0
    assert "balance" in str(e) and "timed out" in str(e)
    assert (e.phase, e.seq, dict(ch.fault_counts)) == _jax()["stall"]


def test_a_crash_at_a_collective_raises_with_the_reference_fields():
    ch = ChaosComm(TF.SimComm(4), crash_at=3, crash_ranks=(3,), phases=("balance",))
    fs = _adapted(ch)
    with pytest.raises(InjectedCrash) as ei:
        TF.balance(fs, ch)
    e = ei.value
    assert (e.phase, e.seq, e.rank) == ("balance", 3, 3)
    assert (e.phase, e.seq, e.rank, dict(ch.fault_counts)) == _jax()["crash"]


def test_crash_autosave_recover_equals_a_fresh_small_world(tmp_path):
    """Crash rank 3 mid-Balance at P = 4, recover the Autosaver checkpoint
    onto a fresh P = 3 world, finish the Balance: the world equals a fresh
    P = 3 run of the port and of the JAX package, element for element."""
    ckpt = tmp_path / "autosave"
    ch = ChaosComm(TF.SimComm(4), crash_at=3, crash_ranks=(3,), phases=("balance",))
    saver = Autosaver(ckpt).install()
    try:
        fs = _adapted(ch)
        with pytest.raises(InjectedCrash):
            TF.balance(fs, ch)
    finally:
        saver.uninstall()
    assert saver.saved_steps == [0] and not TF.RESILIENCE_HOOKS
    c3 = TF.SimComm(3)
    rec = recover(ckpt, c3, cmesh=TC.cmesh_brick(2, (2, 1)), device="cpu")
    assert len(rec) == 3 and all(f.device.type == "cpu" for f in rec)
    done = TF.balance(rec, c3)
    c3f = TF.SimComm(3)
    fresh = TF.balance(_adapted(c3f), c3f)
    _assert_world_equal(_world(done), _world(fresh))
    _assert_world_equal(_world(done), _jax()["fresh3"])


def test_autosaver_every_and_events(tmp_path):
    comm = TF.SimComm(2)
    saver = Autosaver(tmp_path / "ck", every=2).install()
    try:
        fs = _adapted(comm)
        fs = TF.partition(fs, comm)       # "partition:begin" is not an event
        for _ in range(3):                # balance:begin 1, 2, 3: saves 1 and 3
            fs = TF.balance(fs, comm)
        fs = TF.repartition(fs, comm)     # repartition:begin, count 4: skipped
        fs = TF.repartition(fs, comm)     # count 5: saves
    finally:
        saver.uninstall()
    assert saver.saved_steps == [0, 1, 2] and saver.count == 5
    assert not TF.RESILIENCE_HOOKS
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_0", "step_1", "step_2"]
    assert comm.bytes_for("checkpoint") > 0
    events = []
    TF.RESILIENCE_HOOKS.append(lambda ev, f, c: events.append((ev, len(f))))
    try:
        TF.balance(TF.partition(fs, comm), comm)
    finally:
        TF.RESILIENCE_HOOKS.clear()
    assert events == [("partition:begin", 2), ("partition:end", 2),
                      ("balance:begin", 2), ("balance:end", 2)]


def test_a_corrupted_checkpoint_blob_is_refused(tmp_path):
    comm = TF.SimComm(2)
    fs = TF.balance(_adapted(comm), comm)
    save_forest(tmp_path / "ck", fs, comm, step=0)
    blobs = sorted((tmp_path / "ck" / "step_0").glob("arr_*.npy"), key=lambda p: p.stat().st_size)
    raw = bytearray(blobs[-1].read_bytes())
    raw[-1] ^= 0xFF
    blobs[-1].write_bytes(bytes(raw))
    with pytest.raises(CheckpointIntegrityError, match="integrity|unreadable"):
        recover(tmp_path / "ck", TF.SimComm(2), cmesh=TC.cmesh_brick(2, (2, 1)), device="cpu")


# ------------------------------------------------ kill one rank, for real
CRASH_SCRIPT = r"""
import os, sys, time
import torch

torch.set_num_threads(1)
port, pid, ckpt, device = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
from repro_torch.core import cmesh as C
from repro_torch.core import forest as F
from repro_torch.core.comm import DistComm
from repro_torch.core.errors import CommTimeoutError
from repro_torch.core.resilience import Autosaver, ChaosComm

comm = DistComm(timeout_s=60, namespace="crash.", beacon=True)
chaos = ChaosComm(comm, crash_at=3, crash_ranks=(3,), phases=("balance",),
                  hard_exit=True)   # rank 3 dies like a real process
cm = C.cmesh_brick(2, (2, 1))
fs0 = F.new_uniform(2, cm.num_trees, 2, chaos, cmesh=cm, device=device)
fs0 = [F.adapt(f, lambda t, e: ((e.anchor.sum(1) == 0) & (e.level < 4)).to(torch.int32),
               recursive=True) for f in fs0]
chaos.barrier()                     # every rank up before the deadline applies
chaos.set_deadline(3.0)             # the survivors' wait budget a collective
saver = Autosaver(ckpt).install()
try:
    F.balance(fs0, chaos)           # rank 3 never returns from here
    print(f"rank {pid}: balance finished", flush=True)
    os._exit(4)
except CommTimeoutError as e:
    assert e.phase == "balance", e
    assert e.pending and 3 in e.pending, e
    print(f"rank {pid}: timeout phase={e.phase} pending={e.pending} detail={e.detail}",
          flush=True)
    # rank 0 hosts the store: it leaves once every survivor has its diagnosis
    left = comm.store.add("crash.diagnosed", 1)
    t0 = time.monotonic()
    while pid == 0 and left < 3 and time.monotonic() - t0 < 30:
        time.sleep(0.02)
        left = comm.store.add("crash.diagnosed", 0)
    os._exit(3)
"""

RECOVER_SCRIPT = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
port, pid, ckpt, outdir, device = (sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                   sys.argv[5])
from repro_torch.core import cmesh as C
from repro_torch.core import forest as F
from repro_torch.core.comm import DistComm
from repro_torch.core.resilience import recover

comm = DistComm(timeout_s=60, namespace="recover.")
fs = recover(ckpt, comm, cmesh=C.cmesh_brick(2, (2, 1)), device=device)
assert len(fs) == 1 and fs[0].rank == pid and fs[0].num_ranks == 3
fs = F.balance(fs, comm)
np.savez(f"{outdir}/rank{pid}.npz",
         **{f"f_{k}": getattr(fs[0], k).cpu().numpy() for k in
            ("anchor", "level", "stype", "tree", "keys")})
with open(f"{outdir}/rank{pid}.json", "w") as f:
    json.dump({"counters": comm.counters}, f)
comm.barrier()
print(f"rank {pid}: recovery OK", flush=True)
"""


def test_kill_one_rank_and_recover_on_three_processes(tmp_path):
    """Four processes; rank 3 hard-exits (code 2) at its 3rd Balance
    collective; ranks 0-2 raise `CommTimeoutError` naming phase balance and
    pending [3]; a fresh world of three recovers the checkpoint the four
    saved and finishes Balance, equal to a fresh `SimComm(3)` run."""
    ckpt, outdir = tmp_path / "autosave", tmp_path / "out"
    outdir.mkdir()
    res = run_ranks(CRASH_SCRIPT, 4, extra_args=(ckpt, "cpu"), timeout=120.0, check=False)
    assert res[3][2] == 2, f"rank 3 must hard-exit(2): {res[3][1][-2000:]}"
    for pid in range(3):
        out, err, rc = res[pid]
        assert rc == 3, f"survivor {pid} exited {rc}: {err[-2000:]}"
        assert f"rank {pid}: timeout phase=balance pending=[3]" in out
        assert "'last_alive_gen': {3: " in out and "balance finished" not in out
    assert (ckpt / "step_0" / "manifest.json").exists()
    outs = run_ranks(RECOVER_SCRIPT, 3, extra_args=(ckpt, outdir, "cpu"), timeout=120.0)
    assert all(f"rank {pid}: recovery OK" in out for pid, (out, _e) in enumerate(outs))
    arrays, _facts = load_ranks(outdir, 3)
    c3 = TF.SimComm(3)
    fresh = _world(TF.balance(_adapted(c3), c3))
    got = {k: np.concatenate([a[f"f_{k}"] for a in arrays]) for k in WORLD}
    _assert_world_equal(got, fresh)
    assert len(got["level"]) == len(fresh["level"]) > 0
