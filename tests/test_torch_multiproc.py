"""The port's `run_ranks`: one hard wall clock for the fleet, and fleets
where a failure is the expected outcome.

The cases of the JAX package's `tests/core/test_multiproc_timeout.py`
against `repro_torch.launch.multiproc.run_ranks`: the scripts are plain
Python, so they exercise the harness alone — straggler kill and reap,
per-rank state and stderr in `RankTimeoutError`, the `check=False` triples
— plus the rendezvous variables each rank is given.
"""

import time

import pytest

from repro_torch.core.errors import RankTimeoutError
from repro_torch.launch.multiproc import run_ranks

# argv = [store_port, rank, *extra] — these scripts ignore the port.
HANG_ODD = r"""
import sys, time
rank = int(sys.argv[2])
if rank % 2:
    print("hanging", rank, flush=True)
    sys.stderr.write(f"rank {rank} entering infinite wait\n")
    sys.stderr.flush()
    time.sleep(3600)
print("done", rank, flush=True)
"""

EXIT_RANK = r"""
import sys
rank = int(sys.argv[2])
sys.stderr.write(f"rank {rank} failing on purpose\n")
print("ran", rank, flush=True)
sys.exit(rank)
"""

RENDEZVOUS = r"""
import os, sys
print(os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] == sys.argv[1],
      os.environ["RANK"] == sys.argv[2], os.environ["WORLD_SIZE"], sys.argv[3:],
      "repro_torch" in os.listdir(os.environ["PYTHONPATH"].split(os.pathsep)[0]))
"""


def test_wall_clock_timeout_kills_stragglers_and_diagnoses():
    t0 = time.monotonic()
    with pytest.raises(RankTimeoutError) as ei:
        run_ranks(HANG_ODD, 2, timeout=3.0)
    assert time.monotonic() - t0 < 30.0   # one deadline, not per-rank budgets
    e = ei.value
    assert set(e.per_rank) == {0, 1}
    state0, _ = e.per_rank[0]
    state1, tail1 = e.per_rank[1]
    assert state0 == "exited 0"
    assert state1 == "killed after wall-clock timeout"
    assert "entering infinite wait" in tail1
    msg = str(e)
    assert "1 of 2 rank(s) still running" in msg
    assert "rank 1: killed after wall-clock timeout" in msg


def test_timeout_with_all_ranks_hung():
    with pytest.raises(RankTimeoutError) as ei:
        run_ranks("import time\ntime.sleep(3600)\n", 2, timeout=2.0)
    assert all(st == "killed after wall-clock timeout" for st, _ in ei.value.per_rank.values())


def test_check_false_returns_per_rank_triples():
    res = run_ranks(EXIT_RANK, 3, timeout=60.0, check=False)
    assert [rc for _, _, rc in res] == [0, 1, 2]
    for pid, (out, err, _rc) in enumerate(res):
        assert f"ran {pid}" in out
        assert f"rank {pid} failing on purpose" in err


def test_check_true_raises_naming_failed_rank():
    with pytest.raises(RuntimeError, match=r"rank 1 exited 1"):
        run_ranks(EXIT_RANK, 2, timeout=60.0)


def test_fast_fleet_returns_pairs_under_check():
    outs = run_ranks("import sys\nprint('ok', sys.argv[2])\n", 2, timeout=60.0)
    assert [len(o) for o in outs] == [2, 2]
    assert "ok 0" in outs[0][0] and "ok 1" in outs[1][0]


def test_each_rank_gets_the_rendezvous_variables():
    outs = run_ranks(RENDEZVOUS, 3, extra_args=("cpu", 7), timeout=60.0)
    for out, _err in outs:
        assert out.split() == ["localhost", "True", "True", "3", "['cpu',", "'7']", "True"]
