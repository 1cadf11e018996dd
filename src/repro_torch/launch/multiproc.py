"""Spawn P rank processes that meet at a `torch.distributed.TCPStore`.

The subprocess harness of the port's `DistComm` runs: bind a free localhost
port for the store, launch P copies of a `python -c` script, one rank each,
run them CONCURRENTLY (the ranks meet at the store that rank 0 hosts, so
launching them one after another would deadlock), and collect per-rank
(stdout, stderr), killing the whole fleet if any rank outlasts the wall
clock.

Each rank gets argv = [store_port, rank, *extra_args] and the parent's
environment with the repository's `src` first on PYTHONPATH and torch's
rendezvous variables set: MASTER_ADDR=localhost, MASTER_PORT (the store's
port), RANK and WORLD_SIZE — so `DistComm()` with no arguments binds to
the store.  Nothing else of the environment is changed; a rank script
takes its device (`cpu` or `cuda`) as one of its own arguments.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from ..core.errors import RankTimeoutError

__all__ = ["SKEW_BRICK_SETUP", "WEAK_BRICK_SETUP", "free_port", "run_ranks"]

_SRC = Path(__file__).resolve().parents[2]

# The weak-scaling scenario of the DistComm runs of several processes: a 2D
# Kuhn brick with one cube column per rank and corner refinement (cap =
# level + 2) in EVERY tree, so the per-rank element load is constant in P
# and the 2:1 ripple crosses every inter-cell face.  `exec` it with `torch`,
# `C` (repro_torch.core.cmesh), `F` (repro_torch.core.forest), `P`,
# `level`, `device` and `comm_ov` bound; it defines `corner`, `cm` and the
# adapted single-local-rank forest list `fs0`.  The JAX package's
# `WEAK_BRICK_SETUP`, with callbacks on tensors.
WEAK_BRICK_SETUP = r"""
def corner(tree, elems, cap=level + 2):
    return ((elems.anchor.sum(1) == 0) & (elems.level < cap)).to(torch.int32)

cm = C.cmesh_brick(2, (P, 1))   # one Kuhn cell column per rank
fs0 = F.new_uniform(2, cm.num_trees, level, comm_ov, cmesh=cm, device=device)
fs0 = [F.adapt(fs0[0], corner, recursive=True)]
"""

# The skewed-adapt scenario of the dynamic-repartition runs: the same Kuhn
# brick, but only the FIRST cube cell (trees 0 and 1) refines — to level 4
# from a level-2 uniform start — so the initial SFC split leaves almost all
# elements on the low ranks and `repartition` has real migration to do.
# `exec` it with `torch`, `C`, `F`, `P` (the brick width, the world size in
# runs of one rank a process), `device` and `comm_ov` bound; it defines
# `skew`, `cm` and the adapted forest list `fs0` (one entry per local rank).
SKEW_BRICK_SETUP = r"""
def skew(tree, elems, cap=4):
    return ((tree < 2) & (elems.level < cap)).to(torch.int32)

cm = C.cmesh_brick(2, (P, 1))   # one Kuhn cell column per rank
fs0 = F.new_uniform(2, cm.num_trees, 2, comm_ov, cmesh=cm, device=device)
fs0 = [F.adapt(f, skew, recursive=True) for f in fs0]
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(script: str, num_ranks: int, extra_args: tuple = (),
              timeout: float = 600.0, check: bool = True):
    """Run `script` in `num_ranks` concurrent subprocesses.

    Each subprocess receives argv = [store_port, rank, *extra_args] and the
    parent's environment with `src` on PYTHONPATH and MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE set.

    `timeout` is one HARD wall clock for the whole fleet (not a per-rank
    budget that stacks to P * timeout when every rank hangs): the deadline
    starts at launch, every rank's `communicate` gets only the remaining
    slice, and on expiry ALL stragglers are killed and a `RankTimeoutError`
    reports each rank's state with its captured stderr tail.

    With `check` (the default) a nonzero rank raises RuntimeError naming it
    with its stderr tail, and the return value is the `(stdout, stderr)`
    pair list; `check=False` returns the per-rank `(stdout, stderr,
    returncode)` triples instead — for fleets where a crash is the expected
    outcome.
    """
    port = free_port()
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(
        [str(_SRC), *filter(None, [base.get("PYTHONPATH")])])
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(num_ranks))
    deadline = time.monotonic() + timeout
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(port), str(pid),
             *[str(a) for a in extra_args]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**base, "RANK": str(pid)},
        )
        for pid in range(num_ranks)
    ]
    outs: list = [None] * num_ranks
    timed_out = False
    for pid, pr in enumerate(procs):
        try:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise subprocess.TimeoutExpired(pr.args, timeout)
            outs[pid] = pr.communicate(timeout=remaining)
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out:
        for p2 in procs:
            p2.kill()
        per_rank = {}
        for pid, p2 in enumerate(procs):  # reap: no zombies, no undrained pipes
            if outs[pid] is None:
                try:
                    out, err = p2.communicate(timeout=5.0)
                except subprocess.TimeoutExpired:
                    p2.wait()
                    out, err = "", ""
                outs[pid] = (out, err)
                state = "killed after wall-clock timeout"
            else:
                state = f"exited {p2.returncode}"
            per_rank[pid] = (state, outs[pid][1][-2000:])
        lines = "\n".join(f"  rank {pid}: {st}\n    stderr: {tail!r}"
                          for pid, (st, tail) in per_rank.items())
        raise RankTimeoutError(
            f"run_ranks hit its {timeout:.1f}s wall clock with "
            f"{sum(1 for s, _ in per_rank.values() if 'killed' in s)} of "
            f"{num_ranks} rank(s) still running:\n{lines}",
            per_rank=per_rank)
    if not check:
        return [(out, err, procs[pid].returncode)
                for pid, (out, err) in enumerate(outs)]
    for pid, (out, err) in enumerate(outs):
        if procs[pid].returncode != 0:
            raise RuntimeError(
                f"rank {pid} exited {procs[pid].returncode}: {err[-3000:]}")
    return outs
