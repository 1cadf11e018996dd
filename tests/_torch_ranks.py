"""Rank scripts of the port's multi-process tests, and their results.

No JAX here: `tests/test_torch_cuda.py` runs `PIPELINE_SCRIPT` on the card
where only PyTorch is installed.  Each script runs under
`repro_torch.launch.multiproc.run_ranks` (argv = [store_port, rank, outdir,
device]) and saves its rank's results to `<outdir>/rank<r>.npz`, its
per-phase counters and wire digest to `<outdir>/rank<r>.json`.
"""

import json
from pathlib import Path

import numpy as np

FOREST_FIELDS = ("anchor", "level", "stype", "tree", "keys")
GHOST_FIELDS = ("anchor", "level", "stype", "tree", "owner")

# The pipeline of the JAX package's `tests/substrate/test_distcomm.py`, one
# rank a process over `DistComm`: collectives of arrays (on a second
# namespace, so the pipeline's counters hold the pipeline alone), the wire
# digest recomputed from the codec, then New -> Adapt (corner to level 4)
# -> Balance -> Ghost -> count_global -> Partition on d = 2, two trees.
PIPELINE_SCRIPT = r"""
import hashlib, json, struct, sys
import numpy as np
import torch

torch.set_num_threads(1)
port, pid, outdir, device = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
from repro_torch.core import forest as F
from repro_torch.core.comm import DistComm, encode_payload

comm = DistComm(timeout_s=60)
side = DistComm(timeout_s=60, namespace="side.")   # shares the store
assert comm.size == 2 and comm.rank == pid and list(comm.local_ranks) == [pid]
x = np.full(3, pid, np.int32)
assert [int(g[0]) for g in side.allgather([x])] == [0, 1]
blob = encode_payload(x)
h = hashlib.sha256()
h.update(struct.pack("<II", 1 - pid, len(blob)))
h.update(blob)
assert side.wire_digest() == h.hexdigest(), "transport bytes != packed codec"
recv = side.alltoallv([[np.full(2, 10 * pid + q, np.int32) for q in range(2)]])
assert [int(r[0]) for r in recv[0]] == [pid, 10 + pid]

def corner(tree, e, cap=4):
    return ((e.anchor.sum(1) == 0) & (e.level < cap)).to(torch.int32)

fs = F.new_uniform(2, 2, 2, comm, device=device)
assert len(fs) == 1 and fs[0].rank == pid
fs = [F.adapt(fs[0], corner, recursive=True)]
fs = F.balance(fs, comm)
gh = F.ghost(fs, comm)
n_global = F.count_global(fs, comm)
fs = F.partition(fs, comm)
assert F.count_global(fs, comm) == n_global
np.savez(f"{outdir}/rank{pid}.npz",
         **{f"f_{k}": getattr(fs[0], k).cpu().numpy() for k in
            ("anchor", "level", "stype", "tree", "keys")},
         **{f"g_{k}": gh[0][k].cpu().numpy() for k in
            ("anchor", "level", "stype", "tree", "owner")})
with open(f"{outdir}/rank{pid}.json", "w") as out:
    json.dump({"counters": comm.counters, "n_global": n_global,
               "digest": comm.wire_digest(), "device": fs[0].device.type}, out)
comm.barrier()
print(f"rank {pid}: pipeline OK", flush=True)
"""


def corner_cb(cap: int = 4):
    """The scripts' corner refinement, as a port callback."""
    import torch

    def cb(tree, e):
        return ((e.anchor.sum(1) == 0) & (e.level < cap)).to(torch.int32)
    return cb


def load_ranks(outdir, P: int) -> tuple[list, list]:
    """([per-rank arrays], [per-rank JSON facts]) the ranks saved."""
    outdir = Path(outdir)
    arrays = [dict(np.load(outdir / f"rank{r}.npz")) for r in range(P)]
    facts = [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(P)]
    return arrays, facts


def summed_bytes(facts: list) -> dict:
    """Each phase's bytes summed over the ranks: what `SimComm` meters for
    the whole world (a DistComm rank meters its own posts)."""
    out: dict = {}
    for f in facts:
        for ph, b in f["counters"].items():
            out[ph] = out.get(ph, 0) + b["allgather_bytes"] + b["alltoallv_bytes"]
    return out


def assert_ranks_equal(arrays: list, forests: list, ghosts: list | None = None) -> None:
    """The ranks' saved forests (and ghosts) equal `forests` / `ghosts`
    (port objects of the same world) field for field."""
    assert len(arrays) == len(forests)
    for r, (a, f) in enumerate(zip(arrays, forests)):
        for k in FOREST_FIELDS:
            np.testing.assert_array_equal(a[f"f_{k}"], getattr(f, k).cpu().numpy(),
                                          err_msg=f"rank {r} {k}")
        if ghosts is not None:
            for k in GHOST_FIELDS:
                np.testing.assert_array_equal(a[f"g_{k}"], ghosts[r][k].cpu().numpy(),
                                              err_msg=f"rank {r} ghost {k}")
