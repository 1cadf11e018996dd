"""Quickstart: the tetrahedral SFC end to end.

Builds a forest over 2 root tetrahedra, refines adaptively near the domain
diagonal, 2:1-balances, partitions by weight across 4 simulated ranks,
builds the ghost layer, and round-trips elements through the kernels.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu   # plain versions
"""

from __future__ import annotations

import torch

from repro_torch.core import forest as F
from repro_torch.core.ops import ops3d
from repro_torch.core.types import Simplex, resolve_device
from repro_torch.examples import cli, where
from repro_torch.kernels import ops as kops


def near_diagonal_cb(width: float = 0.1, max_level: int = 5):
    """Refine elements whose centroid lies within `width` of the diagonal,
    up to `max_level`; centroids in float64, as numpy computes them."""
    L = ops3d.L

    def near_diagonal(tree, elems):
        c = ops3d.coordinates(elems).double().mean(dim=1)  # centroids
        t = c / (1 << L)
        d = (t - t.mean(dim=1, keepdim=True)).abs().max(dim=1).values
        return ((d < width) & (elems.level < max_level)).to(torch.int32)

    return near_diagonal


def run(trees: int = 2, level: int = 2, ranks: int = 4, width: float = 0.1,
        max_level: int = 5, device=None) -> dict:
    """The quickstart's pipeline; returns what `main` prints."""
    dev = resolve_device(device)
    out = {"device": dev}
    comm = F.SimComm(ranks)
    fs = F.new_uniform(3, trees, level, comm, device=dev)
    out["local_counts"] = [f.num_local for f in fs]
    out["valid_new"] = F.validate(fs)

    fs = [F.adapt(f, near_diagonal_cb(width, max_level), recursive=True) for f in fs]
    out["adapted"], out["valid_adapted"] = F.count_global(fs), F.validate(fs)

    fs = F.balance(fs, comm)
    out["balanced"], out["valid_balanced"] = F.count_global(fs), F.validate(fs)

    fs = F.partition(fs, comm, weights=[2.0 ** f.level.double() for f in fs])
    loads = [float((2.0 ** f.level.double()).sum()) for f in fs]
    out["loads"] = [round(x) for x in loads]
    out["imbalance"] = round(max(loads) / (sum(loads) / ranks), 4)

    gh = F.ghost(fs, comm)
    out["ghosts"] = [len(g["level"]) for g in gh]

    f0 = fs[0]
    s = f0.simplices()
    key = kops.morton_key(s.anchor, s.stype)
    anchor, _stype = kops.decode(3, key, s.level)
    out["roundtrip"] = torch.equal(anchor, f0.anchor)
    nb_anchor, nb_type, _dual = kops.face_neighbor(
        s.anchor, s.level, s.stype, torch.zeros_like(s.level))
    nb = Simplex(nb_anchor, s.level, nb_type)
    out["inside"] = int(ops3d.is_inside_root(nb).sum())
    out["rank0"] = f0.num_local
    return out


def main(device=None) -> dict:
    r = run(device=device)
    print("== New: uniform level-2 forest of 2 trees on 4 ranks ==")
    print("   local counts:", r["local_counts"], "valid:", r["valid_new"])
    print("== Adapt: refine elements near the domain diagonal, 3 rounds ==")
    print("   adapted:", r["adapted"], "elements; valid:", r["valid_adapted"])
    print("== Balance: enforce 2:1 across faces ==")
    print("   balanced:", r["balanced"], "elements; valid:", r["valid_balanced"])
    print("== Partition: weight ~ 2^level (finer elements cost more) ==")
    print("   per-rank load:", r["loads"], "imbalance:", r["imbalance"])
    print("== Ghost layer ==")
    print("   ghosts per rank:", r["ghosts"])
    kind = "CUDA kernels" if r["device"].type == "cuda" else "plain versions of the kernels"
    print(f"== {kind} on {where(r['device'])} ==")
    print("   encode->decode roundtrip on rank 0:", r["roundtrip"])
    print("   face-0 neighbors inside root:", r["inside"], "/", r["rank0"])
    return r


if __name__ == "__main__":
    cli(main)
