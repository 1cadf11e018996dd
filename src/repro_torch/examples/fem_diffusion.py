"""Finite-volume diffusion on an adapted tetrahedral forest.

Shows the AMR library as a numerical substrate: a piecewise-constant field
lives on the leaves of an adapted forest; explicit heat diffusion exchanges
flux across interior faces enumerated by `iterate` (paper Sec. 5), with a
hot blob refined to two extra levels.  Verifies discrete conservation
(sum u * volume is constant) and monotone decay of the max.  The field and
the steps live on the forest's device, in float64.

    python -m repro_torch.examples.fem_diffusion                # on the card
    python -m repro_torch.examples.fem_diffusion --device cpu   # plain versions
"""

from __future__ import annotations

import time

import torch

from repro_torch.core import forest as F
from repro_torch.core.ops import ops3d
from repro_torch.core.types import resolve_device
from repro_torch.examples import cli, sync

CENTER = (0.9, 0.1, 0.5)


def volumes(f) -> torch.Tensor:
    # each level-l tet has volume (1/6) * 8^-l of the unit cube (root tet = 1/6)
    return torch.ldexp(torch.full(f.level.shape, 1.0 / 6.0, dtype=torch.float64,
                                  device=f.device), -3 * f.level)


def _distance(s) -> torch.Tensor:
    """Each element's centroid distance to CENTER, in float64 as numpy."""
    c = ops3d.coordinates(s).double().mean(dim=1) / (1 << ops3d.L)
    x0 = torch.tensor(CENTER, dtype=torch.float64, device=c.device)
    return ((c - x0) ** 2).sum(dim=1).sqrt()


def near_corner_cb(deep: int, radius: float = 0.25):
    def near_corner(tree, elems):
        return ((_distance(elems) < radius) & (elems.level < deep)).to(torch.int32)
    return near_corner


def run(level: int = 2, deep: int = 4, steps: int = 60, device=None) -> dict:
    """New at `level`, the blob refined to `deep`, Balance, Iterate's pairs and
    `steps` explicit steps; returns what `main` prints, and the walls of
    each stage (a synchronize before each clock read)."""
    dev = resolve_device(device)
    walls = {}

    def clock(name, t0):
        sync(dev)
        walls[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    comm = F.SimComm(1)
    fs = F.new_uniform(3, 1, level, comm, device=dev)
    t = clock("new", t)
    # refine around a hot corner blob
    fs = [F.adapt(f, near_corner_cb(deep), recursive=True) for f in fs]
    t = clock("adapt", t)
    fs = F.balance(fs, comm)
    t = clock("balance", t)
    f = fs[0]
    n = f.num_local
    out = {"leaves": n, "levels": (int(f.level.min()), int(f.level.max()))}

    # initial condition: hot blob
    u = torch.exp(-40 * _distance(f.simplices()) ** 2)
    vol = volumes(f)
    total0 = float((u * vol).sum())

    # face pairs once (mesh is static during the solve)
    t = time.perf_counter()
    pairs = {}
    F.iterate(f, face_fn=lambda ff, pp: pairs.setdefault("p", pp))
    p = pairs["p"]
    i, j = p[:, 0], p[:, 1]
    out["pairs"] = len(p)
    t = clock("iterate", t)

    # explicit diffusion: du_i = dt * sum_faces k * (u_j - u_i) * A_ij / vol_i
    # (uniform transmissibility; hanging faces appear as coarse-fine pairs)
    vi, vj = vol[i], vol[j]
    area = torch.minimum(vi, vj) ** (2 / 3)
    rowsum = torch.zeros(n, dtype=torch.float64, device=dev)
    rowsum.index_add_(0, i, area / vi).index_add_(0, j, area / vj)
    dt_k = 0.9 / rowsum.max()  # explicit stability bound
    shown = []
    for step in range(steps):
        flux = dt_k * (u[j] - u[i]) * area
        du = torch.zeros_like(u)
        du.index_add_(0, i, flux / vi).index_add_(0, j, -flux / vj)
        u = u + du
        if step % 20 == 0:
            total = float((u * vol).sum())
            shown.append((step, float(u.max()), abs(total - total0) / total0))
    total = float((u * vol).sum())
    t = clock("steps", t)
    out.update(shown=shown, conservation_error=abs(total - total0) / total0,
               max_u=float(u.max()), walls=walls)
    if not out["conservation_error"] < 1e-12:
        raise AssertionError("not conservative!")
    if not out["max_u"] < 1.0:
        raise AssertionError("diffusion must decay the max")
    return out


def main(device=None) -> dict:
    r = run(device=device)
    print(f"adapted+balanced mesh: {r['leaves']} leaves, levels "
          f"{r['levels'][0]}..{r['levels'][1]}")
    print(f"interior face pairs: {r['pairs']}")
    for step, umax, err in r["shown"]:
        print(f"step {step:3d}: max u = {umax:.4f}, conservation error = {err:.2e}")
    print("conservation + decay verified")
    return r


if __name__ == "__main__":
    cli(main)
