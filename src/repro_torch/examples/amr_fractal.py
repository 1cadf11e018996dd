"""Paper Figure 12 reproduction (scaled): the fractal refinement pattern —
refine sub-tetrahedra of types 0 and 3 recursively — validated against the
analytic transfer-matrix count, plus the runtime linearity /
level-independence claims of Figure 11.

    python -m repro_torch.examples.amr_fractal                # on the card
    python -m repro_torch.examples.amr_fractal --device cpu   # plain versions
"""

from __future__ import annotations

import time

import torch

from repro_torch.core import forest as F
from repro_torch.core.tables import get_tables
from repro_torch.core.types import resolve_device
from repro_torch.examples import cli, sync

PAPER_LEVEL12 = 858_588_635_136


def analytic_fractal_count(trees: int, k: int, depth: int) -> int:
    """Elements after refining `trees` roots uniformly to level k, then
    types 0 and 3 `depth` more levels: the transfer matrix of the child
    types, in Python integers."""
    t = get_tables(3)
    M = [[0] * 6 for _ in range(6)]
    for b in range(6):
        for i in range(8):
            M[b][int(t.child_type[b, i])] += 1
    c = [trees, 0, 0, 0, 0, 0]
    for _ in range(k):
        c = [sum(c[a] * M[a][b] for a in range(6)) for b in range(6)]
    Fj = 1
    for _ in range(depth):
        Fj = 4 * Fj + 4
    refin = c[0] + c[3]
    return int(refin * Fj + (sum(c) - refin))


def fractal_cb(max_level: int):
    def cb(tree, elems):
        b = elems.stype
        return (((b == 0) | (b == 3)) & (elems.level < max_level)).to(torch.int32)
    return cb


def fig11(levels=(4, 5, 6), device=None) -> list[dict]:
    """Fig. 11's New on one tree and one rank at each level: element count,
    wall (a synchronize before each clock read) and ns per element."""
    dev = resolve_device(device)
    rows = []
    for level in levels:
        sync(dev)
        t0 = time.perf_counter()
        f = F.new_uniform_rank(3, 1, level, 0, 1, device=dev)
        sync(dev)
        dt = time.perf_counter() - t0
        rows.append({"level": level, "elements": f.num_local, "wall_s": dt,
                     "ns_per_element": dt / f.num_local * 1e9})
        del f
    return rows


def run(trees: int = 4, ks=(1, 2, 3), levels=(4, 5, 6), device=None) -> dict:
    """The example's counts and Fig. 11 rows; returns what `main` prints."""
    dev = resolve_device(device)
    comm = F.SimComm(4)
    measured = []
    for k in ks:
        fs = F.new_uniform(3, trees, k, comm, device=dev)
        fs = [F.adapt(f, fractal_cb(k + 2), recursive=True) for f in fs]
        measured.append((k, F.count_global(fs), analytic_fractal_count(trees, k, 2)))
    return {"n12": analytic_fractal_count(512, 7, 5), "measured": measured,
            "fig11": fig11(levels, dev)}


def main(device=None) -> dict:
    r = run(device=device)
    n12 = r["n12"]
    print("== paper Fig. 12 extrapolation (transfer matrix) ==")
    print(f"   512 trees, k=7 -> level 12: {n12:,} elements "
          f"(paper reports {PAPER_LEVEL12:,}; delta {abs(n12 - PAPER_LEVEL12) / PAPER_LEVEL12:.2%} "
          f"from the unspecified coarse-mesh type mix)")
    for k, got, want in r["measured"]:
        print(f"   measured k={k}: {got:,} == analytic {want:,}: {got == want}")
    print("== paper Fig. 11: New is linear in elements, level-independent ==")
    for row in r["fig11"]:
        print(f"   level {row['level']}: {row['elements']:>9,} elements  {row['wall_s']:7.3f}s  "
              f"{row['ns_per_element']:7.1f} ns/element")
    return r


if __name__ == "__main__":
    cli(main)
