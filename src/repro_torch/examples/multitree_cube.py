"""Inter-tree connectivity demo: one connected cube domain of Kuhn simplices.

The unit cube splits into d! root simplices (2 triangles / 6 tetrahedra)
glued along their shared faces (`repro_torch.core.cmesh`); refinement
driven inside ONE tree ripples across tree faces during Balance, while
Ghost returns remote leaves from *other* trees, re-expressed in their owner
tree's coordinates.

    python -m repro_torch.examples.multitree_cube                # on the card
    python -m repro_torch.examples.multitree_cube --device cpu   # plain versions
"""

from __future__ import annotations

import torch

from repro_torch.core import cmesh as C
from repro_torch.core import forest as F
from repro_torch.core.types import resolve_device
from repro_torch.examples import cli


def corner_cb(deep: int):
    def cb(tree, elems):
        return ((tree == 0) & (elems.anchor.sum(1) == 0) & (elems.level < deep)).to(torch.int32)
    return cb


def _per_tree(fs, num_trees: int) -> list:
    return torch.bincount(torch.cat([f.tree for f in fs]).long(),
                          minlength=num_trees).tolist()


def cube(d: int, base: int, deep: int, ranks: int = 2, device=None) -> dict:
    """One cube of d! trees on `ranks` ranks: New at `base`, tree 0's origin
    corner refined to `deep`, Balance, Ghost and rank 0's face kinds."""
    dev = resolve_device(device)
    cm = C.cmesh_unit_cube(d)
    out = {"d": d, "trees": cm.num_trees, "glued": int((cm.face_tree >= 0).sum())}
    comm = F.SimComm(ranks)
    fs = F.new_uniform(d, cm.num_trees, base, comm, cmesh=cm, device=dev)

    # refine the origin corner of tree 0 only
    fs = [F.adapt(f, corner_cb(deep), recursive=True) for f in fs]
    out["before"], out["per_tree_before"] = F.count_global(fs), _per_tree(fs, cm.num_trees)
    fs = F.balance(fs, comm)
    out["after"], out["per_tree"] = F.count_global(fs), _per_tree(fs, cm.num_trees)

    gh = F.ghost(fs, comm)
    out["ghosts"] = sum(len(g["level"]) for g in gh)
    out["cross"] = sum(int((~torch.isin(g["tree"], fs[p].tree)).sum()) for p, g in enumerate(gh))
    out["valid"] = F.validate(fs, gh)

    # face classification on rank 0 (the old is_root_boundary, split)
    kinds = F.face_kinds(fs[0], fs[0].simplices())  # all faces, one sweep
    out["faces"] = {name: int((kinds == kind).sum())
                    for name, kind in (("interior", F.FACE_INTERIOR),
                                       ("inter-tree", F.FACE_INTER_TREE),
                                       ("domain boundary", F.FACE_DOMAIN_BOUNDARY))}
    return out


def run(cases=((2, 2, 5), (3, 1, 4)), periodic_level: int = 2, device=None) -> dict:
    """Each (d, base, deep) cube, then the fully periodic 2D cube's boundary
    faces; returns what `main` prints."""
    dev = resolve_device(device)
    cubes = [cube(d, base, deep, device=dev) for d, base, deep in cases]
    # fully periodic cube: no boundary at all
    cm = C.cmesh_unit_cube(2, periodic=(True, True))
    fs = F.new_uniform(2, cm.num_trees, periodic_level, F.SimComm(1), cmesh=cm, device=dev)
    nb = int((F.face_kinds(fs[0], fs[0].simplices()) == F.FACE_DOMAIN_BOUNDARY).sum())
    return {"cubes": cubes, "periodic_boundary_faces": nb}


def main(device=None) -> dict:
    r = run(device=device)
    for c in r["cubes"]:
        print(f"== d={c['d']}: {c['trees']}-tree cube, {c['glued']} glued tree faces ==")
        print(f"   balance: {c['before']} -> {c['after']} elements; per tree "
              f"{c['per_tree_before']} -> {c['per_tree']} "
              f"(refinement crossed the tree faces)")
        print(f"   ghost: {c['ghosts']} entries, {c['cross']} from trees the rank holds "
              f"no elements of; validate(fs, gh) = {c['valid']}")
        fc = c["faces"]
        print(f"   rank-0 faces: {fc['interior']} interior, {fc['inter-tree']} inter-tree, "
              f"{fc['domain boundary']} domain boundary")
    print(f"== periodic 2D cube: {r['periodic_boundary_faces']} boundary faces (torus) ==")
    return r


if __name__ == "__main__":
    cli(main)
