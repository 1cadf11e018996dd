"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each against its plain PyTorch version, drives the paper's New -> Adapt ->
Partition -> Balance -> Ghost -> validate path at full size on the card,
without and with a coarse mesh, asks the paper's element queries of every
leaf, and checks the card against the CPU.  Phases, in the order they run;
any failure exits nonzero:

  1. card and build: the card's name and power limit, torch and CUDA
     versions, the kernels' build from an empty build directory;
  2. kernel vs plain: each of the eleven kernels against its plain version
     on N = 2^22 random elements (every level 0..L, every type, every one
     of the d*L key bits set somewhere; for face_sweep, inside_root,
     face_neighbor and tree_transform half the elements anywhere in the
     root cube, outside the root simplex, face_neighbor over every (type,
     face) pair; for eval_route and owner_rank P = 4 markers with an empty
     rank, and again P = 8192, past the 4096 the kernels keep in shared
     memory; for successor element 0 and the last element of every level,
     which wraps to element 0; for
     tree_transform a face neighbor of each element, just outside the root,
     across every glued face of a periodic brick, and sigma = -1
     crossings, with anchor words that wrap past 2^31 - 1 at d = 2), d = 2
     and 3, exact equality; kernel and plain times by CUDA events around a
     loop of calls, the kernel's device time per launch by CUDA events
     around launches queued behind a spinning kernel (no host time), and
     the byte bound (bytes moved / 3.35 TB/s, the H100 SXM's device memory
     rate);
  3. main path at full size, no coarse mesh: d = 3, 8 trees on SimComm(4)
     (all four ranks on the card): New at level 6 (2,097,152 tets),
     recursive Adapt with the paper's Fig. 12 fractal callback to level 8
     (26,575,872 tets), Adapt coarsening every level-8 family of trees 4-7
     (16,784,384 tets, ranks 0-1 holding 3.8 times what ranks 2-3 hold),
     Partition (per-rank counts within 1, about 9.09 M tets migrating), and
     a repartition with weights 1 + (level == 8); stored order and volume
     coverage are checked after each partition; then Balance, Ghost and
     validate(forests, ghosts), which must hold;
  3d. the element queries on phase 3's balanced forests (21,676,544 tets),
     through `BatchedOps`: every leaf's owner rank against the partition
     markers is its rank; morton_key(successor(a)) is the next leaf's key
     in global stored order, 0 for the last leaf of a tree;
     predecessor(successor(a)) == a; face_neighbor(s, f) is plane f of
     face_sweep(s); each query's wall time on the host clock; then, outside
     the counted run, face_neighbor of the largest rank's leaves, every
     face, against its plain version (face_sweep shares its per-face step);
  3c. the coarse-mesh path at full size: the 48 trees of
     cmesh_brick(3, (2, 2, 2), periodic=(True, True, False)) (176 of 192
     tree faces glued) on SimComm(4): New at level 5 (1,572,864 tets), the
     fractal to level 7 (19,958,784), coarsening trees 24-47 (12,604,416),
     Partition (more than 6 M tets migrating), the weighted repartition,
     every element of tree 0 with a face on its root boundary refined to
     level 9 (so that all of tree 0's faces hold level-9 leaves against
     leaves of level 5-7 across them: tree 0's root faces tiled by
     4 * 4^9 faces of level-9 leaves), Balance, Ghost and validate; element
     faces whose neighbor region holds a leaf more than one level finer are
     counted before and after Balance, split into interior and inter-tree
     faces (at least 10,000 inter-tree ones before, none of either after);
  3b. the kernels timed (both ways, as in phase 2) at the sizes phases 3,
     3d and 3c launched them with (the smallest, two between and the
     largest, per kernel); New's "decode" and "successor" methods on
     16,777,216 tets (d = 3, 8 trees, level 7, 3 ranks): the same forests,
     and the wall of each;
  4. card vs CPU: the same pipelines at small size (level 1 -> 3) on both
     devices — d = 3 and d = 2 on 8 trees, and over the 48-tree brick, a
     periodic 2 x 2 brick of triangles and the rotated pair, with tree 0's
     faces refined to level 4 (d = 3) or 5 (d = 2) — every forest and ghost
     field and every per-phase byte count identical;
  5. launch counts: every kernel of the pipeline launched in phase 3
     (tree_transform aside: that path has no tree faces) and in phase 3c,
     owner_rank (Ghost's owner lookup) among them; owner_rank, successor
     and face_neighbor launched in phase 3d; no plain version called in
     any of the three.

The second-to-last lines are a JSON `kernels` line and the `nvidia-smi`
name/power-limit line; the last line is the JSON result.  In the `kernels`
line, `launches_phase3`, `launches_phase3c` and `launches_phase3d` are
each kernel's launches in those phases, and `launches` is those of the
first of phases 3, 3c and 3d that runs it: phase 3 for the eight kernels
of the cmesh-free pipeline, phase 3c for `tree_transform`, phase 3d for
`successor` and `face_neighbor`.  Without a card,
or without the repository beside it, the script exits nonzero and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_KERNEL = 1 << 22
SEED = 12
EVAL_ROUTE_MANY = "eval_route P=8192"   # phase 2's eval_route past 4096 markers
OWNER_RANK_MANY = "owner_rank P=8192"   # phase 2's owner_rank past 4096 markers
# Device memory rate of one H100 SXM at its full 700 W limit (NVIDIA's H100
# data sheet).  The bound of every kernel here is bytes over this rate.
MEM_BYTES_PER_S = 3.35e12
REPLACES = {
    "morton_key": "src/repro/kernels/sfc.py:557",
    "decode": "src/repro/kernels/sfc.py:573",
    "parent": "src/repro/kernels/sfc.py:627",
    "children": "src/repro/kernels/sfc.py:644",
    "face_sweep": "src/repro/kernels/sfc.py:604",
    "eval_route": "src/repro/kernels/sfc.py:715",
    "inside_root": "src/repro/kernels/sfc.py:662",
    "tree_transform": "src/repro/kernels/sfc.py:678",
    "owner_rank": "src/repro/kernels/sfc.py:696",
    "successor": "src/repro/kernels/sfc.py:739",
    "face_neighbor": "src/repro/kernels/sfc.py:588",
}
SOURCE = "src/repro_torch/kernels/csrc/sfc.cu"
WIRE_TRIPLE_BYTES = 13
# Phase 3c: inter-tree faces with a leaf more than one level finer across
# them before Balance, at least (tree 0's faces at level 9 against leaves
# of level 5-7 in the trees they are glued to).
MIN_INTER_TREE_JUMPS = 10_000
TREE_FACES_LEVEL = 9   # phase 3c: tree 0's faces refined to this level


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn` on the card, warmed, over `reps` calls."""
    fn()
    sync()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of one call of `fn`, by CUDA events around `reps`
    calls queued behind a spinning kernel: the host enqueues every call
    while the card still spins, so the card runs them back to back and the
    events see no host time (the plain loop of `cuda_ms` also counts the
    wrapper's host time, which bounds it below at about 0.02 ms a call).
    The spin grows fourfold until the queue provably outlasts the
    enqueueing."""
    fn()
    sync()
    cycles = 20_000_000                      # about 10 ms at the H100's clock
    for _ in range(6):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        still_spinning = not t0.query()
        t1.synchronize()
        if still_spinning:
            return t0.elapsed_time(t1) / reps
        cycles *= 4
    raise AssertionError(f"the host did not enqueue {reps} calls within a spin of "
                         f"{cycles // 4} cycles")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------ 2: kernels
def random_inputs(d: int, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(key, level): levels uniform over 0..L, keys uniform over all d*L
    bits (digits below an element's level are garbage on purpose)."""
    from repro_torch.core.tables import MAXLEVEL

    L = MAXLEVEL[d]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + d)
    level = torch.randint(0, L + 1, (n,), generator=gen, device=device, dtype=torch.int32)
    hi = torch.randint(0, 1 << 31, (n,), generator=gen, device=device, dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, (n,), generator=gen, device=device, dtype=torch.int64)
    key = ((hi << 32) | lo) & ((1 << (d * L)) - 1)
    return key, level


def route_markers(d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """P = 4 lex-sorted partition markers over trees 0..3 with rank 1 empty
    (its marker repeats rank 2's), as the marker table gives them."""
    from repro_torch.core.tables import MAXLEVEL

    q = 1 << (d * MAXLEVEL[d] - 2)
    mt = torch.tensor([0, 1, 1, 2], dtype=torch.int32, device=device)
    mk = torch.tensor([0, q, q, 3 * q], dtype=torch.int64, device=device)
    return mt, mk


def many_markers(d: int, P: int, device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """P lex-sorted markers over trees 0..3, more than eval_route keeps in
    shared memory, with one empty rank (its marker repeats the next
    rank's) and a trailing (4, 0) sentinel; returns (tree, key, the empty
    rank)."""
    from repro_torch.core.tables import MAXLEVEL

    rng = np.random.default_rng(SEED + 100 * d)
    mt = rng.integers(0, 4, P).astype(np.int32)
    mk = rng.integers(0, 1 << (d * MAXLEVEL[d]), P, dtype=np.uint64).astype(np.int64)
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    empty = P // 2
    mt[empty], mk[empty] = mt[empty + 1], mk[empty + 1]
    mt[-1], mk[-1] = 4, 0
    return torch.from_numpy(mt).to(device), torch.from_numpy(mk).to(device), empty


@functools.lru_cache(maxsize=None)
def transform_connections(d: int, device):
    """The connections phase 2 crosses: every glued face of a periodic
    brick, of the rotated pair (sigma = -1) at d = 2, and at d = 3, whose
    meshes here glue with sigma = +1 only, two reflected rows made by
    `pack_connection`.  Returns (packed int32 table (C, W) on `device`,
    linear parts (C, d, d) and unwrapped translations (C, d), int64)."""
    from repro_torch.core import cmesh as C

    Ms, cs, rows = [], [], []
    meshes = [C.cmesh_brick(d, (2,) * d, periodic=(True,) * d)]
    if d == 2:
        meshes.append(C.cmesh_rotated_pair())
    for cm in meshes:
        for t, f in zip(*np.nonzero(cm.face_tree >= 0)):
            Ms.append(cm.face_M[t, f])
            cs.append(cm.face_c[t, f])
            rows.append(cm.gluing("cpu").conn[t * (d + 1) + f].numpy())
    if d == 3:
        L = C.MAXLEVEL[3]
        for sigma in (1, -1):
            M = sigma * np.roll(np.eye(3, dtype=np.int64), 1, axis=1)
            c = np.array([2, -1, 1], np.int64) << L
            tm, vm = C.signed_perm_maps(3, M)
            Ms.append(M)
            cs.append(c)
            rows.append(C.pack_connection(3, M, c, tm, vm, 5))
    return (torch.from_numpy(np.stack(rows)).to(device),
            torch.from_numpy(np.stack(Ms).astype(np.int64)).to(device),
            torch.from_numpy(np.stack(cs).astype(np.int64)).to(device))


def kernel_cases(d: int, n: int, device) -> dict:
    """{kernel: (inputs, kernel call, plain call)} on n random elements."""
    from repro_torch.core.keys import span_mask
    from repro_torch.core.tables import MAXLEVEL
    from repro_torch.kernels import ops as kops, ref as kref

    L = MAXLEVEL[d]
    key, level = random_inputs(d, n, device)
    anchor, stype = kref.decode(d, key, level)        # valid elements, plain decode
    # successor's inputs: one element in 8 is element 0 of its level, one in
    # 8 the level's last element (whose successor wraps to element 0)
    span1 = span_mask(d, L, level)
    which = torch.arange(n, device=device) % 8
    s_key = torch.where(which == 1, 0, torch.where(which == 2, ((1 << (d * L)) - 1) ^ span1,
                                                   key & ~span1))
    s_anchor, s_stype = kref.decode(d, s_key, level)
    # half the elements anywhere in the root cube, outside the root simplex
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 10 * d)
    h = torch.bitwise_left_shift(torch.ones_like(level, dtype=torch.int64), L - level.long())
    cube = torch.randint(0, 1 << L, (n, d), generator=gen, device=device) // h[:, None] * h[:, None]
    odd = (torch.arange(n, device=device) & 1).bool()
    c_anchor = torch.where(odd[:, None], cube.to(torch.int32), anchor).contiguous()
    c_stype = torch.where(odd, torch.randint(0, 2 if d == 2 else 6, (n,), generator=gen,
                                             device=device, dtype=torch.int32), stype)
    nb_anchor, nb_stype, nb_dual, _in, nkey = kref.face_sweep(c_anchor, level, c_stype)
    tgt = torch.randint(0, 4, nkey.shape, generator=gen, device=device, dtype=torch.int32)
    mt, mk = route_markers(d, device)
    mt8, mk8, _empty = many_markers(d, 8192, device)
    # tree_transform crosses same-level neighbors, which lie just outside the
    # root (anchors below 0 or past 2^L): one random face's neighbor of each
    # element, across a random connection
    table, _M, _c = transform_connections(d, device)
    conn = torch.randint(0, table.shape[0], (n,), generator=gen, device=device, dtype=torch.int32)
    face = torch.randint(0, d + 1, (n,), generator=gen, device=device)
    row = torch.arange(n, device=device)
    x_anchor = nb_anchor[face, row].contiguous()
    x_stype, x_dual = nb_stype[face, row].contiguous(), nb_dual[face, row].contiguous()
    del nb_anchor, nb_stype, nb_dual
    face = face.to(torch.int32)
    o_tree = tgt[0].contiguous()
    return {
        "morton_key": ((anchor, stype), lambda: kops.morton_key(anchor, stype),
                       lambda: kref.morton_key(anchor, stype)),
        "decode": ((key, level), lambda: kops.decode(d, key, level),
                   lambda: kref.decode(d, key, level)),
        "parent": ((anchor, level, stype), lambda: kops.parent(anchor, level, stype),
                   lambda: kref.parent(anchor, level, stype)),
        "children": ((anchor, level, stype), lambda: kops.children(anchor, level, stype),
                     lambda: kref.children(anchor, level, stype)),
        "face_sweep": ((c_anchor, level, c_stype),
                       lambda: kops.face_sweep(c_anchor, level, c_stype),
                       lambda: kref.face_sweep(c_anchor, level, c_stype)),
        "eval_route": ((tgt, nkey, level, mt, mk),
                       lambda: kops.eval_route(d, tgt, nkey, level, mt, mk),
                       lambda: kref.eval_route(d, tgt, nkey, level, mt, mk)),
        "inside_root": ((c_anchor, level, c_stype),
                        lambda: kops.inside_root(c_anchor, level, c_stype),
                        lambda: kref.inside_root(c_anchor, level, c_stype)),
        "tree_transform": ((conn, x_anchor, level, x_stype, x_dual, table),
                           lambda: kops.tree_transform(conn, x_anchor, level, x_stype, x_dual,
                                                       table),
                           lambda: kref.tree_transform(conn, x_anchor, level, x_stype, x_dual,
                                                       table)),
        EVAL_ROUTE_MANY: ((tgt, nkey, level, mt8, mk8),
                          lambda: kops.eval_route(d, tgt, nkey, level, mt8, mk8),
                          lambda: kref.eval_route(d, tgt, nkey, level, mt8, mk8)),
        "owner_rank": ((o_tree, key, mt, mk), lambda: kops.owner_rank(o_tree, key, mt, mk),
                       lambda: kref.owner_rank(o_tree, key, mt, mk)),
        OWNER_RANK_MANY: ((o_tree, key, mt8, mk8),
                          lambda: kops.owner_rank(o_tree, key, mt8, mk8),
                          lambda: kref.owner_rank(o_tree, key, mt8, mk8)),
        "successor": ((s_anchor, level, s_stype),
                      lambda: kops.successor(s_anchor, level, s_stype),
                      lambda: kref.successor(s_anchor, level, s_stype)),
        "face_neighbor": ((c_anchor, level, c_stype, face),
                          lambda: kops.face_neighbor(c_anchor, level, c_stype, face),
                          lambda: kref.face_neighbor(c_anchor, level, c_stype, face)),
    }


def kernel_vs_plain(d: int, n: int, device, reps: int = 50, plain_reps: int = 5) -> list[dict]:
    """Phase 2 for one dimension: every kernel against its plain version on
    the same tensors, exact; returns one timing row per kernel."""
    from repro_torch.core.tables import MAXLEVEL

    L = MAXLEVEL[d]
    cases = kernel_cases(d, n, device)
    key, level = cases["decode"][0]
    _anchor, stype = cases["morton_key"][0]
    levels = torch.unique(level).numel()
    types = torch.unique(stype).numel()
    nt = 2 if d == 2 else 6
    if levels != L + 1 or types != nt:
        raise AssertionError(f"d={d}: inputs cover {levels} levels, {types} types")
    unset = [b for b in range(64) if bool(((key >> b) & 1).any()) != (b < d * L)]
    if unset:
        raise AssertionError(f"d={d}: key bits {unset} not as wanted (all of 0..{d * L - 1})")

    rows = []
    for name, (inputs, kernel, plain) in cases.items():
        got, want = kernel(), plain()
        sync()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name} d={d}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
        if err:
            raise AssertionError(f"{name} d={d}: kernel differs from plain, max |err| {err}")
        cover = ""
        if name in ("face_sweep", "inside_root"):
            inside = want[3] if name == "face_sweep" else want[0]
            share = float(inside.float().mean())
            if not 0 < share < 1:
                raise AssertionError(f"{name} d={d}: inside share {share}, want some of each")
            cover = f"; inside share {share:.3f}"
        elif name == "eval_route":
            owners = torch.unique(torch.cat([want[1].flatten(), want[2].flatten()])).tolist()
            if owners != [0, 2, 3]:
                raise AssertionError(f"eval_route d={d}: owners {owners}, want [0, 2, 3]")
            cover = f"; owners {owners} (rank 1 empty)"
        elif name == "owner_rank":
            owners = torch.unique(want[0]).tolist()
            if owners != [0, 2, 3]:
                raise AssertionError(f"owner_rank d={d}: owners {owners}, want [0, 2, 3]")
            cover = f"; owners {owners} (rank 1 empty)"
        elif name in (EVAL_ROUTE_MANY, OWNER_RANK_MANY):
            owners = torch.unique(torch.cat([w.flatten() for w in want if w.dtype == torch.int32]))
            empty = many_markers(d, 8192, "cpu")[2]
            if owners.numel() < 1000 or bool((owners == empty).any()):
                raise AssertionError(f"{name} d={d}: {owners.numel()} owners, rank {empty} "
                                     f"among them: {bool((owners == empty).any())}")
            cover = f"; {owners.numel()} distinct owners of 8192, empty rank {empty} not among them"
        elif name == "successor":
            # every eighth input (from the second on) is its level's last element
            last = torch.arange(n, device=device) % 8 == 2
            lv = torch.unique(inputs[1][last]).numel()
            if lv != L + 1 or bool(want[0][last].any()) or bool(want[1][last].any()):
                raise AssertionError(f"successor d={d}: last elements over {lv} levels, their "
                                     "successors not all element 0")
            cover = f"; the last element of each of {lv} levels wraps to element 0"
        elif name == "face_neighbor":
            anchor_in, _lvl, b, f = inputs
            pairs = torch.unique(b * (d + 1) + f).numel()
            if pairs != nt * (d + 1):
                raise AssertionError(f"face_neighbor d={d}: {pairs} (type, face) pairs")
            cover = f"; all {pairs} (type, face) pairs"
        elif name == "tree_transform":
            conn, anchor, lvl, _b, _du, table = inputs
            _t, Ms, cs = transform_connections(d, anchor.device)
            M, c = Ms[conn.long()], cs[conn.long()]
            h = torch.bitwise_left_shift(torch.ones_like(lvl, dtype=torch.int64), L - lvl.long())
            true = ((anchor.long()[:, None, :] * M).sum(-1) + c
                    + h[:, None] * M.sum(-1).clamp(max=0))
            wrapped = int(((true > 2**31 - 1) | (true < -2**31)).sum())
            reflected = int((M.sum((1, 2)) < 0).sum())
            del M, c, true
            if (wrapped > 0) != (d == 2) or not reflected:
                raise AssertionError(f"tree_transform d={d}: {wrapped} wrapped anchor words, "
                                     f"{reflected} reflected crossings")
            cover = (f"; {table.shape[0]} connections, {reflected} crossings with sigma = -1, "
                     f"{wrapped} anchor words wrapped past 2^31 - 1")
        ms = cuda_ms(kernel, reps)
        dev_ms = device_ms(kernel)
        # the plain compare-and-count over 8192 markers takes seconds a call
        many = name in (EVAL_ROUTE_MANY, OWNER_RANK_MANY)
        plain_ms = cuda_ms(plain, 1 if many else plain_reps)
        moved = nbytes(*inputs) + nbytes(*got)
        bound_ms = moved / MEM_BYTES_PER_S * 1e3
        rows.append({"name": name, "d": d, "n": n, "max_abs_err": float(err), "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bytes": moved})
        print(f"  {name:13s} d={d} n={n}: kernel == plain (tolerance 0); kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({moved} B, {moved // n} B/element), bound/kernel {bound_ms / ms:.1%} "
              f"(device {bound_ms / dev_ms:.1%}){cover}", flush=True)
    del cases
    torch.cuda.empty_cache()
    return rows


def record_launch_sizes(kops) -> tuple[dict, dict]:
    """Wrap every kernel wrapper of `kops` to record the element count of
    each call that launches; returns (sizes, originals) — restore with
    `setattr(kops, name, fn)` for each original."""
    sizes = {k: [] for k in REPLACES}
    originals = {k: getattr(kops, k) for k in REPLACES}

    def wrap(name, fn):
        def call(*args):
            t = args[1] if name == "decode" else args[3] if name == "eval_route" else args[0]
            if t.shape[0]:
                sizes[name].append(int(t.shape[0]))
            return fn(*args)
        return call

    for k, fn in originals.items():
        setattr(kops, k, wrap(k, fn))
    return sizes, originals


def time_at_launch_sizes(sizes: dict, d: int = 3, reps: int = 20) -> dict:
    """Phase 3b: each kernel timed at up to four of the sizes phase 3
    launched it with (smallest, two between, largest), on fresh random
    inputs of that size, against the byte bound of those inputs."""
    out = {}
    for name, ns in sizes.items():
        uniq = sorted(set(ns))
        pick = sorted({uniq[0], uniq[len(uniq) // 3], uniq[2 * len(uniq) // 3], uniq[-1]})
        out[name] = []
        for n in pick:
            inputs, kernel, _plain = kernel_cases(d, n, torch.device("cuda"))[name]
            got = kernel()
            got = got if isinstance(got, tuple) else (got,)
            ms = cuda_ms(kernel, reps)
            dev_ms = device_ms(kernel)
            moved = nbytes(*inputs) + nbytes(*got)
            bound_ms = moved / MEM_BYTES_PER_S * 1e3
            out[name].append({"n": n, "launches_at_n": ns.count(n), "ms": ms,
                              "device_ms": dev_ms, "bound_ms": bound_ms})
            print(f"  {name:11s} n={n:>9,} ({ns.count(n)} of {len(ns)} launches): "
                  f"{ms:.4f} ms (device {dev_ms:.4f} ms), bound {bound_ms:.4f} ms, "
                  f"bound/kernel {bound_ms / ms:.1%} (device {bound_ms / dev_ms:.1%})",
                  flush=True)
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ 3 and 4: the path
def fractal_count(d: int, trees: int, k: int, max_level: int) -> int:
    """Leaves of the fractal pattern, by the transfer matrix of child types
    from the port's tables: `trees` type-0 roots refined uniformly to level
    k, then elements of the refined types refined again until `max_level`."""
    from repro_torch.core.tables import get_tables

    t = get_tables(d)
    nt = t.num_types
    M = np.zeros((nt, nt), dtype=object)
    for b in range(nt):
        for i in range(t.num_children):
            M[b, t.child_type[b, i]] += 1
    refined = np.array([b in refine_types(d) for b in range(nt)])
    c = np.zeros(nt, dtype=object)
    c[0] = trees
    for _ in range(k):
        c = c @ M
    leaves = 0
    for _ in range(k, max_level):
        leaves += c[~refined].sum()
        c = np.where(refined, c, 0) @ M
    return int(leaves + c.sum())


def refine_types(d: int) -> tuple:
    """Types the fractal refines: the paper's Fig. 12 types 0 and 3 for
    tetrahedra; type 0 for triangles (d = 2 has types 0 and 1 only)."""
    return (0, 3) if d == 3 else (0,)


def fractal_cb(d: int, max_level: int):
    types = refine_types(d)

    def cb(tree, e):
        hit = torch.zeros_like(e.stype, dtype=torch.bool)
        for b in types:
            hit |= e.stype == b
        return (hit & (e.level < max_level)).to(torch.int32)
    return cb


def coarsen_upper_half_cb(num_trees: int, max_level: int):
    """Coarsen every level-`max_level` element of trees num_trees/2 and up."""
    def cb(tree, e):
        hit = (e.level == max_level) & (tree >= num_trees // 2)
        return torch.where(hit, -1, 0).to(torch.int32)
    return cb


def level_weights(fs, max_level: int) -> list:
    """Weights 1 + (level == max_level): finest elements cost twice."""
    return [1.0 + (f.level == max_level).double() for f in fs]


def check_order_and_cover(fs, d: int, num_trees: int) -> None:
    """Global stored (tree, key) order strictly ascending, and element
    volumes summing to exactly `num_trees` roots."""
    tree = torch.cat([f.tree for f in fs]).long()
    key = torch.cat([f.keys for f in fs])
    level = torch.cat([f.level for f in fs]).long()
    asc = (tree[1:] > tree[:-1]) | ((tree[1:] == tree[:-1]) & (key[1:] > key[:-1]))
    if not bool(asc.all()):
        raise AssertionError("stored (tree, key) order is not strictly ascending")
    top = int(level.max())
    unit = torch.bitwise_left_shift(torch.ones_like(level), d * (top - level))
    if int(unit.sum()) != num_trees << (d * top):
        raise AssertionError("element volumes do not cover the trees")


def migrated(before: list[int], after: list[int]) -> int:
    """Elements whose rank changed, from the per-rank counts before and
    after a repartition (ranks own contiguous global intervals)."""
    ob, oa = np.cumsum([0] + before), np.cumsum([0] + after)
    stay = sum(max(0, min(ob[r + 1], oa[r + 1]) - max(ob[r], oa[r])) for r in range(len(before)))
    return int(ob[-1] - stay)


def tree_faces_cb(deep: int):
    """Refine, below level `deep`, every element of tree 0 with a face on
    the tree's root boundary (a face neighbor outside the root, by the
    port's `face_sweep`): a layer of fine elements along all of tree 0's
    faces, each glued to another tree or on the domain boundary, against
    the coarser leaves across them."""
    from repro_torch.core.batch import get_batch_ops

    def cb(tree, e):
        on_face = ~get_batch_ops(e.anchor.shape[1]).face_sweep(e).inside.all(0)
        return ((tree == 0) & on_face & (e.level < deep)).to(torch.int32)
    return cb


def level_jumps(fs) -> dict:
    """Element faces whose neighbor region holds a leaf more than one level
    finer (the 2:1 condition Balance restores), split by face kind:
    {"interior": count, "inter_tree": count}.  Every rank's fixed-up sweep
    layer is searched in the global leaf table.  A check, run after the
    path's launch counts are read."""
    from repro_torch.core import batch as B, forest as F
    from repro_torch.core.keys import span_mask

    b = fs[0].bops
    tab = b.upload_table(torch.cat([f.tree for f in fs]), torch.cat([f.keys for f in fs]),
                         torch.cat([f.level for f in fs]))
    out = {"interior": 0, "inter_tree": 0}
    for f in fs:
        if not f.num_local:
            continue
        lay = F.face_sweep_layer(f, f.tree, f.simplices())
        kend = lay.nkey | span_mask(f.d, f.ops.L, lay.level)[None, :]
        lo = B.lex_search(tab.tree, tab.key, lay.tgt, lay.nkey)
        hi = B.lex_search(tab.tree, tab.key, lay.tgt, kend, right=True)
        finer = lay.valid & (tab.levmax.query(lo, hi) > (lay.level + 1)[None, :])
        out["interior"] += int((finer & (lay.kind == F.FACE_INTERIOR)).sum())
        out["inter_tree"] += int((finer & (lay.kind == F.FACE_INTER_TREE)).sum())
        del lay, kend, lo, hi, finer
    return out


def tree0_face_tiles(fs) -> tuple[int, list]:
    """(element faces of tree 0's leaves on its root boundary, the levels
    of those leaves): after the tree-faces Adapt to level `deep`, the d+1
    root faces are tiled by (d+1) * 2^((d-1) deep) faces of level-`deep`
    leaves.  A check, run after the path's launch counts are read."""
    from repro_torch.core.types import Simplex

    tiles, levels = 0, set()
    for f in fs:
        sel = torch.nonzero(f.tree == 0).squeeze(1)
        if not sel.numel():
            continue
        s = Simplex(f.anchor[sel], f.level[sel], f.stype[sel])
        out = ~f.bops.face_sweep(s).inside
        tiles += int(out.sum())
        levels |= set(torch.unique(s.level[out.any(0)]).tolist())
    return tiles, sorted(levels)


def run_path(d: int, num_trees: int, level: int, max_level: int, P: int, device,
             report: bool = False, cmesh=None, tree_faces: int | None = None,
             keep_unbalanced: bool = False) -> tuple[list, list, object, dict]:
    """New -> fractal Adapt -> coarsening Adapt (trees num_trees/2 and up)
    -> Partition -> weighted repartition -> [tree 0's faces refined to
    level `tree_faces`] -> Balance -> Ghost -> validate on SimComm(P), over
    `cmesh` when given.  With
    `keep_unbalanced`, the forests Balance started from stay in
    facts["unbalanced"].  Returns (forests, ghosts, comm, facts)."""
    from repro_torch.core import forest as F

    comm = F.SimComm(P)
    facts = {"per_rank": {}, "wall_s": {}}
    t = time.perf_counter()

    def step(name, fs, what="elements", counts=None):
        nonlocal t
        if device.type == "cuda":
            sync()
        facts["wall_s"][name] = time.perf_counter() - t
        facts["per_rank"][name] = counts if counts is not None else [f.num_local for f in fs]
        if report:
            print(f"  {name:22s} {facts['wall_s'][name]:8.3f} s  "
                  f"{sum(facts['per_rank'][name]):>12,} {what}  "
                  f"per rank {facts['per_rank'][name]}", flush=True)
        t = time.perf_counter()
        return fs

    fs = step("new_uniform", F.new_uniform(d, num_trees, level, comm, cmesh=cmesh,
                                           device=device))
    fs = step("adapt fractal", [F.adapt(f, fractal_cb(d, max_level), recursive=True)
                                for f in fs])
    fs = step("adapt coarsen", [F.adapt(f, coarsen_upper_half_cb(num_trees, max_level))
                                for f in fs])
    facts["imbalance_before"] = F.load_imbalance(fs, comm)
    t = time.perf_counter()
    fs = step("partition", F.partition(fs, comm))
    facts["imbalance_after"] = F.load_imbalance(fs, comm)
    check_order_and_cover(fs, d, num_trees)
    n = facts["per_rank"]["partition"]
    if max(n) - min(n) > 1:
        raise AssertionError(f"per-rank counts after partition differ by more than 1: {n}")
    w = level_weights(fs, max_level)
    facts["weighted_imbalance_before"] = F.load_imbalance(fs, comm, weights=w)
    t = time.perf_counter()
    fs = step("repartition weighted", F.repartition(fs, comm, weights=w))
    facts["weighted_imbalance_after"] = F.load_imbalance(
        fs, comm, weights=level_weights(fs, max_level))
    check_order_and_cover(fs, d, num_trees)
    if tree_faces is not None:
        t = time.perf_counter()
        fs = step("adapt tree faces", [F.adapt(f, tree_faces_cb(tree_faces), recursive=True)
                                       for f in fs])
        check_order_and_cover(fs, d, num_trees)
    if keep_unbalanced:
        facts["unbalanced"] = fs
    t = time.perf_counter()
    fs = step("balance", F.balance(fs, comm))
    gh = F.ghost(fs, comm)
    step("ghost", fs, "ghosts", [int(g["level"].shape[0]) for g in gh])
    ok = F.validate(fs, gh)
    step("validate", fs)
    if not ok:
        raise AssertionError("validate(forests, ghosts) is False after Balance and Ghost")
    check_order_and_cover(fs, d, num_trees)
    facts["balance_evals"] = comm.counters["balance"]["allgather_calls"] - 1
    facts["bytes"] = {k: comm.bytes_for(k) for k in comm.counters}
    return fs, gh, comm, facts


def main_path() -> dict:
    """Phase 3: the full-size run on the card."""
    d, trees, level, max_level, P = 3, 8, 6, 8, 4
    half = trees // 2
    per_tree_fine = fractal_count(d, 1, level, max_level)
    per_tree_coarse = fractal_count(d, 1, level, max_level - 1)
    want_rank = [2 * per_tree_fine] * 2 + [2 * per_tree_coarse] * 2
    want = {"new_uniform": trees << (d * level),
            "adapt fractal": fractal_count(d, trees, level, max_level),
            "adapt coarsen": half * per_tree_fine + half * per_tree_coarse}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fs, gh, comm, facts = run_path(d, trees, level, max_level, P, torch.device("cuda"),
                                   report=True)
    wall = time.perf_counter() - t0
    for k, v in want.items():
        if sum(facts["per_rank"][k]) != v:
            raise AssertionError(f"{k}: {sum(facts['per_rank'][k])} elements, want {v}")
    if facts["per_rank"]["adapt coarsen"] != want_rank:
        raise AssertionError(f"per-rank counts after coarsening {facts['per_rank']['adapt coarsen']}"
                             f", want {want_rank}")
    moved = migrated(facts["per_rank"]["adapt coarsen"], facts["per_rank"]["partition"])
    part = comm.counters["partition"]
    if part["alltoallv_bytes"] != moved * WIRE_TRIPLE_BYTES:
        raise AssertionError(f"partition shipped {part['alltoallv_bytes']} B for {moved} "
                             "migrated elements")
    if comm.bytes_for("partition") < 9_000_000 * WIRE_TRIPLE_BYTES:
        raise AssertionError(f"partition moved only {comm.bytes_for('partition')} B")
    if facts["weighted_imbalance_after"] > 1.001:
        raise AssertionError(f"weighted imbalance {facts['weighted_imbalance_after']} "
                             "after repartition")
    before, after = (sum(facts["per_rank"][k]) for k in ("repartition weighted", "balance"))
    if after <= before or facts["balance_evals"] < 2:
        raise AssertionError(f"balance refined nothing: {before} -> {after} elements")
    if not all(facts["per_rank"]["ghost"]) or not comm.bytes_for("ghost"):
        raise AssertionError(f"an empty ghost layer: {facts['per_rank']['ghost']}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  counts {want['new_uniform']:,} -> {want['adapt fractal']:,} -> "
          f"{want['adapt coarsen']:,} as the transfer matrix of the port's tables says; "
          f"per rank before partition {want_rank}", flush=True)
    print(f"  partition migrated {moved:,} tets ({part['alltoallv_bytes']:,} B of wire "
          f"triples); load_imbalance {facts['imbalance_before']} -> "
          f"{facts['imbalance_after']}; weighted (1 + (level == {max_level})) "
          f"{facts['weighted_imbalance_before']} -> {facts['weighted_imbalance_after']}",
          flush=True)
    print(f"  balance: {before:,} -> {after:,} tets, per rank {facts['per_rank']['balance']}, "
          f"{facts['balance_evals']} evaluation rounds ({facts['balance_evals'] - 1} refining); "
          f"bytes_for balance {comm.bytes_for('balance'):,} B, ghost "
          f"{comm.bytes_for('ghost'):,} B; ghosts per rank {facts['per_rank']['ghost']}; "
          f"validate(forests, ghosts) True", flush=True)
    print(f"  bytes_for per phase {facts['bytes']}; counters {comm.counters}", flush=True)
    print(f"  wall {wall:.3f} s; peak device memory {peak:,} B ({peak / 2**30:.3f} GiB)",
          flush=True)
    facts["peak_bytes"] = peak
    del gh
    torch.cuda.empty_cache()
    return facts, fs, comm


def element_queries(fs: list, comm) -> dict:
    """Phase 3d: the paper's element queries on every leaf of the balanced
    forests `fs`, through `BatchedOps` (kernels on the card): each leaf's
    owner rank against the partition markers is its rank; the successor of
    each leaf has the next leaf's key in global stored order (the leaves of
    a tree tile its curve), and the last leaf of each tree wraps to key 0;
    predecessor(successor(a)) == a; the single-face neighbor of face f is
    plane f of the face sweep.  Returns each query's wall time summed over
    the ranks (host clock, each call ending in a synchronize on the card)."""
    from repro_torch.core import forest as F

    b, d, dev = fs[0].bops, fs[0].d, fs[0].device
    walls = dict.fromkeys(("owner_rank", "successor", "predecessor", "face_sweep",
                           "face_neighbor"), 0.0)

    def timed(name, fn):
        if dev.type == "cuda":
            sync()
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            sync()
        walls[name] += time.perf_counter() - t
        return out

    mt, mk = F.partition_markers(fs, comm)
    mt_d = torch.from_numpy(mt).to(dev)
    mk_d = torch.from_numpy(mk.astype(np.int64)).to(dev)
    next_keys = []
    for p, f in enumerate(fs):
        s = f.simplices()
        own = timed("owner_rank", lambda: b.owner_rank(f.tree, f.keys, mt_d, mk_d))
        if not bool((own == p).all()):
            raise AssertionError(f"3d: owner_rank sends {int((own != p).sum())} leaves of "
                                 f"rank {p} elsewhere")
        nxt = timed("successor", lambda: b.successor(s))
        next_keys.append(b.morton_key(nxt))
        back = timed("predecessor", lambda: b.predecessor(nxt))
        if not (torch.equal(back.anchor, s.anchor) and torch.equal(back.stype, s.stype)):
            raise AssertionError(f"3d rank {p}: predecessor(successor(a)) differs from a")
        sw = timed("face_sweep", lambda: b.face_sweep(s))
        for face in range(d + 1):
            nb, dual = timed("face_neighbor", lambda: b.face_neighbor(s, face))
            if not (torch.equal(nb.anchor, sw.neighbor.anchor[face])
                    and torch.equal(nb.stype, sw.neighbor.stype[face])
                    and torch.equal(dual, sw.dual[face])):
                raise AssertionError(f"3d rank {p}: face_neighbor({face}) differs from plane "
                                     f"{face} of face_sweep")
        del own, nxt, back, sw
    tree = torch.cat([f.tree for f in fs])
    key = torch.cat([f.keys for f in fs])
    got = torch.cat(next_keys)
    last = torch.ones_like(tree, dtype=torch.bool)
    last[:-1] = tree[1:] != tree[:-1]
    want = torch.zeros_like(key)
    want[:-1] = key[1:]
    want = torch.where(last, 0, want)
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"3d: {bad} successors without the next leaf's key")
    print(f"  {tree.numel():,} leaves on {len(fs)} ranks: owner_rank == rank for every leaf; "
          f"morton_key(successor(a)) == key of the next leaf, and 0 for the last leaf of "
          f"each of {int(last.sum())} trees; predecessor(successor(a)) == a; "
          f"face_neighbor(s, f) == plane f of face_sweep(s), f = 0..{d}", flush=True)
    print("  wall (s, summed over ranks): " + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()),
          flush=True)
    return walls


def face_neighbor_vs_plain(f, kops, kref) -> None:
    """Phase 3d's independent check of `face_neighbor`: one rank's leaves,
    every face, against the plain version (`face_sweep` runs the kernel's
    own per-face step, so plane f of the sweep cannot catch a fault in
    it).  Run outside the counted phase-3d run."""
    fc = torch.empty_like(f.level)
    for face in range(f.d + 1):
        fc.fill_(face)
        got = kops.face_neighbor(f.anchor, f.level, f.stype, fc)
        want = kref.face_neighbor(f.anchor, f.level, f.stype, fc)
        if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
            raise AssertionError(f"3d rank {f.rank}: face_neighbor({face}) differs from "
                                 "its plain version")
    print(f"  face_neighbor of rank {f.rank}'s {f.num_local:,} leaves, f = 0..{f.d}, equals "
          "its plain version", flush=True)


def new_uniform_methods(reps: int = 3) -> dict:
    """Phase 3b: New's two methods at d = 3, 8 trees, level 7 (16,777,216
    tets) on SimComm(3), whose rank ranges split trees: "decode" (one
    Algorithm-4.8 decode of each rank's range of a tree) and "successor"
    (the coarsest aligned subtrees decoded and expanded by the children
    kernel, head and tail decoded) give the same forests; each method's
    least wall of `reps`, interleaved, on the host clock ending in a
    synchronize."""
    from repro_torch.core import forest as F

    comm, dev = F.SimComm(3), torch.device("cuda")
    walls = {"decode": float("inf"), "successor": float("inf")}
    out = {}
    for _ in range(reps):
        for method in walls:
            out.pop(method, None)
            sync()
            t = time.perf_counter()
            out[method] = F.new_uniform(3, 8, 7, comm, method=method, device=dev)
            sync()
            walls[method] = min(walls[method], time.perf_counter() - t)
    for a, b in zip(out["decode"], out["successor"], strict=True):
        for k in ("anchor", "level", "stype", "tree", "keys"):
            if not torch.equal(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"new_uniform: rank {a.rank}'s {k} differs by method")
    n = sum(f.num_local for f in out["decode"])
    print(f"  new_uniform of {n:,} tets on 3 ranks, least of {reps}: decode "
          f"{walls['decode']:.4f} s, successor {walls['successor']:.4f} s "
          f"(successor / decode {walls['successor'] / walls['decode']:.3f}); same forests",
          flush=True)
    del out
    torch.cuda.empty_cache()
    return walls


def cmesh_path() -> tuple[dict, list, list]:
    """Phase 3c: the coarse-mesh path at full size on the card.  Returns
    (facts, the forests Balance started from, the balanced forests) for
    `check_level_jumps`, which runs after the launch counts are read."""
    from repro_torch.core.cmesh import cmesh_brick

    cm = cmesh_brick(3, (2, 2, 2), periodic=(True, True, False))
    glued = int((cm.face_tree >= 0).sum())
    if cm.num_trees != 48 or glued != 176 or cm.face_tree.size != 192:
        raise AssertionError(f"brick: {cm.num_trees} trees, {glued} of {cm.face_tree.size} "
                             "tree faces glued; want 48 and 176 of 192")
    print(f"  mesh: cmesh_brick(3, (2, 2, 2), periodic=(True, True, False)): "
          f"{cm.num_trees} trees, {glued} of {cm.face_tree.size} tree faces glued", flush=True)
    d, trees, level, max_level, deep, P = 3, 48, 5, 7, TREE_FACES_LEVEL, 4
    half = trees // 2
    fine, coarse = fractal_count(d, 1, level, max_level), fractal_count(d, 1, level, max_level - 1)
    want = {"new_uniform": trees << (d * level),
            "adapt fractal": fractal_count(d, trees, level, max_level),
            "adapt coarsen": half * fine + half * coarse}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fs, gh, comm, facts = run_path(d, trees, level, max_level, P, torch.device("cuda"),
                                   report=True, cmesh=cm, tree_faces=deep,
                                   keep_unbalanced=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for k, v in want.items():
        if sum(facts["per_rank"][k]) != v:
            raise AssertionError(f"3c {k}: {sum(facts['per_rank'][k])} elements, want {v}")
    moved = migrated(facts["per_rank"]["adapt coarsen"], facts["per_rank"]["partition"])
    part = comm.counters["partition"]
    if part["alltoallv_bytes"] != moved * WIRE_TRIPLE_BYTES or moved <= 6_000_000:
        raise AssertionError(f"3c partition moved {moved} tets in {part['alltoallv_bytes']} B")
    if facts["weighted_imbalance_after"] > 1.001:
        raise AssertionError(f"3c weighted imbalance {facts['weighted_imbalance_after']}")
    layered, before, after = (sum(facts["per_rank"][k]) for k in
                              ("adapt coarsen", "adapt tree faces", "balance"))
    if before <= layered or after <= before:
        raise AssertionError(f"3c refined nothing: tree faces {layered} -> {before}, "
                             f"balance {before} -> {after}")
    if not all(facts["per_rank"]["ghost"]):
        raise AssertionError(f"3c an empty ghost layer: {facts['per_rank']['ghost']}")
    print(f"  counts {want['new_uniform']:,} -> {want['adapt fractal']:,} -> "
          f"{want['adapt coarsen']:,} as the transfer matrix says; tree 0's faces to level "
          f"{deep}: {before:,}", flush=True)
    print(f"  partition migrated {moved:,} tets ({part['alltoallv_bytes']:,} B); weighted "
          f"imbalance {facts['weighted_imbalance_before']} -> "
          f"{facts['weighted_imbalance_after']}", flush=True)
    print(f"  balance: {before:,} -> {after:,} tets, per rank {facts['per_rank']['balance']}, "
          f"{facts['balance_evals']} evaluation rounds; ghosts per rank "
          f"{facts['per_rank']['ghost']}; validate(forests, ghosts) True", flush=True)
    print(f"  bytes_for per phase {facts['bytes']}", flush=True)
    print(f"  wall {wall:.3f} s; peak device memory {peak:,} B ({peak / 2**30:.3f} GiB)",
          flush=True)
    facts["peak_bytes"] = peak
    del gh
    return facts, facts.pop("unbalanced"), fs


def check_level_jumps(unbalanced: list, balanced: list, deep: int) -> None:
    """Phase 3c's check that Balance refined across tree faces: element
    faces with a leaf more than one level finer in their neighbor region,
    interior and inter-tree, before Balance (at least
    `MIN_INTER_TREE_JUMPS` inter-tree ones, along tree 0's faces) and after
    it (none of either); and that tree 0's root faces were tiled at level
    `deep` before it."""
    d = unbalanced[0].d
    tiles, levels = tree0_face_tiles(unbalanced)
    print(f"  tree 0's {d + 1} root faces: {tiles:,} faces of leaves of levels {levels}",
          flush=True)
    if tiles != (d + 1) << ((d - 1) * deep) or levels != [deep]:
        raise AssertionError(f"3c: want tree 0's root faces tiled by "
                             f"{(d + 1) << ((d - 1) * deep)} faces of level-{deep} leaves")
    jb, ja = level_jumps(unbalanced), level_jumps(balanced)
    print(f"  element faces whose neighbor region holds a leaf more than one level "
          f"finer: before Balance {jb}, after it {ja}", flush=True)
    if jb["inter_tree"] < MIN_INTER_TREE_JUMPS or any(ja.values()):
        raise AssertionError(f"3c: want at least {MIN_INTER_TREE_JUMPS} inter-tree level "
                             "jumps before Balance and none of either kind after")
    torch.cuda.empty_cache()


def same_on_card_and_cpu(label: str, d: int, trees: int, P: int, cmesh=None,
                         tree_faces: int | None = None) -> None:
    """The pipeline at small size (level 1 -> 3, tree 0's faces then to
    level `tree_faces` when given) on the card and on the CPU: every forest
    and ghost field, and every per-phase byte count, identical."""
    (fg, gg, cg, ng), (fc, gc, cc, nc) = [
        run_path(d, trees, 1, 3, P, torch.device(dev), cmesh=cmesh,
                 tree_faces=tree_faces)
        for dev in ("cuda", "cpu")]
    if ng["per_rank"] != nc["per_rank"]:
        raise AssertionError(f"{label}: counts differ, card {ng['per_rank']} vs CPU "
                             f"{nc['per_rank']}")
    for a, b in zip(fg, fc, strict=True):
        for name in ("anchor", "level", "stype", "tree", "keys"):
            x, y = getattr(a, name), getattr(b, name)
            if x.device.type != "cuda" or x.dtype != y.dtype or not torch.equal(x.cpu(), y):
                raise AssertionError(f"{label} rank {a.rank}: {name} differs card vs CPU")
    for r, (a, b) in enumerate(zip(gg, gc, strict=True)):
        for name in ("anchor", "level", "stype", "tree", "owner"):
            x, y = a[name], b[name]
            if x.device.type != "cuda" or x.dtype != y.dtype or not torch.equal(x.cpu(), y):
                raise AssertionError(f"{label} rank {r}: ghost {name} differs card vs CPU")
    if cg.counters != cc.counters or ng["bytes"] != nc["bytes"]:
        raise AssertionError(f"{label}: byte counters differ: {cg.counters} vs {cc.counters}")
    for phase in ("partition", "balance", "ghost"):
        if not ng["bytes"].get(phase):
            raise AssertionError(f"{label}: the small {phase} moved nothing")
    print(f"  {label}: {sum(ng['per_rank']['adapt fractal'])} -> "
          f"{sum(ng['per_rank']['adapt coarsen'])} -> {sum(ng['per_rank']['balance'])} "
          f"elements, ghosts {ng['per_rank']['ghost']} on SimComm({P}); card == CPU "
          f"forest and ghost field for field; bytes_for {ng['bytes']} equal", flush=True)


def card_vs_cpu() -> None:
    """Phase 4: the pipeline at small size on both devices, without a
    coarse mesh (d = 3 and 2, 8 trees) and over one (the 48-tree brick of
    phase 3c, a periodic 2 x 2 brick of 8 triangles, the rotated pair)."""
    from repro_torch.core import cmesh as C

    for d in (3, 2):
        same_on_card_and_cpu(f"d={d}", d, 8, 4)
    brick3 = C.cmesh_brick(3, (2, 2, 2), periodic=(True, True, False))
    brick2 = C.cmesh_brick(2, (2, 2), periodic=(True, True))
    same_on_card_and_cpu("d=3 brick of 8 cells (48 trees)", 3, brick3.num_trees, 4,
                         cmesh=brick3, tree_faces=4)
    same_on_card_and_cpu("d=2 periodic brick (8 trees)", 2, brick2.num_trees, 4,
                         cmesh=brick2, tree_faces=5)
    same_on_card_and_cpu("d=2 rotated pair", 2, 2, 4, cmesh=C.cmesh_rotated_pair(),
                         tree_faces=5)


def counted(kops, kref, run) -> tuple[object, dict, dict]:
    """(run()'s result, its kernel launches, its plain-version calls), every
    count set to 0 just before the run and read just after it."""
    kops.reset_launch_counts()
    kref.reset_call_counts()
    out = run()
    return out, dict(kops.launch_counts), dict(kref.call_counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops as kops, ref as kref

    print("== 1. card and build", flush=True)
    smi = nvidia_smi_line()
    print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t = time.perf_counter()
    lib = build.build()
    print(f"  built {lib.name} from an empty build directory in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  {log.stem}: {line.strip()}")

    print(f"== 2. kernel vs plain (bound: bytes / {MEM_BYTES_PER_S / 1e12} TB/s; "
          f"card {smi})", flush=True)
    rows = {d: kernel_vs_plain(d, N_KERNEL, torch.device("cuda")) for d in (3, 2)}

    print("== 3. main path at full size", flush=True)
    sizes, originals = record_launch_sizes(kops)
    (_facts, fs, comm), launches, plain_calls = counted(kops, kref, main_path)
    print("== 3d. element queries on phase 3's forests", flush=True)
    _walls, launches_d, plain_calls_d = counted(kops, kref, lambda: element_queries(fs, comm))
    face_neighbor_vs_plain(max(fs, key=lambda f: f.num_local), kops, kref)
    del fs
    torch.cuda.empty_cache()
    print("== 3c. the coarse-mesh path at full size", flush=True)
    (_facts, unbalanced, balanced), launches_c, plain_calls_c = counted(kops, kref, cmesh_path)
    for name, fn in originals.items():
        setattr(kops, name, fn)
    check_level_jumps(unbalanced, balanced, TREE_FACES_LEVEL)
    del unbalanced, balanced

    print(f"== 3b. kernels at the sizes phases 3, 3c and 3d launched (card {smi})", flush=True)
    time_at_launch_sizes(sizes)
    new_uniform_methods()

    print("== 4. card vs CPU", flush=True)
    card_vs_cpu()

    print("== 5. launch counts", flush=True)
    print(f"  kernel launches in phase 3: {launches}; plain calls: {plain_calls}", flush=True)
    print(f"  kernel launches in phase 3c: {launches_c}; plain calls: {plain_calls_c}",
          flush=True)
    print(f"  kernel launches in phase 3d: {launches_d}; plain calls: {plain_calls_d}",
          flush=True)
    queries = ("owner_rank", "successor", "face_neighbor")
    if not all(launches[k] > 0 for k in REPLACES if k not in ("tree_transform", *queries[1:])):
        raise AssertionError(f"a kernel was not launched on the phase-3 path: {launches}")
    if not all(launches_c[k] > 0 for k in REPLACES if k not in queries[1:]):
        raise AssertionError(f"a kernel was not launched on the phase-3c path: {launches_c}")
    if not all(launches_d[k] > 0 for k in queries):
        raise AssertionError(f"a query kernel was not launched in phase 3d: {launches_d}")
    if any(plain_calls.values()) or any(plain_calls_c.values()) or any(plain_calls_d.values()):
        raise AssertionError(f"plain versions ran on a main path: {plain_calls}, "
                             f"{plain_calls_c}, {plain_calls_d}")
    kernels = []
    for name in REPLACES:
        r = next(x for x in rows[3] if x["name"] == name)
        r2 = next(x for x in rows[2] if x["name"] == name)
        entry = {
            "name": f"{name}_kernel", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name] or launches_c[name] or launches_d[name],
            "launches_phase3": launches[name], "launches_phase3c": launches_c[name],
            "launches_phase3d": launches_d[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "d": 3, "n": r["n"],
            "ms_d2": r2["ms"], "device_ms_d2": r2["device_ms"], "bound_ms_d2": r2["bound_ms"]}
        many = {"eval_route": EVAL_ROUTE_MANY, "owner_rank": OWNER_RANK_MANY}.get(name)
        if many:
            for dd in (3, 2):
                m = next(x for x in rows[dd] if x["name"] == many)
                sfx = "_p8192" if dd == 3 else "_p8192_d2"
                entry.update({f"ms{sfx}": m["ms"], f"device_ms{sfx}": m["device_ms"],
                              f"plain_ms{sfx}": m["plain_ms"], f"bound_ms{sfx}": m["bound_ms"],
                              f"max_abs_err{sfx}": m["max_abs_err"]})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
