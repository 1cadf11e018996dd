"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each against its plain PyTorch version, drives the paper's New -> Adapt ->
Partition -> Balance -> Ghost -> validate path at full size on the card,
and checks the card against the CPU.  Phases, in order; any failure exits
nonzero:

  1. card and build: the card's name and power limit, torch and CUDA
     versions, the kernels' build from an empty build directory;
  2. kernel vs plain: each of the seven kernels against its plain version
     on N = 2^22 random elements (every level 0..L, every type, every one
     of the d*L key bits set somewhere; for face_sweep and inside_root half
     the elements anywhere in the root cube, outside the root simplex; for
     eval_route P = 4 markers with an empty rank), d = 2 and 3, exact
     equality; kernel and plain times by CUDA events around a loop of
     calls, the kernel's device time per launch by CUDA events around
     launches queued behind a spinning kernel (no host time), and the
     byte bound (bytes moved / 3.35 TB/s, the H100 SXM's device memory
     rate);
  3. main path at full size: d = 3, 8 trees on SimComm(4) (all four ranks
     on the card): New at level 6 (2,097,152 tets), recursive Adapt with
     the paper's Fig. 12 fractal callback to level 8 (26,575,872 tets),
     Adapt coarsening every level-8 family of trees 4-7 (16,784,384 tets,
     ranks 0-1 holding 3.8 times what ranks 2-3 hold), Partition (per-rank
     counts within 1, about 9.09 M tets migrating), and a repartition with
     weights 1 + (level == 8); stored order and volume coverage are checked
     after each partition; then Balance, Ghost and validate(forests,
     ghosts), which must hold;
  3b. the kernels timed (both ways, as in phase 2) at the
     sizes phase 3 launched them with (the smallest, two between and the
     largest, per kernel);
  4. card vs CPU: the same pipeline at small size (d = 3 and d = 2, 8
     trees, level 1 -> 3) on both devices, every forest and ghost field and
     every per-phase byte count identical;
  5. launch counts: every kernel launched in phase 3, no plain version
     called there.

The second-to-last lines are a JSON `kernels` line and the `nvidia-smi`
name/power-limit line; the last line is the JSON result.  Without a card,
or without the repository beside it, the script exits nonzero and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

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
}
SOURCE = "src/repro_torch/kernels/csrc/sfc.cu"
WIRE_TRIPLE_BYTES = 13


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


def kernel_cases(d: int, n: int, device) -> dict:
    """{kernel: (inputs, kernel call, plain call)} on n random elements."""
    from repro_torch.core.tables import MAXLEVEL
    from repro_torch.kernels import ops as kops, ref as kref

    L = MAXLEVEL[d]
    key, level = random_inputs(d, n, device)
    anchor, stype = kref.decode(d, key, level)        # valid elements, plain decode
    # half the elements anywhere in the root cube, outside the root simplex
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 10 * d)
    h = torch.bitwise_left_shift(torch.ones_like(level, dtype=torch.int64), L - level.long())
    cube = torch.randint(0, 1 << L, (n, d), generator=gen, device=device) // h[:, None] * h[:, None]
    odd = (torch.arange(n, device=device) & 1).bool()
    c_anchor = torch.where(odd[:, None], cube.to(torch.int32), anchor).contiguous()
    c_stype = torch.where(odd, torch.randint(0, 2 if d == 2 else 6, (n,), generator=gen,
                                             device=device, dtype=torch.int32), stype)
    _a, _b, _du, _in, nkey = kref.face_sweep(c_anchor, level, c_stype)
    tgt = torch.randint(0, 4, nkey.shape, generator=gen, device=device, dtype=torch.int32)
    mt, mk = route_markers(d, device)
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
        ms = cuda_ms(kernel, reps)
        dev_ms = device_ms(kernel)
        plain_ms = cuda_ms(plain, plain_reps)
        moved = nbytes(*inputs) + nbytes(*got)
        bound_ms = moved / MEM_BYTES_PER_S * 1e3
        rows.append({"name": name, "d": d, "n": n, "max_abs_err": float(err), "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bytes": moved})
        print(f"  {name:11s} d={d} n={n}: kernel == plain (tolerance 0); kernel {ms:.4f} ms "
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


def run_path(d: int, num_trees: int, level: int, max_level: int, P: int, device,
             report: bool = False) -> tuple[list, list, object, dict]:
    """New -> fractal Adapt -> coarsening Adapt (trees num_trees/2 and up)
    -> Partition -> weighted repartition -> Balance -> Ghost -> validate on
    SimComm(P).  Returns (forests, ghosts, comm, facts)."""
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

    fs = step("new_uniform", F.new_uniform(d, num_trees, level, comm, device=device))
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
    del fs, gh
    torch.cuda.empty_cache()
    return facts


def card_vs_cpu() -> None:
    """Phase 4: the same pipeline at small size on both devices."""
    for d in (3, 2):
        trees, level, max_level, P = 8, 1, 3, 4
        (fg, gg, cg, ng), (fc, gc, cc, nc) = [
            run_path(d, trees, level, max_level, P, torch.device(dev)) for dev in ("cuda", "cpu")]
        if ng["per_rank"] != nc["per_rank"]:
            raise AssertionError(f"d={d}: counts differ, card {ng['per_rank']} vs CPU "
                                 f"{nc['per_rank']}")
        for a, b in zip(fg, fc, strict=True):
            for name in ("anchor", "level", "stype", "tree", "keys"):
                x, y = getattr(a, name), getattr(b, name)
                if x.device.type != "cuda" or x.dtype != y.dtype or not torch.equal(x.cpu(), y):
                    raise AssertionError(f"d={d} rank {a.rank}: {name} differs card vs CPU")
        for r, (a, b) in enumerate(zip(gg, gc, strict=True)):
            for name in ("anchor", "level", "stype", "tree", "owner"):
                x, y = a[name], b[name]
                if x.device.type != "cuda" or x.dtype != y.dtype or not torch.equal(x.cpu(), y):
                    raise AssertionError(f"d={d} rank {r}: ghost {name} differs card vs CPU")
        if cg.counters != cc.counters or ng["bytes"] != nc["bytes"]:
            raise AssertionError(f"d={d}: byte counters differ: {cg.counters} vs {cc.counters}")
        for phase in ("partition", "balance", "ghost"):
            if not ng["bytes"].get(phase):
                raise AssertionError(f"d={d}: the small {phase} moved nothing")
        print(f"  d={d}: {sum(ng['per_rank']['adapt fractal'])} -> "
              f"{sum(ng['per_rank']['adapt coarsen'])} -> {sum(ng['per_rank']['balance'])} "
              f"elements, ghosts {ng['per_rank']['ghost']} on SimComm({P}); card == CPU "
              f"forest and ghost field for field; bytes_for {ng['bytes']} equal", flush=True)


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
    kops.reset_launch_counts()
    kref.reset_call_counts()
    main_path()
    launches = dict(kops.launch_counts)
    plain_calls = dict(kref.call_counts)
    for name, fn in originals.items():
        setattr(kops, name, fn)

    print(f"== 3b. kernels at the sizes phase 3 launched (card {smi})", flush=True)
    time_at_launch_sizes(sizes)

    print("== 4. card vs CPU", flush=True)
    card_vs_cpu()

    print("== 5. launch counts", flush=True)
    print(f"  kernel launches in phase 3: {launches}; plain calls: {plain_calls}", flush=True)
    if not all(launches[k] > 0 for k in REPLACES):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain_calls}")
    kernels = []
    for i, r in enumerate(rows[3]):
        kernels.append({
            "name": f"{r['name']}_kernel", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "d": 3, "n": r["n"], "ms_d2": rows[2][i]["ms"],
            "device_ms_d2": rows[2][i]["device_ms"], "bound_ms_d2": rows[2][i]["bound_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
