"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --marker-sweep   # phase 1, the launch cost, 2 and 2h's P sweeps, 3, 3p
    python3 chip_smoke.py --walk-sweep [PARENT]   # rows 1, 2, 5 and 10, parent against change

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each against its plain PyTorch version, drives the paper's New -> Adapt ->
Partition -> Balance -> Ghost -> validate path at full size on the card,
without and with a coarse mesh of simplex trees and over a brick of hex
trees, holds Balance and Ghost against the global-table oracles there,
checkpoints and restores those forests and runs Iterate over them, runs
the main path again as four rank processes over `DistComm`, under seeded
byte faults, and with one rank killed and the rest recovered, asks
the paper's element queries of every leaf, serves the dense LM qwen3-1.7b
at full width and depth, checks the card against the CPU, and runs the
twins of the JAX package's examples, Fig. 11's New to level 8 and the
finite-volume solver at about 26 M leaves.
Phases, in the order they run; any failure exits nonzero:

  1. card and build: the card's name and power limit, torch and CUDA
     versions, the kernels' build from an empty build directory (both
     sources, `sfc.cu` and `flash_attention.cu`, one nvcc each, started
     together);
  2. kernel vs plain: each of the eleven kernels against its plain version
     on N = 2^22 random elements (every level 0..L, every type, every one
     of the d*L key bits set somewhere; for face_sweep, inside_root,
     face_neighbor and tree_transform half the elements anywhere in the
     root cube, outside the root simplex, face_neighbor over every (type,
     face) pair; for eval_route and owner_rank P = 4 markers with an empty
     rank; for successor element 0 and the last element of every level,
     which wraps to element 0, and, untimed (they mix its constant-time
     branch and its walk), N more of eight kinds: carries stopping at every
     level 1..L, elements outside the root, levels 0 and L, and anchors
     with bits finer than their level, for the simplex and hex bodies; for
     tree_transform a face neighbor of each element, just outside the root,
     across every glued face of a periodic brick, and sigma = -1
     crossings, with anchor words that wrap past 2^31 - 1 at d = 2), d = 2
     and 3, exact equality; kernel and plain times by CUDA events around a
     loop of calls, the kernel's device time per launch by CUDA events
     around launches queued behind a spinning kernel (no host time), and
     the byte bound (bytes moved / 3.35 TB/s, the H100 SXM's device memory
     rate); then eval_route and owner_rank on the same queries against P
     = 4, 16, 64, 256, 1024, 4096, 4097, 8192, 32768 and 131072 random
     lex-sorted markers over trees 0..3 with one empty rank and a trailing
     sentinel (the P sweep of the one O(log P) search): each output's
     brackets (marker r <= query < marker r + 1, lex), every output equal
     to the plain version up to P = 1024 and a seeded sample of 2^18
     elements past it, the empty rank owning nothing; the device time and
     bound of each; and the host time a launch of both on 4096 queries
     (P = 4 and 131,072), what a caller pays where inputs are small;
  2h. the hex bodies of the ten kernels that have one (owner_rank's body
     is one for both classes) against their plain versions the same way:
     hexes of every level with h-aligned anchors, half of them anywhere in
     [-2^L, 2^L)^d, twice the root cube; face_neighbor over all 2d faces;
     successor of element 0 and of every level's last element; eval_route
     over nf = 2d face planes at P = 4 with an empty rank, and its P sweep;
     tree_transform across every glued face of a periodic hex brick and
     rows with a permuted and reflected axis; no type column counted in
     the bytes of a body that does not read it;
  2a. flash_attention (the LM's prefill attention) against its plain
     version on the same card tensors, in bf16, fp16 and fp32: qwen3's
     prefill shape (B 8, S 2048, H 16, KV 8, hd 128), S = 1, 127, 128,
     129, 255, 257 and 1000 (around the 128-key tile), H / KV = 1, 4 and H
     (MQA), hd = 32, 64 and 96 (also at the tile's edges), windows of 20
     (below the tile), 100, 128 and 129 (the tile and one past it) and one
     longer than S, and 3 x 16 x 9 = 432 query tiles (past 3 waves of
     132); and causal=False at ragged S (1, 2, 3 and 8 query tiles), G = 1,
     2, 4 and MQA, and windows of 20, 100 and 129; within 2e-2 (bf16,
     fp16) and 2e-5 (fp32); the Hopper
     instructions counted in the built library's SASS (`cuobjdump`:
     HGMMA and UTMALDG, each at least one) and the bf16 hd-128 body's
     ptxas register and spill lines; at qwen3's shape the kernel's time
     both ways beside the earlier mma.sync body's device time (PERF.md
     §6, row 12; not re-measured),
     the plain version's, torch's scaled_dot_product_attention's (the
     `library_ms` yardstick, called only here) and the bound
     max(FLOP / 989 TFLOP/s, bytes / 3.35 TB/s);
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
  3p. (after 3c) owner_rank and eval_route on the queries a real forest
     asks: phase 3's 21,676,544 balanced leaves in SFC order and their face
     sweep (86.7 M pairs), against an equal-count split of the leaves into
     P = 4, 64, 1024, 8192 and 131072 parts (marker r the leaf floor(r n /
     P)), through `BatchedOps.owner_rank` and `BatchedOps.eval_route` on
     each rank's resident sweep: every leaf's owner is its part; brackets
     hold on every leaf and every routed pair; the rows number the valid
     pairs less those wholly in the calling part; exact against the plain
     versions on 2^18 sampled leaves; one launch over all leaves timed
     against its bound; beside it, as a yardstick only, torch.searchsorted
     over the same keys with all markers in one tree (and the owner_rank
     kernel on that problem, equal to it);
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
  3h. the hex path at full size: the 8 hex trees of
     cmesh_hex_brick(3, (2, 2, 2), periodic=(True, True, False)) (40 of 48
     tree faces glued) on SimComm(4): New at level 6 (2,097,152 hexes), the
     parity fractal to level 8 (a hex refines where its cube id at its own
     level has an even number of set bits; 38,797,312), coarsening trees
     4-7 (24,117,248), Partition (13,369,344 hexes migrating), the weighted
     repartition, tree 0's faces to level 9, Balance (at least 2 refining
     rounds), Ghost and validate; the counts held to the closed form
     `parity_fractal_count`, level jumps counted before and after Balance
     as in phase 3c; then the queries of phase 3d on every balanced leaf
     over 2d faces, and face_neighbor of the largest rank against its plain
     version outside the counted run;
  3o. on phase 3's and 3c's forests (after 3c), and on 3h's (after its
     queries): `balance_oracle` of the forests Balance started from equals
     the balanced forests on every rank, and `ghost_oracle` of those the
     message-based Ghost's layers; each oracle's wall and rounds, and its
     `bytes_for` beside Balance's and Ghost's (every round allgathers the
     whole leaf table);
  3k. the same balanced forests through `save_forest` into a temporary
     directory (its wall, bytes on disk, 14 B a tet and 13 a hex at rest)
     and `load_forest` onto the card: at P = 4 the saved forests with their
     partition markers; onto 1 and 3 ranks the same global sequence, valid,
     per-rank counts within 1; with the weights 1 + (level == max level),
     `repartition`'s forests; one flipped anchor byte refused
     (`CheckpointIntegrityError`); each load's wall;
  3i. `iterate` over each one-rank restore of 3k: S same-level and H
     hanging pairs, and, counted apart by a lex-search range, V faces with
     a neighbor and C coarse faces with finer leaves across, with V = 2S +
     H + C and H = 2^(d-1) C; and the uniform level-5 brick of 48 trees
     periodic on every axis (1,572,864 tets) gives exactly 2N pairs;
  3t. the d = 2 main path at full size: 8 trees on SimComm(4), New at
     level 10 (8,388,608 triangles), the fractal (type 0 refined) to level
     11 (20,983,808), coarsening trees 4-7 (14,686,208), Partition (about
     6.3 M triangles migrating), the weighted repartition, Balance (the
     leaves lie a level apart at most, so it must change nothing), Ghost
     and validate; counts held to `fractal_count`, per-phase walls,
     `bytes_for` and peak memory printed, every kernel's launches counted;
     then on every leaf morton_key equal to its plain version and to the
     stored key, and decode(key, level) == (anchor, type), exactly;
  3m. phase 3 as four rank processes sharing the card (`run_ranks`; each
     its own CUDA context, loading the library phase 1 built by its hash),
     through `DistComm` over a TCPStore on localhost that rank 0 hosts:
     New, the fractal, the coarsening, Partition and the weighted
     repartition (`Forest.repartition`) on one DistComm, Balance and Ghost
     overlapped on a second, validate of the world gathered at rest on
     rank 0 through a third, then Balance and Ghost serialized on a fourth;
     per rank, the SHA-256 of every forest and ghost field equal to phase
     3's, each phase's bytes summed over the ranks equal to phase 3's,
     overlapped == serialized with equal wire digests; each phase's wall
     (the slowest rank), each rank's peak device memory, the kernels'
     launches summed over the ranks; no plain version called in any rank;
     and, first, the store's rate for one 32 MB blob;
  3r. resilience: (a) phase 3's path on `ChaosComm(SimComm(4))` with
     seeded corruption, truncation, duplication and delay in Partition,
     Balance and Ghost: forests, ghosts and bytes equal phase 3's, and
     every injected byte fault detected; (b) four rank processes run phase
     3's path to Balance with an `Autosaver` at balance:begin and
     `ChaosComm(DistComm, crash_at=3, crash_ranks=(3,), hard_exit=True)`
     under a 6 s deadline a Balance collective: rank 3 exits 2, ranks 0-2
     raise `CommTimeoutError` with phase balance and pending [3]; a fresh
     world of three processes `recover`s the checkpoint (saved by four),
     finishes Balance and Ghost, equals an in-process `SimComm(3)` run of
     the same path on the card element for element, and validates; the
     time to detect, the save wall and the recover wall;
  3b. the kernels timed (both ways, as in phase 2) at the sizes phases 3,
     3d and 3c launched them with (the smallest, two between and the
     largest, per kernel), and morton_key and decode at d = 2 at the sizes
     phase 3t launched them with; New's "decode" and "successor" methods on
     16,777,216 tets (d = 3, 8 trees, level 7, 3 ranks): the same forests,
     and the wall of each;
  4. card vs CPU: the same pipelines at small size (level 1 -> 3) on both
     devices — d = 3 and d = 2 on 8 trees, and over the 48-tree brick, a
     periodic 2 x 2 brick of triangles, the rotated pair, a periodic 2 x 2
     hex brick, a 2 x 2 x 1 hex brick, and the hybrid pair (a hex tree
     beside a Kuhn cube) at d = 2 and 3 on 2 and 3 ranks, with tree 0's
     faces refined deeper — every forest and ghost field and every
     per-phase byte count identical, and so both oracles' results and
     bytes, Iterate's pairs on every rank and the bytes `save_forest`
     writes; and the LM: reduced qwen3, olmo and
     phi3 in fp32 on identical weights, prefill and 6 greedy decode steps,
     equal tokens and logits within 1e-4;
  6. serving qwen3-1.7b (28 layers, d 2048, 16/8 heads, hd 128, vocab
     151,936, tied; weights drawn on the card from a seed) through
     `launch/serve.py`'s steps: 6a, 8 requests of 2048 tokens prefilled
     into a cache of 2304 slots and 128 greedy decode steps (walls, tokens
     per second, peak memory, the decode floor of weights and cache read
     once a step, and a profile of one prefill and one decode step); 6b,
     8 requests at batch 1 (prompts of 1 to 2047 tokens) answering 16
     tokens each; 6c, fp32 at full width: prefill 508 tokens and decode 4
     against forward's logits at those positions, within 1e-3; every
     logit finite;
  7. the twins of the JAX package's examples (`repro_torch.examples`):
     (a) each twin's `main()` on the card (quickstart, amr_fractal,
     multitree_cube, fem_diffusion, sfc_expert_placement, serve_lm), its
     lines (`untimed`: times, the device and the conservation error's
     digits left out) equal to the same twin's lines on the CPU, no plain
     version called, the kernels of its path launched (every kernel of
     phase 3's path in quickstart and multitree_cube, tree_transform in
     multitree_cube, face_neighbor in quickstart, 20 flash_attention
     launches in serve_lm's prefills); serve_lm serves the same weights
     (drawn on the CPU) on both sides, and its tokens and each decode
     step's logits on the card equal the CPU's, the logits within 2e-4
     (a differing token only at a near tie: top-2 gap under 1e-4, logits
     within 1e-4); (b) Fig. 11's New on one tree at
     levels 4-8 (8^8 = 16,777,216 tets), a warm-up pass and five more:
     each level's median wall and ns per element, and the ratio of ns per
     element at level 8 to level 6 (printed, not asserted); (c) fem_diffusion's finite-volume
     solver with New at level 5 and the blob refined to level 9 (about 26
     M leaves): leaves, face pairs, the walls of New, Adapt, Balance,
     Iterate and the 60 steps, peak device memory, and the example's
     conservation (below 1e-12 relative) and decay (max u < 1) checks;
  5. launch counts: every kernel of the pipeline launched in phase 3
     (tree_transform aside: that path has no tree faces) and in phase 3c,
     owner_rank (Ghost's owner lookup) among them; owner_rank, successor
     and face_neighbor launched in phase 3d; no plain version called in
     any of the three; every hex body launched in phase 3h or its queries
     (`class_launch_counts`), no simplex body and no plain version there;
     over the hybrid pair, Balance and Ghost launch face_sweep and
     eval_route per class exactly as the class groups run on their own
     (one launch per class per eval layer); phases 3o and 3i launch
     face_sweep (3o also decode, for ghost_oracle's candidates), 3k
     morton_key and inside_root, across tree faces tree_transform and
     morton_key, on the hex phase hex bodies only, and none calls a plain
     version; phases 3t, 3m and 3r (3m and 3r summed over their rank
     processes, 3r(b)'s survivors and recovery world together) launch every
     kernel phase 3 launches, and no plain version runs in 3t or 3r(a); in
     phase 6,
     flash_attention launched once a layer a prefill (6c: the prefill and
     forward) and no plain version called.

With `--marker-sweep` the script runs phase 1, the launch cost and the P
sweeps of 2 and 2h, 3 and 3p, and prints their rows as one JSON line: run
from a checkout of another commit (this file copied in), it measures that
commit's design with the same code, for a before/after table of the owner
search (a later redesign of it measures its parent so).  With
`--walk-sweep` it runs phase 1 and times rows 1, 2, 5 and 10 (the kernels
whose simplex bodies walk the levels), simplex and hex bodies, as phase 2
does, and their simplex bodies at the sizes phases 3 and 3d (d = 3) and 3t
(d = 2) launch them, as phase 3b does, printing the rows as one JSON line;
`--walk-sweep PARENT` runs that four times in fresh processes, from PARENT
(a checkout of the parent commit with this file copied in), here, here and
PARENT, and prints each row's device times, parent against change, before
one JSON line of all four runs.

The second-to-last lines are a JSON `kernels` line and the `nvidia-smi`
name/power-limit line; the last line is the JSON result.  In the `kernels`
line, `launches_phase3`, `launches_phase3c` and `launches_phase3d` are
each kernel's launches in those phases (`launches_phase3t` those of
phase 3t), and `launches` is those of the
first of phases 3, 3c and 3d that runs it: phase 3 for the eight kernels
of the cmesh-free pipeline, phase 3c for `tree_transform`, phase 3d for
`successor` and `face_neighbor`; `launches_phase3o`, `_phase3k` and
`_phase3i` are its launches in those phases, summed over the forests they
ran on; for eval_route and owner_rank, `sweep_device_ms` (and `_d2`,
`hex_sweep_device_ms`) map each P of the sweep to its device time, beside
`sweep_bound_ms`, `phase3p_device_ms` each P of phase 3p, and
`host_us_a_launch` the launch cost;
`launches_phase3m` its launches in 3m summed over the four rank
processes, `launches_phase3r` those of 3r(a) and 3r(b) together, and
`launches_phase7` those of phase 7's twins, (a) to (c) summed.  A JSON
`runtime` line before it has 3m's and 3r's walls, memory, bytes, fault
counts and the store's rate, and phase 7's facts under `examples`.  The `hex_*` keys are the hex body's:
`hex_replaces` the Pallas kernel's hex branch, `hex_launches_phase3h` its
launches in phase 3h and its queries, and its phase-2h times and bounds at
d = 3 and (`_d2`) d = 2.  The `flash_attention_kernel` entry has its
launches in phase 6a (and 6b, 6c), its phase-2a numbers at qwen3's shape,
and phase 6's serving facts under `serve`.  Without a card, or without the repository beside
it, the script exits nonzero and prints no result.  It imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import importlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_KERNEL = 1 << 22
SEED = 12
MULTI_P = 4             # phase 3's ranks (SimComm(4)); one rank process each in 3m
PATH3 = (3, 8, 6, 8)    # phase 3's d, trees, New's level and the fractal's level
PATH3T = (2, 8, 10, 11)  # phase 3t's: the d = 2 main path at full size
MIGRATED3T = 6_000_000   # phase 3t's Partition moves at least this many triangles
# The rows whose simplex bodies walk the levels (1 morton_key, 2 decode, and
# 5 face_sweep and 10 successor, which share encode_key and decode_walk):
# what `--walk-sweep` times, before against after a redesign of the walks.
WALK_ROWS = ("morton_key", "decode", "face_sweep", "successor")
# Phases 2 and 2h: eval_route and owner_rank against P markers, for each P here;
# up to SWEEP_ALL_CHECKED markers every output is held against the plain
# version, past it a seeded sample of SAMPLE elements (the plain
# compare-and-count costs O(N P)), and every output by its bracketing markers.
MARKER_SWEEP = (4, 16, 64, 256, 1024, 4096, 4097, 8192, 32768, 131072)
SWEEP_ALL_CHECKED = 1024
SAMPLE = 1 << 18
MIN_OWNER_SHARE = 0.9   # of the P - 2 ranks that can own (not the empty rank, not the sentinel)
# Phase 3p: equal-count splits of phase 3's balanced leaves into P parts.
SPLIT_MARKERS = (4, 64, 1024, 8192, 131072)
# Host cost a launch of owner_rank and eval_route on a small input (a rank's
# share of a small Ghost or Balance): LAUNCH_COST_N queries, calls timed in
# rounds of LAUNCH_COST_REPS on the host's clock.
LAUNCH_COST_N = 4096
LAUNCH_COST_REPS = 200
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
# The hex branch of each Pallas kernel body (eval_route reads nf off its
# tile; tree_transform and owner_rank have one body for both classes).
HEX_REPLACES = {
    "morton_key": "src/repro/kernels/sfc.py:232",
    "decode": "src/repro/kernels/sfc.py:264",
    "parent": "src/repro/kernels/sfc.py:421",
    "children": "src/repro/kernels/sfc.py:450",
    "face_sweep": "src/repro/kernels/sfc.py:319",
    "eval_route": "src/repro/kernels/sfc.py:724",
    "inside_root": "src/repro/kernels/sfc.py:545",
    "tree_transform": "src/repro/kernels/sfc.py:678",
    "owner_rank": "src/repro/kernels/sfc.py:696",
    "successor": "src/repro/kernels/sfc.py:346",
    "face_neighbor": "src/repro/kernels/sfc.py:289",
}
ECLASS_HEX = 1          # the hex element class (repro_torch.core.types)
SOURCE = "src/repro_torch/kernels/csrc/sfc.cu"
WIRE_TRIPLE_BYTES = 13
# Phase 3c: inter-tree faces with a leaf more than one level finer across
# them before Balance, at least (tree 0's faces at level 9 against leaves
# of level 5-7 in the trees they are glued to).
MIN_INTER_TREE_JUMPS = 10_000
TREE_FACES_LEVEL = 9   # phases 3c and 3h: tree 0's faces refined to this level


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
    """P >= 4 lex-sorted random markers over trees 0..3 with one empty rank
    (its marker repeats the next rank's) and a trailing (4, 0) sentinel;
    returns (tree, key, the empty rank)."""
    from repro_torch.core.tables import MAXLEVEL

    rng = np.random.default_rng(SEED + 100 * d)
    mt = rng.integers(0, 4, P).astype(np.int32)
    mk = rng.integers(0, 1 << (d * MAXLEVEL[d]), P, dtype=np.uint64).astype(np.int64)
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    empty = min(P // 2, P - 3)
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
        "owner_rank": ((o_tree, key, mt, mk), lambda: kops.owner_rank(o_tree, key, mt, mk),
                       lambda: kref.owner_rank(o_tree, key, mt, mk)),
        "successor": ((s_anchor, level, s_stype),
                      lambda: kops.successor(s_anchor, level, s_stype),
                      lambda: kref.successor(s_anchor, level, s_stype)),
        "face_neighbor": ((c_anchor, level, c_stype, face),
                          lambda: kops.face_neighbor(c_anchor, level, c_stype, face),
                          lambda: kref.face_neighbor(c_anchor, level, c_stype, face)),
    }


SUCCESSOR_KINDS = 8


def successor_classes(d: int, n: int, device):
    """Phase 2's untimed successor inputs, which mix the kernel's two
    branches: (anchor, level, type, kind, carry level), row i of kind i % 8:
    0 an element inside the root simplex at a level 0..L (rows 0 and 8 at
    levels 0 and L), 1 element 0 of its level, 2 its level's last element,
    3 and 7 an element whose +1 carries from its level up to level i, i = 1,
    2, ..., L in turn (its key digits of levels i + 1..level are 2^d - 1,
    digit i is not), 4 an element anywhere in the root cube, of any type
    (most outside the root simplex), 5 and 6 the anchors of kinds 0 and 4
    with random bits finer than their level.  The carry level is 0 outside
    kinds 3 and 7."""
    from repro_torch.core.keys import span_mask
    from repro_torch.core.tables import MAXLEVEL
    from repro_torch.kernels import ref as kref

    L, nc = MAXLEVEL[d], 1 << d
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 30 * d)
    row = torch.arange(n, device=device)
    kind = row % SUCCESSOR_KINDS
    level = torch.randint(0, L + 1, (n,), generator=gen, device=device)
    level[0], level[8] = 0, L
    carry = (kind == 3) | (kind == 7)
    i = torch.where(carry, 1 + (row // 4) % L, 0)     # rows 3, 7, 11, ...: i = 1, 2, 3, ...
    u = torch.rand(n, generator=gen, device=device)
    level = torch.where(carry, i + (u * (L + 1 - i)).long().clamp(max=L - i), level)
    lvl = level.to(torch.int32)
    hi = torch.randint(0, 1 << 31, (n,), generator=gen, device=device, dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, (n,), generator=gen, device=device, dtype=torch.int64)
    key = ((hi << 32) | lo) & ((1 << (d * L)) - 1)
    below = span_mask(d, L, lvl)                      # the digits below the level
    at_i = d * (L - i.clamp(min=1))                   # the bit of level i's digit
    top = torch.full_like(at_i, nc - 1)
    digit = ((key >> at_i) & (nc - 1)) % (nc - 1)
    ones = (torch.bitwise_left_shift(torch.ones_like(at_i), at_i) - 1) & ~below
    key = torch.where(carry, (key & ~torch.bitwise_left_shift(top, at_i))
                      | torch.bitwise_left_shift(digit, at_i) | ones, key)
    key = torch.where(kind == 1, 0, torch.where(kind == 2, (1 << (d * L)) - 1, key)) & ~below
    anchor, stype = kref.decode(d, key, lvl)
    h = torch.bitwise_left_shift(torch.ones_like(level), L - level)[:, None]
    cube = (kind == 4) | (kind == 6)
    c_anchor = torch.randint(0, 1 << L, (n, d), generator=gen, device=device) // h * h
    anchor = torch.where(cube[:, None], c_anchor.to(torch.int32), anchor)
    stype = torch.where(cube, torch.randint(0, 2 if d == 2 else 6, (n,), generator=gen,
                                            device=device, dtype=torch.int32), stype)
    fine = ((kind == 5) | (kind == 6))[:, None]
    noise = torch.randint(0, 1 << L, (n, d), generator=gen, device=device) % h
    anchor = torch.where(fine, anchor | noise.to(torch.int32), anchor).contiguous()
    return anchor, lvl, stype.contiguous(), kind, i


def successor_every_class(d: int, n: int, device) -> str:
    """Phase 2, untimed: the successor kernel against its plain version on
    `successor_classes`, exact, for the simplex and (on the same anchors,
    fine bits included) the hex body; checks that the carries stop at every
    level 1..L, that kind 4 holds elements outside the root and that kinds
    5 and 6 hold fine bits.  Returns the coverage text."""
    from repro_torch.core.tables import MAXLEVEL
    from repro_torch.kernels import ops as kops, ref as kref

    L = MAXLEVEL[d]
    anchor, level, stype, kind, carry_level = successor_classes(d, n, device)
    carries = torch.unique(carry_level[(kind == 3) | (kind == 7)]).tolist()
    inside = kref.inside_root(anchor, level, stype)
    outside = int((~inside[kind == 4]).sum())
    h = torch.bitwise_left_shift(torch.ones_like(level), L - level)[:, None]
    fine = int(((anchor % h) != 0).any(1)[(kind == 5) | (kind == 6)].sum())
    if carries != list(range(1, L + 1)) or not bool(inside[kind == 0].all()) or not outside:
        raise AssertionError(f"successor d={d}: carries stop at levels {carries}, "
                             f"{outside} elements outside the root")
    compare_exact(f"successor d={d}, every input class",
                  lambda: kops.successor(anchor, level, stype),
                  lambda: kref.successor(anchor, level, stype))
    zero = torch.zeros_like(stype)
    compare_exact(f"hex successor d={d}, every input class",
                  lambda: kops.successor(anchor, level, zero, ECLASS_HEX),
                  lambda: kref.successor(anchor, level, zero, ECLASS_HEX))
    del anchor, level, stype, inside, zero
    return (f"; untimed, {n} more of {SUCCESSOR_KINDS} kinds, kernel == plain for both "
            f"classes: carries stopping at each of levels 1..{L}, {outside} elements outside "
            f"the root, {fine} anchors with bits finer than their level")


@functools.lru_cache(maxsize=None)
def hex_transform_connections(d: int, device):
    """The hex connections phase 2 crosses: every glued face of a periodic
    hex brick of 2^d cells, and two synthetic rows made by
    `pack_connection`: a rotation (an axis permuted and reflected) and a
    reflection of axis 0.  Returns (packed int32 table (C, W) on `device`,
    linear parts (C, d, d) and unwrapped translations (C, d), int64)."""
    from repro_torch.core import cmesh as C

    cm = C.cmesh_hex_brick(d, (2,) * d, periodic=(True,) * d)
    conn = cm.gluing("cpu").conn
    Ms, cs, rows = [], [], []
    for t, f in zip(*np.nonzero(cm.face_tree >= 0)):
        Ms.append(cm.face_M[t, f])
        cs.append(cm.face_c[t, f])
        rows.append(conn[t * cm.nf_max + f].numpy())
    L = C.MAXLEVEL[d]
    rot = np.eye(d, dtype=np.int64)
    rot[:2, :2] = [[0, -1], [1, 0]]
    flip = np.eye(d, dtype=np.int64)
    flip[0, 0] = -1
    for M in (rot, flip):
        c = np.ones(d, np.int64) << L
        Ms.append(M)
        cs.append(c)
        rows.append(C.pack_connection(d, M, c, np.zeros(math.factorial(d), np.int32),
                                      C._hex_face_map(d, M), 3, eclass=ECLASS_HEX))
    return (torch.from_numpy(np.stack(rows)).to(device),
            torch.from_numpy(np.stack(Ms).astype(np.int64)).to(device),
            torch.from_numpy(np.stack(cs).astype(np.int64)).to(device))


def hex_kernel_cases(d: int, n: int, device) -> dict:
    """{kernel: (inputs, kernel call, plain call)} of the hex bodies on n
    random hexes: every level 0..L with h-aligned anchors (a hex decode of
    keys with every key bit set somewhere), half of them anywhere in the box
    [-2^L, 2^L)^d, twice the root cube, so that neighbors fall outside the
    root on every side.  The inputs list only what a hex body reads: no
    type column."""
    from repro_torch.core.keys import span_mask
    from repro_torch.core.tables import MAXLEVEL
    from repro_torch.kernels import ops as kops, ref as kref

    L, H = MAXLEVEL[d], ECLASS_HEX
    key, level = random_inputs(d, n, device)
    anchor, zero = kref.decode(d, key, level, H)
    span1 = span_mask(d, L, level)
    which = torch.arange(n, device=device) % 8
    s_key = torch.where(which == 1, 0, torch.where(which == 2, ((1 << (d * L)) - 1) ^ span1,
                                                   key & ~span1))
    s_anchor, _ = kref.decode(d, s_key, level, H)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 20 * d)
    h = torch.bitwise_left_shift(torch.ones_like(level, dtype=torch.int64), L - level.long())
    box = torch.randint(-(1 << L), 1 << L, (n, d), generator=gen, device=device)
    box = torch.div(box, h[:, None], rounding_mode="floor") * h[:, None]
    odd = (torch.arange(n, device=device) & 1).bool()
    c_anchor = torch.where(odd[:, None], box.to(torch.int32), anchor).contiguous()
    nb_anchor, _nb_type, nb_dual, _in, nkey = kref.face_sweep(c_anchor, level, zero, H)
    tgt = torch.randint(0, 4, nkey.shape, generator=gen, device=device, dtype=torch.int32)
    mt, mk = route_markers(d, device)
    table, _M, _c = hex_transform_connections(d, device)
    conn = torch.randint(0, table.shape[0], (n,), generator=gen, device=device, dtype=torch.int32)
    face = torch.randint(0, 2 * d, (n,), generator=gen, device=device)
    row = torch.arange(n, device=device)
    x_anchor, x_dual = nb_anchor[face, row].contiguous(), nb_dual[face, row].contiguous()
    del nb_anchor, nb_dual
    face = face.to(torch.int32)
    return {
        "morton_key": ((anchor,), lambda: kops.morton_key(anchor, zero, H),
                       lambda: kref.morton_key(anchor, zero, H)),
        "decode": ((key, level), lambda: kops.decode(d, key, level, H),
                   lambda: kref.decode(d, key, level, H)),
        "parent": ((anchor, level), lambda: kops.parent(anchor, level, zero, H),
                   lambda: kref.parent(anchor, level, zero, H)),
        "children": ((anchor, level), lambda: kops.children(anchor, level, zero, H),
                     lambda: kref.children(anchor, level, zero, H)),
        "face_sweep": ((c_anchor, level), lambda: kops.face_sweep(c_anchor, level, zero, H),
                       lambda: kref.face_sweep(c_anchor, level, zero, H)),
        "eval_route": ((tgt, nkey, level, mt, mk),
                       lambda: kops.eval_route(d, tgt, nkey, level, mt, mk),
                       lambda: kref.eval_route(d, tgt, nkey, level, mt, mk)),
        "inside_root": ((c_anchor, level), lambda: kops.inside_root(c_anchor, level, zero, H),
                        lambda: kref.inside_root(c_anchor, level, zero, H)),
        "tree_transform": ((conn, x_anchor, level, x_dual, table),
                           lambda: kops.tree_transform(conn, x_anchor, level, zero, x_dual,
                                                       table, H),
                           lambda: kref.tree_transform(conn, x_anchor, level, zero, x_dual,
                                                       table, H)),
        "successor": ((s_anchor, level), lambda: kops.successor(s_anchor, level, zero, H),
                      lambda: kref.successor(s_anchor, level, zero, H)),
        "face_neighbor": ((c_anchor, level, face),
                          lambda: kops.face_neighbor(c_anchor, level, zero, face, H),
                          lambda: kref.face_neighbor(c_anchor, level, zero, face, H)),
    }


def compare_exact(label: str, kernel, plain) -> tuple[tuple, tuple, int]:
    """(kernel outputs, plain outputs, max |difference|), which must be 0,
    with shapes and dtypes equal."""
    got, want = kernel(), plain()
    sync()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    if err:
        raise AssertionError(f"{label}: kernel differs from plain, max |err| {err}")
    return got, want, err


def timing_row(name: str, d: int, n: int, inputs, got, kernel, plain, err: int, cover: str,
               reps: int, plain_reps: int, tag: str = "") -> dict:
    """Kernel time by CUDA events around a loop of calls, its device time,
    the plain version's time and the byte bound of the inputs it reads and
    the outputs it writes; printed and returned as a row."""
    ms = cuda_ms(kernel, reps)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_ms(plain, plain_reps)
    moved = nbytes(*inputs) + nbytes(*got)
    bound_ms = moved / MEM_BYTES_PER_S * 1e3
    print(f"  {tag}{name:13s} d={d} n={n}: kernel == plain (tolerance 0); kernel {ms:.4f} ms "
          f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({moved} B, {moved // n} B/element), bound/kernel {bound_ms / ms:.1%} "
          f"(device {bound_ms / dev_ms:.1%}){cover}", flush=True)
    return {"name": name, "d": d, "n": n, "max_abs_err": float(err), "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bytes": moved}


def lex_le(ta, ka, tb, kb) -> torch.Tensor:
    """(ta, ka) lex-<= (tb, kb), elementwise."""
    return (ta < tb) | ((ta == tb) & (ka <= kb))


def brackets_hold(rank: torch.Tensor, t: torch.Tensor, k: torch.Tensor, mt: torch.Tensor,
                  mk: torch.Tensor) -> torch.Tensor:
    """Whether each rank r of the lex (t, k) is bracketed by the P sorted
    markers, all lex: for r > 0, marker r <= (t, k), and r + 1 = P or
    (t, k) < marker r + 1; for r = 0, P = 1 or (t, k) < marker 1 (a count of
    0 or 1, which the clamp merges).  Torch gathers, elementwise."""
    P = mt.shape[0]
    r = rank.long()
    above = r > 0
    nxt = (r + 1).clamp(max=P - 1)
    lo = ~above | lex_le(mt[r], mk[r], t, k)
    hi = (r + 1 >= P) | ~lex_le(mt[nxt], mk[nxt], t, k)
    return lo & hi & (r >= 0) & (r < P)


def sample_columns(n: int, device, seed: int) -> torch.Tensor:
    """SAMPLE sorted element indices of n, seeded (all of them if n is smaller)."""
    if n <= SAMPLE:
        return torch.arange(n, device=device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return torch.randperm(n, generator=gen)[:SAMPLE].sort().values.to(device)


def sweep_row(name: str, d: int, P: int, inputs, tag: str = "") -> dict:
    """One point of the P sweep of phases 2 and 2h: `name` (eval_route or
    owner_rank) on phase 2's queries against P markers from `many_markers`;
    exact against the plain version on every output up to SWEEP_ALL_CHECKED
    markers and on a sample of SAMPLE elements past it, every output's
    brackets, the empty rank owning nothing; its device time against the
    byte bound."""
    from repro_torch.core.keys import span_mask
    from repro_torch.core.tables import MAXLEVEL
    from repro_torch.kernels import ops as kops, ref as kref

    dev = inputs[0].device
    mt, mk, empty = many_markers(d, P, dev)
    if name == "eval_route":
        tgt, nkey, level = inputs[:3]
        args = (tgt, nkey, level, mt, mk)
        kernel = lambda: kops.eval_route(d, *args)            # noqa: E731
        n = level.shape[0]
        got = kernel()
        sync()
        kend = nkey | span_mask(d, MAXLEVEL[d], level)[None, :]
        ok = (torch.equal(got[0], kend) and bool(brackets_hold(got[1], tgt, nkey, mt, mk).all())
              and bool(brackets_hold(got[2], tgt, kend, mt, mk).all()))
        idx = torch.arange(n, device=dev) if P <= SWEEP_ALL_CHECKED else sample_columns(n, dev, P)
        want = kref.eval_route(d, tgt[:, idx].contiguous(), nkey[:, idx].contiguous(),
                               level[idx].contiguous(), mt, mk)
        pick = lambda x: x[:, idx]                            # noqa: E731
    else:
        tree, key = inputs[:2]
        args = (tree, key, mt, mk)
        kernel = lambda: kops.owner_rank(*args)                # noqa: E731
        n = key.shape[0]
        got = (kernel(),)
        sync()
        ok = bool(brackets_hold(got[0], tree, key, mt, mk).all())
        idx = torch.arange(n, device=dev) if P <= SWEEP_ALL_CHECKED else sample_columns(n, dev, P)
        want = (kref.owner_rank(tree[idx].contiguous(), key[idx].contiguous(), mt, mk),)
        pick = lambda x: x[idx]                               # noqa: E731
    err = max(int((pick(g).long() - w.long()).abs().max()) for g, w in zip(got, want, strict=True))
    owners = torch.unique(torch.cat([g.flatten() for g in got if g.dtype == torch.int32]))
    if not ok or err or bool((owners == empty).any()) or owners.numel() < MIN_OWNER_SHARE * (P - 2):
        raise AssertionError(f"{tag}{name} d={d} P={P}: brackets hold {ok}, max |err| {err} "
                             f"against the plain version, {owners.numel()} owners, empty rank "
                             f"{empty} among them {bool((owners == empty).any())}")
    dev_ms = device_ms(kernel)
    moved = nbytes(*args) + nbytes(*got)
    bound_ms = moved / MEM_BYTES_PER_S * 1e3
    checked = "every output" if P <= SWEEP_ALL_CHECKED else f"{idx.numel()} sampled elements"
    print(f"  {tag}{name:10s} d={d} P={P:>6}: device {dev_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({moved} B), bound/device {bound_ms / dev_ms:.1%}; "
          f"== plain on {checked}, brackets hold on all {got[-1].numel():,} outputs, "
          f"{owners.numel()} owners, empty rank {empty} not among them", flush=True)
    return {"name": name, "body": tag.strip() or "simplex", "d": d, "P": P, "n": n,
            "device_ms": dev_ms, "bound_ms": bound_ms, "bytes": moved, "max_abs_err": float(err),
            "checked": checked}


def marker_sweep(d: int, cases: dict, tag: str = "") -> list[dict]:
    """The P sweep of phase 2 (eval_route and owner_rank) or 2h (`tag`
    "hex ": eval_route over 2d planes) on the phase's own queries."""
    names = ("eval_route",) if tag else ("eval_route", "owner_rank")
    rows = [sweep_row(name, d, P, cases[name][0], tag) for name in names for P in MARKER_SWEEP]
    torch.cuda.empty_cache()
    return rows


def launch_cost(device) -> list[dict]:
    """The host time a launch of owner_rank and of eval_route (d = 3, 2)
    on LAUNCH_COST_N random queries against P = 4 and 131,072 markers, what
    a caller pays a launch where inputs are small: the median over 5 rounds
    of LAUNCH_COST_REPS calls enqueued back to back, on the host's clock
    (`enqueue`), and of the same rounds up to the card's end (`wall`)."""
    from repro_torch.core.tables import MAXLEVEL
    from repro_torch.kernels import ops as kops

    rows = []
    rng = np.random.default_rng(SEED)
    n = LAUNCH_COST_N
    for d in (3, 2):
        top = 1 << (d * MAXLEVEL[d])
        on = lambda x: torch.from_numpy(x).to(device)         # noqa: E731
        tree = on(rng.integers(0, 4, n, dtype=np.int32))
        tgt = on(rng.integers(0, 4, (d + 1, n), dtype=np.int32))
        key = on(rng.integers(0, top, n, dtype=np.uint64).astype(np.int64))
        nkey = on(rng.integers(0, top, (d + 1, n), dtype=np.uint64).astype(np.int64))
        level = torch.full((n,), MAXLEVEL[d], dtype=torch.int32, device=device)
        for P in (4, 131072):
            mt, mk, _empty = many_markers(d, P, device)
            calls = {"eval_route": lambda: kops.eval_route(d, tgt, nkey, level, mt, mk)}
            if d == 3:
                calls["owner_rank"] = lambda: kops.owner_rank(tree, key, mt, mk)
            for name, call in calls.items():
                call()
                sync()
                enq, wall = [], []
                for _ in range(5):
                    t0 = time.perf_counter()
                    for _ in range(LAUNCH_COST_REPS):
                        call()
                    t1 = time.perf_counter()
                    sync()
                    t2 = time.perf_counter()
                    enq.append((t1 - t0) / LAUNCH_COST_REPS * 1e6)
                    wall.append((t2 - t0) / LAUNCH_COST_REPS * 1e6)
                row = {"name": name, "d": d, "P": P, "n": n,
                       "enqueue_us": float(np.median(enq)), "wall_us": float(np.median(wall))}
                rows.append(row)
                print(f"  launch cost {name:10s} d={d} P={P:>6} n={n}: host {row['enqueue_us']:.2f} "
                      f"us a call enqueued, {row['wall_us']:.2f} us a call to the card's end "
                      f"(median of 5 x {LAUNCH_COST_REPS})", flush=True)
    return rows


def split_markers(tree: torch.Tensor, key: torch.Tensor, P: int):
    """An equal-count split of n lex-sorted leaves into P parts, as a P-rank
    Partition gives it: marker r is the (tree, key) of leaf floor(r n / P).
    Returns (marker tree, marker key, the first leaf of each part)."""
    cut = torch.arange(P, device=tree.device, dtype=torch.int64) * tree.shape[0] // P
    return tree[cut].contiguous(), key[cut].contiguous(), cut


def split_owner(cut: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """The part of an equal-count split that holds leaf j."""
    return torch.searchsorted(cut, j, right=True) - 1


def real_queries(fs: list) -> list[dict]:
    """Phase 3p: owner_rank and eval_route on the queries a real forest asks,
    phase 3's balanced leaves (in SFC order) and their face sweep, against
    equal-count splits of those leaves into P parts, P in SPLIT_MARKERS,
    through the `BatchedOps` methods Ghost and Balance call.  For each P:
    every leaf's owner is its part, and its bracket holds; eval_route
    through `BatchedOps.eval_route` on each rank's resident sweep (the
    handle Balance's eval stage builds), with g the part of the rank's
    first leaf: every returned row's first and last owners are bracketed,
    none is (g, g), and the rows number the valid pairs less those wholly
    inside part g; exact against the plain versions on SAMPLE sampled
    leaves; the device time of one launch over all leaves (and, for
    eval_route, their face pairs) against the byte bound; beside it, as a
    yardstick only, torch.searchsorted over the same keys with all the
    markers in one tree, and the owner_rank kernel on that same problem."""
    from repro_torch.core import forest as F
    from repro_torch.core.keys import span_mask
    from repro_torch.core.tables import MAXLEVEL
    from repro_torch.kernels import ops as kops, ref as kref

    b, d, dev = fs[0].bops, fs[0].d, fs[0].device
    L = MAXLEVEL[d]
    tree = torch.cat([f.tree for f in fs]).contiguous()
    key = torch.cat([f.keys for f in fs]).contiguous()
    n = tree.shape[0]
    handles = [F._resident_sweep(f, b) for f in fs]
    tgt = torch.cat([h.tgt for h in handles], 1).contiguous()
    nkey = torch.cat([h.key for h in handles], 1).contiguous()
    level = torch.cat([h.level for h in handles]).contiguous()
    starts = np.cumsum([0] + [f.num_local for f in fs[:-1]])
    idx = sample_columns(n, dev, SEED)
    zeros = torch.zeros_like(tree)
    leaf = torch.arange(n, device=dev)
    rows = []
    for P in SPLIT_MARKERS:
        mt, mk, cut = split_markers(tree, key, P)
        mt_h, mk_h = mt.cpu().numpy(), mk.cpu().numpy().astype(np.uint64)
        # owner_rank: every leaf's owner is its part
        own = b.owner_rank(tree, key, mt, mk)
        if not (torch.equal(own.long(), split_owner(cut, leaf))
                and bool(brackets_hold(own, tree, key, mt, mk).all())
                and torch.equal(own[idx], kref.owner_rank(tree[idx], key[idx], mt, mk))):
            raise AssertionError(f"3p P={P}: owner_rank misplaces a leaf")
        # eval_route through BatchedOps on each rank's resident sweep
        routed = 0
        for f, h, s0 in zip(fs, handles, starts, strict=True):
            g = int(split_owner(cut, torch.tensor([int(s0)], device=dev))[0])
            rp = b.eval_route(h, mt_h, mk_h, g)
            rt, rk, rl, rf, rla = (torch.as_tensor(x, device=dev) for x in (
                rp.tree, rp.key.astype(np.int64), rp.level, rp.first, rp.last))
            rke = rk | span_mask(d, L, rl)
            if not (bool(brackets_hold(rf, rt, rk, mt, mk).all())
                    and bool(brackets_hold(rla, rt, rke, mt, mk).all())
                    and not bool(((rf == g) & (rla == g)).any())):
                raise AssertionError(f"3p P={P}: a routed pair of rank {f.rank} is misplaced")
            hke = h.key | span_mask(d, L, h.level)[None, :]
            inside = h.valid & ((g == 0) | lex_le(mt[g], mk[g], h.tgt, h.key))
            if g + 1 < P:
                inside &= ~lex_le(mt[g + 1], mk[g + 1], h.tgt, hke)
            if rt.shape[0] != int(h.valid.sum()) - int(inside.sum()):
                raise AssertionError(f"3p P={P}: rank {f.rank} routed {rt.shape[0]} pairs")
            routed += rt.shape[0]
            del rt, rk, rl, rf, rla, rke, hke, inside, rp
        # the kernels' device time over all leaves, and a sample against the plain version
        got = kops.eval_route(d, tgt, nkey, level, mt, mk)
        kend = nkey | span_mask(d, L, level)[None, :]
        want = kref.eval_route(d, tgt[:, idx].contiguous(), nkey[:, idx].contiguous(),
                               level[idx].contiguous(), mt, mk)
        if not (torch.equal(got[0], kend) and bool(brackets_hold(got[1], tgt, nkey, mt, mk).all())
                and bool(brackets_hold(got[2], tgt, kend, mt, mk).all())
                and all(torch.equal(g_[:, idx], w) for g_, w in zip(got, want, strict=True))):
            raise AssertionError(f"3p P={P}: eval_route over all pairs differs")
        for name, args, outs in (
                ("owner_rank", (tree, key, mt, mk), (own,)),
                ("eval_route", (tgt, nkey, level, mt, mk), got)):
            call = (lambda a=args: kops.owner_rank(*a)) if name == "owner_rank" else \
                (lambda a=args: kops.eval_route(d, *a))
            ms = device_ms(call)
            moved = nbytes(*args) + nbytes(*outs)
            bound = moved / MEM_BYTES_PER_S * 1e3
            rows.append({"name": name, "P": P, "n": n, "device_ms": ms, "bound_ms": bound,
                         "bytes": moved})
            print(f"  3p {name:10s} P={P:>6} over {n:,} leaves"
                  + (f" ({got[0].numel():,} face pairs, {routed:,} routed)"
                     if name == "eval_route" else "")
                  + f": device {ms:.4f} ms, bound {bound:.4f} ms, bound/device {bound / ms:.1%}",
                  flush=True)
        del got, kend, want
        # the yardstick: all markers in one tree
        mk1, mt1 = mk.sort().values, torch.zeros_like(mt)
        yard = torch.searchsorted(mk1, key, right=True)
        one = kops.owner_rank(zeros, key, mt1, mk1)
        if not torch.equal(one.long(), (yard - 1).clamp(min=0)):
            raise AssertionError(f"3p P={P}: owner_rank in one tree differs from searchsorted")
        ys_ms = device_ms(lambda: torch.searchsorted(mk1, key, right=True))
        one_ms = device_ms(lambda: kops.owner_rank(zeros, key, mt1, mk1))
        rows[-2].update({"one_tree_device_ms": one_ms, "searchsorted_ms": ys_ms})
        print(f"  3p yardstick P={P:>6}, one tree: torch.searchsorted {ys_ms:.4f} ms, owner_rank "
              f"kernel {one_ms:.4f} ms on the same problem (== searchsorted - 1, clamped)",
              flush=True)
        del own, yard, one
    print(f"  3p: every leaf's owner is its part, brackets hold on every leaf and routed pair, "
          f"== plain on {idx.numel()} sampled leaves, at P = {SPLIT_MARKERS}", flush=True)
    torch.cuda.empty_cache()
    return rows


def hex_kernel_vs_plain(d: int, n: int, device, reps: int = 50,
                        plain_reps: int = 5) -> tuple[list[dict], list[dict]]:
    """Phase 2h for one dimension: each hex body against its plain version
    on the same tensors, exact; returns one timing row per kernel, and the
    rows of eval_route's P sweep."""
    from repro_torch.core.tables import MAXLEVEL

    L = MAXLEVEL[d]
    cases = hex_kernel_cases(d, n, device)
    key, level = cases["decode"][0]
    if torch.unique(level).numel() != L + 1:
        raise AssertionError(f"hex d={d}: inputs miss a level")
    unset = [b for b in range(64) if bool(((key >> b) & 1).any()) != (b < d * L)]
    if unset:
        raise AssertionError(f"hex d={d}: key bits {unset} not as wanted")
    rows = []
    for name, (inputs, kernel, plain) in cases.items():
        got, want, err = compare_exact(f"hex {name} d={d}", kernel, plain)
        cover = ""
        if name in ("face_sweep", "inside_root"):
            inside = want[3] if name == "face_sweep" else want[0]
            share = float(inside.float().mean())
            if not 0 < share < 1:
                raise AssertionError(f"hex {name} d={d}: inside share {share}")
            cover = f"; inside share {share:.3f}"
            if name == "face_sweep":
                if want[0].shape[0] != 2 * d or bool(want[1].any()):
                    raise AssertionError(f"hex face_sweep d={d}: {want[0].shape[0]} planes")
                cover += f"; {2 * d} face planes, types all 0"
        elif name == "eval_route":
            owners = torch.unique(torch.cat([want[1].flatten(), want[2].flatten()])).tolist()
            if owners != [0, 2, 3] or want[0].shape[0] != 2 * d:
                raise AssertionError(f"hex eval_route d={d}: owners {owners}, "
                                     f"{want[0].shape[0]} planes")
            cover = f"; nf = {2 * d} planes, owners {owners} (rank 1 empty)"
        elif name == "successor":
            last = torch.arange(n, device=device) % 8 == 2
            lv = torch.unique(inputs[1][last]).numel()
            if lv != L + 1 or bool(want[0][last].any()):
                raise AssertionError(f"hex successor d={d}: the last elements do not wrap")
            cover = f"; the last element of each of {lv} levels wraps to element 0"
        elif name == "face_neighbor":
            faces = torch.unique(inputs[2]).numel()
            if faces != 2 * d or not torch.equal(want[2], inputs[2] ^ 1):
                raise AssertionError(f"hex face_neighbor d={d}: {faces} faces")
            cover = f"; all {faces} faces, dual f ^ 1"
        elif name == "tree_transform":
            conn, x_anchor, lvl, dual, table = inputs
            _t, Ms, cs = hex_transform_connections(d, x_anchor.device)
            M, c = Ms[conn.long()], cs[conn.long()]
            reflected = int((M.clamp(max=0).sum((1, 2)) < 0).sum())
            permuted = int((M.diagonal(dim1=1, dim2=2) == 0).any(1).sum())
            rows_used = torch.unique(conn).numel()
            duals = torch.unique(dual).numel()
            del M, c
            if rows_used != table.shape[0] or duals != 2 * d or not reflected or not permuted:
                raise AssertionError(f"hex tree_transform d={d}: {rows_used} rows, {duals} "
                                     f"faces, {reflected} reflected, {permuted} permuted")
            cover = (f"; {table.shape[0]} connections ({table.shape[0] - 2} glued faces of a "
                     f"periodic hex brick), all {duals} dual faces, {reflected} crossings "
                     f"with a reflected axis, {permuted} with a permuted one")
        rows.append(timing_row(name, d, n, inputs, got, kernel, plain, err, cover, reps,
                               plain_reps, tag="hex "))
    sweep = marker_sweep(d, cases, tag="hex ")
    del cases
    torch.cuda.empty_cache()
    return rows, sweep


def kernel_vs_plain(d: int, n: int, device, reps: int = 50,
                    plain_reps: int = 5) -> tuple[list[dict], list[dict]]:
    """Phase 2 for one dimension: every kernel against its plain version on
    the same tensors, exact; returns one timing row per kernel, and the
    rows of eval_route's and owner_rank's P sweep."""
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
        got, want, err = compare_exact(f"{name} d={d}", kernel, plain)
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
        elif name == "successor":
            # every eighth input (from the second on) is its level's last element
            last = torch.arange(n, device=device) % 8 == 2
            lv = torch.unique(inputs[1][last]).numel()
            if lv != L + 1 or bool(want[0][last].any()) or bool(want[1][last].any()):
                raise AssertionError(f"successor d={d}: last elements over {lv} levels, their "
                                     "successors not all element 0")
            cover = (f"; the last element of each of {lv} levels wraps to element 0"
                     + successor_every_class(d, n, device))
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
        rows.append(timing_row(name, d, n, inputs, got, kernel, plain, err, cover, reps,
                               plain_reps))
    sweep = marker_sweep(d, cases)
    del cases
    torch.cuda.empty_cache()
    return rows, sweep


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


def parity_fractal_count(d: int, trees: int, k: int, max_level: int) -> int:
    """Leaves of the hex parity fractal (`fractal_cb` on hex trees):
    `trees` roots refined uniformly to level k, then every hex whose cube id
    at its own level has an even number of set bits — 2^(d-1) of the 2^d
    children of a parent — refined again until `max_level`."""
    c, leaves = trees << (d * k), 0
    for _ in range(k, max_level):
        leaves += c // 2
        c = (c // 2) << d
    return leaves + c


def eclass_of_batch(cmesh, tree) -> int:
    """The element class of a batch of one class (Adapt hands each class
    group to a callback on its own), from its trees."""
    if cmesh is None or not tree.numel():
        return 0
    return int(cmesh.eclass_table(tree.device)[tree[0].long()])


def fractal_cb(d: int, max_level: int, cmesh=None):
    """The refinement rule of the fractal below `max_level`: a simplex of a
    type in `refine_types`; a hex whose cube id at its own level has an
    even number of set bits (the parity fractal)."""
    types = refine_types(d)

    def cb(tree, e):
        if eclass_of_batch(cmesh, tree) == ECLASS_HEX:
            L = {2: 30, 3: 21}[d]
            bits = torch.bitwise_right_shift(e.anchor, (L - e.level)[:, None]) & 1
            hit = (bits.sum(1) & 1) == 0
        else:
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


def tree_faces_cb(deep: int, cmesh=None):
    """Refine, below level `deep`, every element of tree 0 with a face on
    the tree's root boundary (a face neighbor outside the root, by the
    port's `face_sweep` of the tree's class): a layer of fine elements along
    all of tree 0's faces, each glued to another tree or on the domain
    boundary, against the coarser leaves across them."""
    from repro_torch.core.batch import get_batch_ops

    def cb(tree, e):
        b = get_batch_ops(e.anchor.shape[1], eclass_of_batch(cmesh, tree))
        on_face = ~b.face_sweep(e).inside.all(0)
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
    of those leaves): after the tree-faces Adapt to level `deep`, the nf
    root faces (d + 1 of a simplex, 2d of a hex) are tiled by
    nf * 2^((d-1) deep) faces of level-`deep` leaves.  A check, run after
    the path's launch counts are read."""
    from repro_torch.core.batch import get_batch_ops
    from repro_torch.core.types import Simplex

    tiles, levels = 0, set()
    for f in fs:
        sel = torch.nonzero(f.tree == 0).squeeze(1)
        if not sel.numel():
            continue
        s = Simplex(f.anchor[sel], f.level[sel], f.stype[sel])
        b = get_batch_ops(f.d, eclass_of_batch(f.cmesh, f.tree[sel]))
        out = ~b.face_sweep(s).inside
        tiles += int(out.sum())
        levels |= set(torch.unique(s.level[out.any(0)]).tolist())
    return tiles, sorted(levels)


def run_path(d: int, num_trees: int, level: int, max_level: int, P: int, device,
             report: bool = False, cmesh=None, tree_faces: int | None = None,
             keep_unbalanced: bool = False, comm=None) -> tuple[list, list, object, dict]:
    """New -> fractal Adapt -> coarsening Adapt (trees num_trees/2 and up)
    -> Partition -> weighted repartition -> [tree 0's faces refined to
    level `tree_faces`] -> Balance -> Ghost -> validate on `comm` (a world
    of P ranks in this process; SimComm(P) by default), over `cmesh` when
    given.  With `keep_unbalanced`, the forests Balance started from stay in
    facts["unbalanced"].  Returns (forests, ghosts, comm, facts)."""
    from repro_torch.core import forest as F

    comm = F.SimComm(P) if comm is None else comm
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
    fs = step("adapt fractal", [F.adapt(f, fractal_cb(d, max_level, cmesh), recursive=True)
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
        fs = step("adapt tree faces", [F.adapt(f, tree_faces_cb(tree_faces, cmesh),
                                               recursive=True) for f in fs])
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


def main_path(path: tuple = PATH3,
              min_migrated: int = 9_000_000) -> tuple[dict, list, object, list]:
    """Phase 3 (and, with PATH3T, phase 3t): the full-size run on the card,
    its counts held to `fractal_count`, at least `min_migrated` elements
    moved by Partition; Balance refines where the fractal spans two levels
    or more, and changes nothing where it spans one (phase 3t: its leaves
    are a level apart at most, already 2:1).  Returns (facts, with the
    forests Balance started from under "unbalanced"; the balanced forests;
    the communicator; their ghosts)."""
    (d, trees, level, max_level), P = path, MULTI_P
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
                                   report=True, keep_unbalanced=True)
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
    if comm.bytes_for("partition") < min_migrated * WIRE_TRIPLE_BYTES:
        raise AssertionError(f"partition moved only {comm.bytes_for('partition')} B")
    if facts["weighted_imbalance_after"] > 1.001:
        raise AssertionError(f"weighted imbalance {facts['weighted_imbalance_after']} "
                             "after repartition")
    before, after = (sum(facts["per_rank"][k]) for k in ("repartition weighted", "balance"))
    if max_level - level >= 2 and (after <= before or facts["balance_evals"] < 2):
        raise AssertionError(f"balance refined nothing: {before} -> {after} elements")
    if max_level - level < 2 and after != before:     # leaves a level apart are 2:1 already
        raise AssertionError(f"balance refined a 2:1 forest: {before} -> {after} elements")
    if not all(facts["per_rank"]["ghost"]) or not comm.bytes_for("ghost"):
        raise AssertionError(f"an empty ghost layer: {facts['per_rank']['ghost']}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  counts {want['new_uniform']:,} -> {want['adapt fractal']:,} -> "
          f"{want['adapt coarsen']:,} as the transfer matrix of the port's tables says; "
          f"per rank before partition {want_rank}", flush=True)
    print(f"  partition migrated {moved:,} elements ({part['alltoallv_bytes']:,} B of wire "
          f"triples); load_imbalance {facts['imbalance_before']} -> "
          f"{facts['imbalance_after']}; weighted (1 + (level == {max_level})) "
          f"{facts['weighted_imbalance_before']} -> {facts['weighted_imbalance_after']}",
          flush=True)
    print(f"  balance: {before:,} -> {after:,} elements, per rank "
          f"{facts['per_rank']['balance']}, "
          f"{facts['balance_evals']} evaluation rounds ({facts['balance_evals'] - 1} refining); "
          f"bytes_for balance {comm.bytes_for('balance'):,} B, ghost "
          f"{comm.bytes_for('ghost'):,} B; ghosts per rank {facts['per_rank']['ghost']}; "
          f"validate(forests, ghosts) True", flush=True)
    print(f"  bytes_for per phase {facts['bytes']}; counters {comm.counters}", flush=True)
    print(f"  wall {wall:.3f} s; peak device memory {peak:,} B ({peak / 2**30:.3f} GiB)",
          flush=True)
    facts["peak_bytes"] = peak
    torch.cuda.empty_cache()
    return facts, fs, comm, gh


def d2_path(kops, kref) -> tuple[dict, dict, dict, dict]:
    """Phase 3t: the d = 2 main path at full size (PATH3T on SimComm(4):
    New at level 10, the fractal to level 11, coarsening trees 4-7,
    Partition, the weighted repartition, Balance, Ghost, validate), its
    counts held to `fractal_count`; counted (every count set to 0 just
    before it and read just after), its launch sizes recorded.  Then,
    outside the counted run, on every leaf: morton_key equal to its plain
    version and to the stored key, and decode(key, level) giving back
    (anchor, type), exactly.  Returns (facts, launches, plain calls, launch
    sizes)."""
    sizes, originals = record_launch_sizes(kops)
    (facts, fs, _comm, gh), launches, plain_calls, _cls = counted(
        kops, kref, lambda: main_path(PATH3T, MIGRATED3T))
    for name, fn in originals.items():
        setattr(kops, name, fn)
    del gh, facts["unbalanced"]
    n = 0
    for f in fs:
        key = kops.morton_key(f.anchor, f.stype)
        if not (torch.equal(key, kref.morton_key(f.anchor, f.stype)) and torch.equal(key, f.keys)):
            raise AssertionError("phase 3t: morton_key differs from its plain version or the "
                                 "stored keys")
        anchor, stype = kops.decode(f.d, key, f.level)
        if not (torch.equal(anchor, f.anchor) and torch.equal(stype, f.stype)):
            raise AssertionError("phase 3t: decode(key, level) does not give back the leaves")
        n += f.num_local
    print(f"  on all {n:,} leaves: morton_key == its plain version == the stored keys, and "
          "decode(key, level) == (anchor, type), exactly", flush=True)
    del fs
    torch.cuda.empty_cache()
    return facts, launches, plain_calls, sizes


def walk_sweep(smi: str) -> int:
    """`--walk-sweep`: the WALK_ROWS kernels, simplex and hex bodies, timed
    as phase 2 times them (N = 2^22, d = 3 and 2, exact against the plain
    versions first), and the simplex bodies at the sizes phase 3 and its
    queries (d = 3) and phase 3t (d = 2; successor is not launched there)
    launch them, as phase 3b times them; the rows as one JSON line.  Run from
    a checkout of another commit (this file copied in), it measures that
    commit's kernels with the same code."""
    from repro_torch.kernels import ops as kops

    dev = torch.device("cuda")
    rows = []
    for d in (3, 2):
        for tag, make in (("", kernel_cases), ("hex ", hex_kernel_cases)):
            cases = make(d, N_KERNEL, dev)
            for name in WALK_ROWS:
                inputs, kernel, plain = cases[name]
                got, _want, err = compare_exact(f"{tag}{name} d={d}", kernel, plain)
                row = timing_row(name, d, N_KERNEL, inputs, got, kernel, plain, err, "", 50, 1,
                                 tag=tag)
                rows.append({**row, "class": tag.strip() or "simplex", "at": "phase 2"})
            del cases
            torch.cuda.empty_cache()
    sizes3, originals = record_launch_sizes(kops)
    _facts, fs, comm, _gh = main_path()
    element_queries(fs, comm)
    for name, fn in originals.items():
        setattr(kops, name, fn)
    del _facts, fs, comm, _gh
    torch.cuda.empty_cache()
    sizes3t, originals = record_launch_sizes(kops)
    main_path(PATH3T, MIGRATED3T)
    for name, fn in originals.items():
        setattr(kops, name, fn)
    torch.cuda.empty_cache()
    for d, at, sz, names in ((3, "phase 3", sizes3, WALK_ROWS),
                             (2, "phase 3t", sizes3t, WALK_ROWS[:3])):
        print(f"== walk rows at the sizes {at} launched them (card {smi})", flush=True)
        for name, pts in time_at_launch_sizes({k: sz[k] for k in names}, d).items():
            rows += [{**x, "name": name, "d": d, "class": "simplex", "at": at} for x in pts]
    print(json.dumps({"walk_sweep": rows, "card": smi}))
    return 0


def walk_compare(parent: Path, smi: str) -> int:
    """`--walk-sweep PARENT`: `--walk-sweep` run four times in fresh
    processes, from PARENT (a checkout of the parent commit with this file
    copied in), from here, here and PARENT again, on one card; prints each
    row's device times, parent against change, and one JSON line of all
    the runs."""
    runs = []
    for label, root in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        t = time.perf_counter()
        out = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--walk-sweep"],
                             capture_output=True, text=True, timeout=1500)
        if out.returncode:
            print(out.stdout[-3000:], out.stderr[-3000:], sep="\n", file=sys.stderr)
            raise AssertionError(f"--walk-sweep from {root} exited {out.returncode}")
        runs.append((label, json.loads(out.stdout.strip().splitlines()[-1])["walk_sweep"]))
        print(f"  --walk-sweep, {label} ({root}): {time.perf_counter() - t:.1f} s", flush=True)
    print(f"== walk rows, device ms: parent (two runs) -> change (two runs) (card {smi})",
          flush=True)
    table = {}
    for label, rows in runs:
        for r in rows:
            key = (r["class"], r["name"], r["d"], r["at"], r["n"])
            table.setdefault(key, {"parent": [], "change": [], "bound_ms": r["bound_ms"]})
            table[key][label].append(r["device_ms"])
    for (cls, name, d, at, n), v in table.items():
        p, c = np.mean(v["parent"]), np.mean(v["change"])
        print(f"  {cls:7s} {name:10s} d={d} {at:8s} n={n:>9,}: "
              f"{' / '.join(f'{x:.4f}' for x in v['parent'])} -> "
              f"{' / '.join(f'{x:.4f}' for x in v['change'])} ms ({c / p:.3f} x the parent); "
              f"bound {v['bound_ms']:.4f} ms, {v['bound_ms'] / c:.1%} of it after, "
              f"{v['bound_ms'] / p:.1%} before", flush=True)
    print(json.dumps({"walk_compare": [{"run": label, "rows": rows} for label, rows in runs],
                      "card": smi}))
    return 0


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
        for face in range(b.nf):
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
          f"face_neighbor(s, f) == plane f of face_sweep(s), f = 0..{b.nf - 1}", flush=True)
    print("  wall (s, summed over ranks): " + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()),
          flush=True)
    return walls


def face_neighbor_vs_plain(f, kops, kref) -> None:
    """Phase 3d's independent check of `face_neighbor`: one rank's leaves,
    every face, against the plain version (`face_sweep` runs the kernel's
    own per-face step, so plane f of the sweep cannot catch a fault in
    it).  Run outside the counted phase-3d run."""
    fc = torch.empty_like(f.level)
    ec, nf = f.eclass, f.ops.nf
    for face in range(nf):
        fc.fill_(face)
        got = kops.face_neighbor(f.anchor, f.level, f.stype, fc, ec)
        want = kref.face_neighbor(f.anchor, f.level, f.stype, fc, ec)
        if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
            raise AssertionError(f"rank {f.rank}: face_neighbor({face}) differs from "
                                 "its plain version")
    print(f"  face_neighbor of rank {f.rank}'s {f.num_local:,} leaves, f = 0..{nf - 1}, "
          "equals its plain version", flush=True)


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


def cmesh_path() -> tuple[dict, list, list, list, object]:
    """Phase 3c: the coarse-mesh path at full size on the card.  Returns
    (facts, the forests Balance started from, the balanced forests, their
    ghosts, the coarse mesh) for `check_level_jumps`, which runs after the
    launch counts are read, and for phases 3o, 3k and 3i."""
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
    print(f"  balance: {before:,} -> {after:,} elements, per rank "
          f"{facts['per_rank']['balance']}, "
          f"{facts['balance_evals']} evaluation rounds; ghosts per rank "
          f"{facts['per_rank']['ghost']}; validate(forests, ghosts) True", flush=True)
    print(f"  bytes_for per phase {facts['bytes']}", flush=True)
    print(f"  wall {wall:.3f} s; peak device memory {peak:,} B ({peak / 2**30:.3f} GiB)",
          flush=True)
    facts["peak_bytes"] = peak
    return facts, facts.pop("unbalanced"), fs, gh, cm


def hex_path() -> tuple[dict, list, list, object, list, object]:
    """Phase 3h: the hex path at full size on the card: the 8 hex trees of
    cmesh_hex_brick(3, (2, 2, 2), periodic=(True, True, False)) on
    SimComm(4), New at level 6, the parity fractal to level 8, trees 4-7
    coarsened, Partition (more than 5 M hexes migrating), the weighted
    repartition, tree 0's faces to level 9, Balance, Ghost, validate.
    Returns (facts, the forests Balance started from, the
    balanced forests, the communicator, their ghosts, the coarse mesh) for
    `check_level_jumps` and the queries, which run after the launch counts
    are read, and for phases 3o, 3k and 3i."""
    from repro_torch.core.cmesh import cmesh_hex_brick

    cm = cmesh_hex_brick(3, (2, 2, 2), periodic=(True, True, False))
    glued = int((cm.face_tree >= 0).sum())
    if cm.num_trees != 8 or glued != 40 or cm.face_tree.size != 48:
        raise AssertionError(f"hex brick: {cm.num_trees} trees, {glued} of "
                             f"{cm.face_tree.size} tree faces glued; want 8 and 40 of 48")
    print(f"  mesh: cmesh_hex_brick(3, (2, 2, 2), periodic=(True, True, False)): "
          f"{cm.num_trees} hex trees, {glued} of {cm.face_tree.size} tree faces glued, "
          "the 8 outer z faces domain boundary", flush=True)
    d, trees, level, max_level, deep, P = 3, 8, 6, 8, TREE_FACES_LEVEL, 4
    half = trees // 2
    fine = parity_fractal_count(d, 1, level, max_level)
    coarse = parity_fractal_count(d, 1, level, max_level - 1)
    want_rank = [2 * fine] * 2 + [2 * coarse] * 2
    want = {"new_uniform": trees << (d * level),
            "adapt fractal": parity_fractal_count(d, trees, level, max_level),
            "adapt coarsen": half * fine + half * coarse}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fs, gh, comm, facts = run_path(d, trees, level, max_level, P, torch.device("cuda"),
                                   report=True, cmesh=cm, tree_faces=deep, keep_unbalanced=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for k, v in want.items():
        if sum(facts["per_rank"][k]) != v:
            raise AssertionError(f"3h {k}: {sum(facts['per_rank'][k])} hexes, want {v}")
    if facts["per_rank"]["adapt coarsen"] != want_rank:
        raise AssertionError(f"3h per-rank counts after coarsening "
                             f"{facts['per_rank']['adapt coarsen']}, want {want_rank}")
    moved = migrated(facts["per_rank"]["adapt coarsen"], facts["per_rank"]["partition"])
    part = comm.counters["partition"]
    if part["alltoallv_bytes"] != moved * WIRE_TRIPLE_BYTES or moved <= 5_000_000:
        raise AssertionError(f"3h partition moved {moved} hexes in {part['alltoallv_bytes']} B")
    if facts["weighted_imbalance_after"] > 1.001:
        raise AssertionError(f"3h weighted imbalance {facts['weighted_imbalance_after']}")
    layered, before, after = (sum(facts["per_rank"][k]) for k in
                              ("adapt coarsen", "adapt tree faces", "balance"))
    if before <= layered or after <= before or facts["balance_evals"] < 3:
        raise AssertionError(f"3h: tree faces {layered} -> {before}, balance {before} -> "
                             f"{after} in {facts['balance_evals']} evaluation rounds; want "
                             "refinement in at least 2 rounds")
    if not all(facts["per_rank"]["ghost"]):
        raise AssertionError(f"3h an empty ghost layer: {facts['per_rank']['ghost']}")
    print(f"  counts {want['new_uniform']:,} -> {want['adapt fractal']:,} -> "
          f"{want['adapt coarsen']:,} as the parity fractal's closed form says; per rank "
          f"before partition {want_rank}; tree 0's faces to level {deep}: {before:,}",
          flush=True)
    print(f"  partition migrated {moved:,} hexes ({part['alltoallv_bytes']:,} B of wire "
          f"triples); load_imbalance {facts['imbalance_before']} -> {facts['imbalance_after']}"
          f"; weighted {facts['weighted_imbalance_before']} -> "
          f"{facts['weighted_imbalance_after']}", flush=True)
    print(f"  balance: {before:,} -> {after:,} hexes, per rank {facts['per_rank']['balance']}, "
          f"{facts['balance_evals']} evaluation rounds ({facts['balance_evals'] - 1} refining); "
          f"ghosts per rank {facts['per_rank']['ghost']}; validate(forests, ghosts) True",
          flush=True)
    print(f"  bytes_for per phase {facts['bytes']}", flush=True)
    print(f"  wall {wall:.3f} s; peak device memory {peak:,} B ({peak / 2**30:.3f} GiB)",
          flush=True)
    facts["peak_bytes"] = peak
    return facts, facts.pop("unbalanced"), fs, comm, gh, cm


def check_level_jumps(unbalanced: list, balanced: list, deep: int) -> None:
    """Phase 3c's and 3h's check that Balance refined across tree faces: element
    faces with a leaf more than one level finer in their neighbor region,
    interior and inter-tree, before Balance (at least
    `MIN_INTER_TREE_JUMPS` inter-tree ones, along tree 0's faces) and after
    it (none of either); and that tree 0's root faces were tiled at level
    `deep` before it."""
    d = unbalanced[0].d
    nf = next(f for f in unbalanced if f.num_local).ops.nf
    tiles, levels = tree0_face_tiles(unbalanced)
    print(f"  tree 0's {nf} root faces: {tiles:,} faces of leaves of levels {levels}",
          flush=True)
    if tiles != nf << ((d - 1) * deep) or levels != [deep]:
        raise AssertionError(f"want tree 0's root faces tiled by "
                             f"{nf << ((d - 1) * deep)} faces of level-{deep} leaves")
    jb, ja = level_jumps(unbalanced), level_jumps(balanced)
    print(f"  element faces whose neighbor region holds a leaf more than one level "
          f"finer: before Balance {jb}, after it {ja}", flush=True)
    if jb["inter_tree"] < MIN_INTER_TREE_JUMPS or any(ja.values()):
        raise AssertionError(f"want at least {MIN_INTER_TREE_JUMPS} inter-tree level "
                             "jumps before Balance and none of either kind after")
    torch.cuda.empty_cache()


def forest_extras(unbalanced: list, P: int) -> dict:
    """Phase 4's products of the oracles, Iterate and checkpoints on one
    device: `balance_oracle` of the forests Balance started from,
    `ghost_oracle` of its result, and their byte counters; `iterate`'s pair
    tensor on every rank; the bytes of every file `save_forest` writes."""
    from repro_torch.checkpoint import save_forest
    from repro_torch.core import forest as F

    comm = F.SimComm(P)
    ob = F.balance_oracle(unbalanced, comm)
    og = F.ghost_oracle(ob, comm)
    pairs = [F.iterate(f, face_fn=lambda ff, p: p)[0] for f in ob]
    with tempfile.TemporaryDirectory() as tmp:
        step = save_forest(tmp, ob, comm)
        files = {p.name: p.read_bytes() for p in sorted(step.iterdir())}
    return {"forests": ob, "ghosts": og, "pairs": pairs, "files": files,
            "counters": comm.counters}


def same_on_card_and_cpu(label: str, d: int, trees: int, P: int, cmesh=None,
                         tree_faces: int | None = None) -> None:
    """The pipeline at small size (level 1 -> 3, tree 0's faces then to
    level `tree_faces` when given) on the card and on the CPU: every forest
    and ghost field, and every per-phase byte count, identical; and so the
    global-table oracles' forests, layers and bytes, Iterate's pairs on
    every rank and the bytes `save_forest` writes (`forest_extras`)."""
    (fg, gg, cg, ng), (fc, gc, cc, nc) = [
        run_path(d, trees, 1, 3, P, torch.device(dev), cmesh=cmesh,
                 tree_faces=tree_faces, keep_unbalanced=True)
        for dev in ("cuda", "cpu")]
    xg, xc = forest_extras(ng.pop("unbalanced"), P), forest_extras(nc.pop("unbalanced"), P)
    assert_same_forests(f"{label}: balance_oracle card vs CPU", xg["forests"], xc["forests"])
    assert_same_forests(f"{label}: balance_oracle vs balance", xg["forests"], fg)
    assert_same_ghosts(f"{label}: ghost_oracle card vs CPU", xg["ghosts"], xc["ghosts"])
    if xg["counters"] != xc["counters"] or xg["files"] != xc["files"]:
        raise AssertionError(f"{label}: oracle bytes or checkpoint files differ card vs CPU")
    for a, b in zip(xg["pairs"], xc["pairs"], strict=True):
        if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
            raise AssertionError(f"{label}: iterate's pairs differ card vs CPU")
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
          f"forest and ghost field for field; bytes_for {ng['bytes']} equal; oracles "
          f"({ {k: v['allgather_bytes'] for k, v in xg['counters'].items()} } B), "
          f"{sum(p.shape[0] for p in xg['pairs'])} iterate pairs and "
          f"{sum(len(v) for v in xg['files'].values()):,} B of checkpoint files equal",
          flush=True)


def card_vs_cpu() -> None:
    """Phase 4: the pipeline at small size on both devices, without a
    coarse mesh (d = 3 and 2, 8 trees) and over one (the 48-tree brick of
    phase 3c, a periodic 2 x 2 brick of 8 triangles, the rotated pair, a
    periodic 2 x 2 hex brick, a 2 x 2 x 1 hex brick, and the hybrid pair of
    a hex and a Kuhn cube at d = 2 and 3 on 2 and 3 ranks)."""
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
    hex2 = C.cmesh_hex_brick(2, (2, 2), periodic=(True, True))
    hex3 = C.cmesh_hex_brick(3, (2, 2, 1))
    same_on_card_and_cpu("d=2 periodic hex brick (4 trees)", 2, hex2.num_trees, 4, cmesh=hex2,
                         tree_faces=5)
    same_on_card_and_cpu("d=3 hex brick (4 trees)", 3, hex3.num_trees, 4, cmesh=hex3,
                         tree_faces=4)
    for d in (2, 3):
        pair = C.cmesh_hybrid_pair(d)
        for P in (2, 3):
            same_on_card_and_cpu(f"d={d} hybrid pair ({pair.num_trees} trees)", d,
                                 pair.num_trees, P, cmesh=pair, tree_faces=d + 2)


def counted(kops, kref, run) -> tuple[object, dict, dict, dict]:
    """(run()'s result, its kernel launches, its plain-version calls, its
    launches per kernel and element class), every count set to 0 just
    before the run and read just after it."""
    kops.reset_launch_counts()
    kref.reset_call_counts()
    out = run()
    return (out, dict(kops.launch_counts), dict(kref.call_counts),
            {k: dict(v) for k, v in kops.class_launch_counts.items()})


def hybrid_face_sweeps(kops) -> None:
    """Phase 5: over the hybrid pair (a hex tree beside a Kuhn cube) on the
    card, Balance and then Ghost launch `face_sweep` and `eval_route` once
    per class per eval layer: the mixed run's launches of each class equal
    those of the class groups run through the one-class functions directly."""
    from repro_torch.core import cmesh as C, forest as F

    names = ("face_sweep", "eval_route")

    def meter(fn):
        kops.reset_launch_counts()
        out = fn()
        sync()
        return out, {k: dict(kops.class_launch_counts[k]) for k in names}

    for d in (2, 3):
        cm = C.cmesh_hybrid_pair(d)
        comm = F.SimComm(2)
        fs = F.new_uniform(d, cm.num_trees, 1, comm, cmesh=cm, device=torch.device("cuda"))
        fs = F.partition([F.adapt(f, fractal_cb(d, 4, cm), recursive=True) for f in fs], comm)
        bal, mixed_b = meter(lambda: F.balance(fs, comm))
        _g, mixed_g = meter(lambda: F.ghost(bal, comm))
        per_b = {k: dict.fromkeys(("simplex", "hex"), 0) for k in names}
        per_g = {k: dict.fromkeys(("simplex", "hex"), 0) for k in names}
        for ec in cm.eclasses:
            _b, c = meter(lambda: F._balance_impl(F._class_subforests(fs, ec), comm, 64, True, ec))
            _gg, cg = meter(lambda: F._ghost_impl(F._class_subforests(bal, ec), comm, True, ec))
            for k in names:
                for cls in per_b[k]:
                    per_b[k][cls] += c[k][cls]
                    per_g[k][cls] += cg[k][cls]
        both = all(v > 0 for k in names for v in mixed_b[k].values())
        if mixed_b != per_b or mixed_g != per_g or not both:
            raise AssertionError(f"hybrid d={d}: balance launches {mixed_b} vs per class "
                                 f"{per_b}; ghost {mixed_g} vs {per_g}")
        print(f"  hybrid pair d={d}: balance launches {mixed_b}, ghost {mixed_g}: equal to "
              "the class groups' own runs (one launch per class per eval layer)", flush=True)


# ------------------------------ 3o, 3k, 3i: oracles, checkpoints, Iterate
FOREST_FIELDS = ("anchor", "level", "stype", "tree", "keys")
GHOST_FIELDS = ("anchor", "level", "stype", "tree", "owner")
# At rest (paper Remark 20): int32 coordinates, an int8 level and, for a
# simplex, an int8 type, so 14 B a tetrahedron and 13 a hexahedron.
AT_REST_BYTES = {"simplex": 14, "hex": 13}


def assert_same_forests(label: str, got: list, want: list) -> None:
    """Two lists of forests equal rank for rank and field for field (the
    second's tensors moved to the first's device)."""
    for a, b in zip(got, want, strict=True):
        if (a.rank, a.num_ranks) != (b.rank, b.num_ranks):
            raise AssertionError(f"{label}: rank {a.rank}/{a.num_ranks} vs {b.rank}/{b.num_ranks}")
        for k in FOREST_FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            if x.dtype != y.dtype or not torch.equal(x, y.to(x.device)):
                raise AssertionError(f"{label}: rank {a.rank}'s {k} differs")


def assert_same_ghosts(label: str, got: list, want: list) -> None:
    for r, (a, b) in enumerate(zip(got, want, strict=True)):
        for k in GHOST_FIELDS:
            if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k].to(a[k].device)):
                raise AssertionError(f"{label}: rank {r}'s ghost {k} differs")


def oracles(label: str, unbalanced: list, balanced: list, ghosts: list, P: int,
            message_bytes: dict) -> dict:
    """Phase 3o on one full-size phase's forests: `balance_oracle` of the
    forests Balance started from must equal the balanced forests on every
    rank, and `ghost_oracle` of the balanced forests the message-based
    Ghost's layers; the wall of each (host clock, ending in a synchronize),
    the oracle's rounds, and its bytes beside the message-based phase's."""
    from repro_torch.core import forest as F

    comm = F.SimComm(P)
    sync()
    t = time.perf_counter()
    ob = F.balance_oracle(unbalanced, comm)
    sync()
    wb = time.perf_counter() - t
    assert_same_forests(f"3o {label}: balance_oracle vs balance", ob, balanced)
    del ob
    t = time.perf_counter()
    og = F.ghost_oracle(balanced, comm)
    sync()
    wg = time.perf_counter() - t
    assert_same_ghosts(f"3o {label}: ghost_oracle vs ghost", og, ghosts)
    del og
    rounds = comm.counters["balance_oracle"]["allgather_calls"] // 2   # table + changed
    ob_bytes, og_bytes = comm.bytes_for("balance_oracle"), comm.bytes_for("ghost_oracle")
    print(f"  {label}: balance_oracle == balance on every rank ({F.count_global(unbalanced):,} -> "
          f"{F.count_global(balanced):,}) in {rounds} rounds, {wb:.3f} s; ghost_oracle == "
          f"ghost field for field ({sum(len(g['level']) for g in ghosts):,} entries), "
          f"{wg:.3f} s", flush=True)
    print(f"  {label}: bytes_for balance_oracle {ob_bytes:,} B against balance "
          f"{message_bytes['balance']:,} B ({ob_bytes / message_bytes['balance']:.1f} times); "
          f"ghost_oracle {og_bytes:,} B against ghost {message_bytes['ghost']:,} B "
          f"({og_bytes / message_bytes['ghost']:.1f} times)", flush=True)
    return {"balance_oracle_s": wb, "ghost_oracle_s": wg, "rounds": rounds,
            "bytes": {"balance_oracle": ob_bytes, "ghost_oracle": og_bytes, **message_bytes}}


def checkpoints(label: str, balanced: list, P: int, cmesh, max_level: int,
                eclass: str) -> tuple[dict, list]:
    """Phase 3k on one full-size phase's balanced forests, in a temporary
    directory: `save_forest` (its wall, bytes on disk, at-rest bytes an
    element, exactly `AT_REST_BYTES[eclass]`); `load_forest` onto the
    card at the saved rank count equal to the saved forests with the same
    partition markers; onto 1 and 3 ranks the same global sequence, valid,
    per-rank counts within 1; with weights 1 + (level == max_level) equal
    to `repartition` with them; one byte flipped in the anchor column
    refused.  Returns (facts, the one-rank restore)."""
    from repro_torch.checkpoint import load_forest, save_forest
    from repro_torch.core import forest as F
    from repro_torch.core.errors import CheckpointIntegrityError

    n = F.count_global(balanced)
    facts = {"load_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        sync()
        t = time.perf_counter()
        step = save_forest(tmp, balanced, F.SimComm(P))
        facts["save_s"] = time.perf_counter() - t
        facts["disk_bytes"] = sum(p.stat().st_size for p in step.iterdir())
        manifest = json.loads((step / "manifest.json").read_text())
        names = sorted(manifest["meta"]["crc32"])         # the leaves' order
        leaves = dict(zip(names, manifest["leaves"], strict=True))
        rest = sum(math.prod(leaves[k]["shape"]) * np.dtype(leaves[k]["dtype"]).itemsize
                   for k in ("anchor", "level", "stype") if k in leaves)
        facts["at_rest_per_element"] = rest / n
        if rest != AT_REST_BYTES[eclass] * n:
            raise AssertionError(f"3k {label}: {rest} B at rest for {n} elements, want "
                                 f"{AT_REST_BYTES[eclass]} B an element")

        def load(ranks: int, name: str, **kw):
            sync()
            t = time.perf_counter()
            out = load_forest(tmp, F.SimComm(ranks), cmesh=cmesh, **kw)
            sync()
            facts["load_s"][name] = time.perf_counter() - t
            return out

        exact = load(P, f"exact P={P}")
        assert_same_forests(f"3k {label}: exact restore", exact, balanced)
        marks = [F.partition_markers(fs, F.SimComm(P)) for fs in (exact, balanced)]
        if not all(np.array_equal(a, b) for a, b in zip(*marks, strict=True)):
            raise AssertionError(f"3k {label}: the restore's partition markers differ")
        del exact
        want_t, want_k = (torch.cat([getattr(f, k) for f in balanced]) for k in ("tree", "keys"))
        elastic = {}
        for ranks in (1, 3):
            out = load(ranks, f"elastic P={ranks}")
            counts = [f.num_local for f in out]
            if (not torch.equal(torch.cat([f.tree for f in out]), want_t)
                    or not torch.equal(torch.cat([f.keys for f in out]), want_k)
                    or not F.validate(out) or max(counts) - min(counts) > 1):
                raise AssertionError(f"3k {label}: the restore onto {ranks} ranks differs, "
                                     f"fails validate or is unbalanced: {counts}")
            elastic[ranks] = out
        del want_t, want_k
        w = level_weights(balanced, max_level)
        weighted = load(P, f"weighted P={P}", weights=torch.cat(w))
        assert_same_forests(f"3k {label}: weighted restore vs repartition", weighted,
                            F.repartition(balanced, F.SimComm(P), weights=w))
        del weighted, w
        col = step / leaves["anchor"]["file"]
        raw = bytearray(col.read_bytes())
        raw[len(raw) // 2] ^= 1
        col.write_bytes(bytes(raw))
        try:
            load_forest(tmp, F.SimComm(P), cmesh=cmesh)
            refused = False
        except CheckpointIntegrityError:
            refused = True
        if not refused:
            raise AssertionError(f"3k {label}: a flipped anchor byte was not refused")
    one = elastic[1]
    print(f"  {label}: save_forest of {n:,} elements in {facts['save_s']:.3f} s, "
          f"{facts['disk_bytes']:,} B on disk, {facts['at_rest_per_element']:g} B an element "
          f"at rest; loads (s) " + ", ".join(f"{k} {v:.3f}" for k, v in facts["load_s"].items()),
          flush=True)
    print(f"  {label}: exact restore == saved forests with the same markers; onto 1 and 3 "
          f"ranks the same global sequence, valid, per rank {[f.num_local for f in elastic[3]]}; "
          f"weighted == repartition; a flipped anchor byte raised CheckpointIntegrityError",
          flush=True)
    return facts, one


def iterate_identity(label: str, f) -> dict:
    """Phase 3i on one rank holding a whole 2:1-balanced forest: `iterate`
    with an `elem_fn` and a `face_fn`, its wall, S same-level and H
    hanging pairs; then V, the (element, face) slots with a neighbor, and
    C, the slots whose neighbor region holds finer leaves (a lex-search
    range and its level maximum, independent of Iterate), must satisfy
    V = 2S + H + C and H = 2^(d-1) C."""
    from repro_torch.core import forest as F
    from repro_torch.core.batch import RangeMax, lex_search
    from repro_torch.core.keys import span_mask

    sync()
    t = time.perf_counter()
    seen, pairs = F.iterate(f, elem_fn=lambda tree, e: int(e.level.numel()),
                            face_fn=lambda ff, p: p)
    sync()
    wall = time.perf_counter() - t
    fine, coarse = f.level[pairs[:, 0]], f.level[pairs[:, 1]]
    S, H = int((fine == coarse).sum()), int((fine == coarse + 1).sum())
    self_pairs = int((pairs[:, 0] == pairs[:, 1]).sum())
    cross = int((f.tree[pairs[:, 0]] != f.tree[pairs[:, 1]]).sum())
    if seen != f.num_local or S + H != pairs.shape[0]:
        raise AssertionError(f"3i {label}: elem_fn saw {seen} of {f.num_local}; "
                             f"{pairs.shape[0] - S - H} pairs neither same-level nor hanging")
    del fine, coarse, pairs
    lay = F.face_sweep_layer(f, f.tree, f.simplices())
    V = int(lay.valid.sum())
    lo = lex_search(f.tree, f.keys, lay.tgt, lay.nkey)
    hi = lex_search(f.tree, f.keys, lay.tgt,
                    lay.nkey | span_mask(f.d, f.ops.L, f.level)[None, :], right=True)
    C = int((lay.valid & (RangeMax(f.level).query(lo, hi) > f.level[None, :])).sum())
    del lay, lo, hi
    half = 1 << (f.d - 1)
    print(f"  {label}: iterate over {f.num_local:,} elements on one rank in {wall:.3f} s: "
          f"S {S:,} same-level pairs ({cross:,} across tree faces, {self_pairs} self-pairs), "
          f"H {H:,} hanging; V {V:,} faces with a neighbor, C {C:,} coarse faces with finer "
          f"leaves across: V == 2S + H + C is {V == 2 * S + H + C}, H == {half} C is "
          f"{H == half * C}", flush=True)
    if V != 2 * S + H + C or H != half * C:
        raise AssertionError(f"3i {label}: V {V}, S {S}, H {H}, C {C}")
    return {"wall_s": wall, "S": S, "H": H, "V": V, "C": C, "cross_tree": cross,
            "self_pairs": self_pairs}


def iterate_periodic_brick() -> dict:
    """Phase 3i's closed form: the uniform level-5 forest of cmesh_brick(3,
    (2, 2, 2)) periodic on every axis (48 trees, 1,572,864 tets) on one
    rank has no boundary face, so exactly nf N / 2 = 2N pairs, all
    same-level."""
    from repro_torch.core import forest as F
    from repro_torch.core.cmesh import cmesh_brick

    cm = cmesh_brick(3, (2, 2, 2), periodic=(True, True, True))
    f = F.new_uniform(3, cm.num_trees, 5, F.SimComm(1), cmesh=cm, device=torch.device("cuda"))[0]
    sync()
    t = time.perf_counter()
    pairs = F.iterate(f, face_fn=lambda ff, p: p)[0]
    sync()
    wall = time.perf_counter() - t
    n, m = f.num_local, pairs.shape[0]
    print(f"  periodic brick (48 trees, level 5): iterate over {n:,} tets in {wall:.3f} s: "
          f"{m:,} pairs == 2N: {m == 2 * n}", flush=True)
    if n != 1_572_864 or m != 2 * n or bool((f.level[pairs[:, 0]] != f.level[pairs[:, 1]]).any()):
        raise AssertionError(f"3i periodic brick: {m} pairs over {n} tets")
    return {"wall_s": wall, "pairs": m, "N": n}


def forest_phases(runs: dict, kops, kref) -> dict:
    """Phases 3o, 3k and 3i on the full-size phases in `runs` ({label:
    {unbalanced, balanced, ghosts, P, cmesh, max_level, eclass, bytes}}),
    each sub-phase counted on its own.  Returns {phase: [(label, launches,
    plain calls, launches per class)]}."""
    counts = {"3o": [], "3k": [], "3i": []}
    print(f"== 3o. the global-table oracles against Balance and Ghost ({', '.join(runs)})",
          flush=True)
    for label, r in runs.items():
        _f, lc, pc, cls = counted(kops, kref, lambda r=r, label=label: oracles(
            label, r["unbalanced"], r["balanced"], r["ghosts"], r["P"], r["bytes"]))
        counts["3o"].append((label, lc, pc, cls))
        r.pop("unbalanced")
        torch.cuda.empty_cache()
    print(f"== 3k. forest checkpoints ({', '.join(runs)})", flush=True)
    restored = {}
    for label, r in runs.items():
        (_f, restored[label]), lc, pc, cls = counted(kops, kref, lambda r=r, label=label: checkpoints(
            label, r["balanced"], r["P"], r["cmesh"], r["max_level"], r["eclass"]))
        counts["3k"].append((label, lc, pc, cls))
        torch.cuda.empty_cache()
    print(f"== 3i. Iterate on one rank ({', '.join(runs)}; the periodic brick)", flush=True)
    for label in runs:
        _f, lc, pc, cls = counted(kops, kref, lambda label=label: iterate_identity(
            label, restored[label][0]))
        counts["3i"].append((label, lc, pc, cls))
        del restored[label]
        torch.cuda.empty_cache()
    if "phase 3" in runs:
        _f, lc, pc, cls = counted(kops, kref, iterate_periodic_brick)
        counts["3i"].append(("periodic brick", lc, pc, cls))
    return counts


def check_forest_phase_launches(counts: dict) -> None:
    """Phase 5 for 3o, 3k and 3i: each ran face_sweep as a kernel, 3o also
    decode (ghost_oracle's candidates); on the coarse-mesh phases
    tree_transform and morton_key carried the crossings; the hex phase ran
    hex bodies only; no plain version was called."""
    for phase, rows in counts.items():
        for label, lc, pc, cls in rows:
            print(f"  phase {phase} ({label}): kernel launches {lc}; plain calls {pc}",
                  flush=True)
            need = {"3o": ["face_sweep", "decode"], "3i": ["face_sweep"],
                    "3k": ["morton_key", "inside_root"]}[phase]
            if label in ("phase 3c", "phase 3h") and phase != "3k":
                need += ["tree_transform", "morton_key"]
            if not all(lc[k] > 0 for k in need) or any(pc.values()):
                raise AssertionError(f"phase {phase} ({label}): want {need} launched and no "
                                     f"plain call: {lc}, {pc}")
            if label == "phase 3h" and any(v["simplex"] for v in cls.values()):
                raise AssertionError(f"phase {phase} ({label}): a simplex body ran")


# ------------------------------- 3m, 3r: rank processes and fault tolerance
# Phase 3r(a)'s fault rates: the byte faults at the JAX package's rates
# (tests/core/test_resilience.py) a delivered payload of Partition, Balance
# and Ghost; the delay at 0.25 a collective (the JAX test's 0.05 would
# delay none of phase 3's dozen collectives, on average less than one).
CHAOS_RATES = dict(p_corrupt=0.2, p_truncate=0.1, p_duplicate=0.1, p_delay=0.25)
CHAOS_PHASES = ("partition", "balance", "ghost")
CRASH_AT = 3                # 3r(b): rank 3 dies at its 3rd Balance collective
CRASH_DEADLINE_S = 6.0      # 3r(b): the survivors' wait budget a Balance collective
RANK_TIMEOUT_S = 600.0      # DistComm's own timeout in the rank processes
FLEET_WALL_S = 300.0        # run_ranks' wall clock for one fleet
# A rank process: argv = [store port, rank, repository root, mode, device, ...].
RANK_SCRIPT = ("import sys; sys.path.insert(0, sys.argv[3]); import chip_smoke; "
               "sys.exit(chip_smoke.rank_main(sys.argv[1:]))")
RESULT_TAG = "RANK_RESULT "


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def field_digests(fs: list, ghosts: list | None = None) -> list:
    """Per rank, the SHA-256 of every forest field (and ghost field)."""
    out = []
    for r, f in enumerate(fs):
        dg = {k: _sha(getattr(f, k)) for k in FOREST_FIELDS}
        if ghosts is not None:
            dg.update({f"ghost {k}": _sha(ghosts[r][k]) for k in GHOST_FIELDS})
        out.append(dg)
    return out


def slice_digests(fs: list, counts: list) -> list:
    """The SHA-256 of every forest field of the global sequence of `fs`
    cut into runs of `counts` elements: what ranks holding those runs
    would report."""
    cat = {k: torch.cat([getattr(f, k) for f in fs]) for k in FOREST_FIELDS}
    offs = np.cumsum([0, *counts])
    return [{k: _sha(v[offs[r]:offs[r + 1]]) for k, v in cat.items()}
            for r in range(len(counts))]


def _sync(device) -> None:
    if device.type == "cuda":
        sync()


def _timed(walls: dict, name: str, fn, device):
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    walls[name] = time.perf_counter() - t
    return out


def leave_together(store, name: str, rank: int, size: int) -> None:
    """Rank 0 hosts the store, so it leaves last: every rank checks out,
    and rank 0 waits until all `size` have."""
    n = store.add(name, 1)
    t0 = time.monotonic()
    while rank == 0 and n < size and time.monotonic() - t0 < RANK_TIMEOUT_S:
        time.sleep(0.01)
        n = store.add(name, 0)


AT_REST_FIELDS = (("anchor", torch.int32), ("level", torch.int8), ("stype", torch.int8),
                  ("tree", torch.int32))


def gathered_validate(fs: list, gh: list, comm) -> bool | None:
    """`validate` of the whole world, on rank 0: every rank sends its
    elements at rest (18 B a tet: int32 anchor and tree, int8 level and
    type) and its ghost fields to rank 0 in one alltoallv on `comm`; rank 0
    encodes the keys anew (`replace_elements`) and validates.  Returns the
    verdict on rank 0, None elsewhere."""
    from repro_torch.core import forest as F

    f, g = fs[0], gh[0]
    mine = ([getattr(f, k).to(dt).cpu().numpy() for k, dt in AT_REST_FIELDS],
            [g[k].cpu().numpy() for k in GHOST_FIELDS])
    recv = comm.alltoallv([[mine if q == 0 else None for q in range(comm.size)]])[0]
    if comm.rank != 0:
        return None
    dev = f.device
    world, ghosts = [], []
    for p, (fcols, gcols) in enumerate(recv):
        world.append(dataclasses.replace(f.replace_elements(
            *(torch.from_numpy(c).to(dev) for c in fcols)), rank=p))
        ghosts.append({k: torch.from_numpy(c).to(dev) for k, c in zip(GHOST_FIELDS, gcols)})
    return bool(F.validate(world, ghosts))


def rank_pipeline(rank: int, device, d: int, trees: int, level: int, max_level: int) -> dict:
    """Phase 3m, one rank: phase 3's path on this rank's share through
    DistComm — New, the fractal, the coarsening, Partition and the weighted
    repartition (`Forest.repartition`) on one instance, Balance and Ghost
    overlapped on a second, validate of the gathered world on rank 0
    through a fourth, then Balance and Ghost serialized on a third (they
    must agree with the overlapped ones, bytes included).
    Kernel launches are read after the validate; plain calls after
    everything."""
    from repro_torch.core import forest as F
    from repro_torch.core.comm import DistComm
    from repro_torch.kernels import ops as kops, ref as kref

    pre, ov, ser, side = (DistComm(timeout_s=RANK_TIMEOUT_S, namespace=f"3m.{ns}.")
                          for ns in ("pre", "ov", "ser", "side"))
    kops.reset_launch_counts()
    kref.reset_call_counts()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    walls: dict = {}
    timed = functools.partial(_timed, walls, device=device)
    fs = timed("new_uniform", lambda: F.new_uniform(d, trees, level, pre, device=device))
    fs = timed("adapt fractal", lambda: [F.adapt(fs[0], fractal_cb(d, max_level), recursive=True)])
    fs = timed("adapt coarsen", lambda: [F.adapt(fs[0], coarsen_upper_half_cb(trees, max_level))])
    F.load_imbalance(fs, pre)
    fs = timed("partition", lambda: F.partition(fs, pre))
    F.load_imbalance(fs, pre)
    w = level_weights(fs, max_level)
    F.load_imbalance(fs, pre, weights=w)
    fs = timed("repartition weighted", lambda: [fs[0].repartition(pre, weights=w[0])])
    F.load_imbalance(fs, pre, weights=level_weights(fs, max_level))
    bal = timed("balance", lambda: F.balance(fs, ov))
    gh = timed("ghost", lambda: F.ghost(bal, ov))
    ok = timed("validate (gathered on rank 0)", lambda: gathered_validate(bal, gh, side))
    launches = dict(kops.launch_counts)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    bal_s = timed("balance serialized", lambda: F.balance(fs, ser, overlap=False))
    gh_s = timed("ghost serialized", lambda: F.ghost(bal_s, ser, overlap=False))
    same = (all(torch.equal(getattr(bal[0], k), getattr(bal_s[0], k)) for k in FOREST_FIELDS)
            and all(torch.equal(gh[0][k], gh_s[0][k]) for k in GHOST_FIELDS))
    res = {"rank": rank, "walls": walls, "digests": field_digests(bal, gh)[0],
           "elements": bal[0].num_local, "ghosts": int(gh[0]["level"].shape[0]),
           "bytes": {**{k: pre.bytes_for(k) for k in pre.counters},
                     **{k: ov.bytes_for(k) for k in ov.counters}},
           "launches": launches, "plain": dict(kref.call_counts), "peak_bytes": peak,
           "overlap_equal": same, "digest_ov": ov.wire_digest(), "digest_ser": ser.wire_digest(),
           "validate": ok}
    leave_together(side.store, "3m.left", rank, side.size)
    return res


def rank_crash(rank: int, device, d: int, trees: int, level: int, max_level: int,
               ckpt: str) -> None:
    """Phase 3r(b), the world of four: phase 3's path to Balance through
    `ChaosComm(DistComm)`, an `Autosaver` at balance:begin, then Balance
    under a deadline; rank 3 hard-exits (code 2) at its CRASH_AT-th Balance
    collective, and each survivor prints its `CommTimeoutError` and exits 3.
    A Balance that finishes exits 4."""
    from repro_torch.core import forest as F
    from repro_torch.core.comm import DistComm
    from repro_torch.core.errors import CommTimeoutError
    from repro_torch.core.resilience import Autosaver, ChaosComm
    from repro_torch.kernels import ops as kops, ref as kref

    comm = DistComm(timeout_s=RANK_TIMEOUT_S, namespace="3r.crash.", beacon=True)
    chaos = ChaosComm(comm, crash_at=CRASH_AT, crash_ranks=(3,), hard_exit=True,
                      phases=("balance",))
    kops.reset_launch_counts()
    kref.reset_call_counts()
    fs = F.new_uniform(d, trees, level, chaos, device=device)
    fs = [F.adapt(fs[0], fractal_cb(d, max_level), recursive=True)]
    fs = [F.adapt(fs[0], coarsen_upper_half_cb(trees, max_level))]
    fs = F.partition(fs, chaos)
    fs = [fs[0].repartition(chaos, weights=level_weights(fs, max_level)[0])]
    chaos.barrier()
    marks: dict = {}
    saver = Autosaver(ckpt, events=("balance:begin",))

    def before(event, _fs, _comm):
        if event == "balance:begin":
            _sync(device)
            marks["save"] = time.perf_counter()

    def after(event, _fs, _comm):     # the deadline covers Balance's collectives
        if event == "balance:begin":
            _sync(device)
            marks["balance"] = time.perf_counter()
            chaos.set_deadline(CRASH_DEADLINE_S)

    F.RESILIENCE_HOOKS.extend([before, saver, after])
    try:
        F.balance(fs, chaos)
    except CommTimeoutError as e:
        t = time.perf_counter()
        res = {"rank": rank, "phase": e.phase, "seq": e.seq, "pending": e.pending,
               "detail": e.detail, "detect_s": e.elapsed_s,
               "save_s": marks["balance"] - marks["save"],
               "balance_to_raise_s": t - marks["balance"], "saved_steps": saver.saved_steps,
               "launches": dict(kops.launch_counts), "plain": dict(kref.call_counts)}
        print(RESULT_TAG + json.dumps(res), flush=True)
        leave_together(comm.store, "3r.crash.left", rank, MULTI_P - 1)
        os._exit(3)
    print(f"rank {rank}: balance finished", flush=True)
    os._exit(4)


def rank_recover(rank: int, device, ckpt: str) -> dict:
    """Phase 3r(b), the fresh world of three: `recover` the checkpoint the
    four saved, finish Balance and Ghost, validate the gathered world on
    rank 0."""
    from repro_torch.core import forest as F
    from repro_torch.core.comm import DistComm
    from repro_torch.core.resilience import recover
    from repro_torch.kernels import ops as kops, ref as kref

    comm, side = (DistComm(timeout_s=RANK_TIMEOUT_S, namespace=f"3r.rec.{ns}.")
                  for ns in ("main", "side"))
    kops.reset_launch_counts()
    kref.reset_call_counts()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    walls: dict = {}
    timed = functools.partial(_timed, walls, device=device)
    fs = timed("recover", lambda: recover(ckpt, comm, device=device))
    restored = fs[0].num_local
    bal = timed("balance", lambda: F.balance(fs, comm))
    gh = timed("ghost", lambda: F.ghost(bal, comm))
    launches = dict(kops.launch_counts)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    ok = gathered_validate(bal, gh, side)
    res = {"rank": rank, "walls": walls, "restored": restored, "count": bal[0].num_local,
           "digests": field_digests(bal)[0], "launches": launches,
           "plain": dict(kref.call_counts), "peak_bytes": peak, "validate": ok}
    leave_together(side.store, "3r.rec.left", rank, side.size)
    return res


def rank_main(argv: list) -> int:
    """A rank process of phases 3m and 3r, started by `run_ranks` with
    RANK_SCRIPT: argv = [store port, rank, repository root, mode, device,
    *mode's arguments].  Prints its result as one RANK_RESULT line."""
    _port, rank, _root, mode, device, *rest = argv
    if mode in ("3m", "3r-crash"):          # phase 3's path: d, trees, level, max_level
        rest = [*map(int, rest[:4]), *rest[4:]]
    run = {"3m": rank_pipeline, "3r-crash": rank_crash, "3r-recover": rank_recover}[mode]
    res = run(int(rank), torch.device(device), *rest)
    print(RESULT_TAG + json.dumps(res), flush=True)
    return 0


def rank_fleet(mode: str, P: int, device, *args, check: bool = True):
    """Run `mode` in P rank processes on `device`; returns (run_ranks'
    output, the fleet's wall)."""
    from repro_torch.launch.multiproc import run_ranks

    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    outs = run_ranks(RANK_SCRIPT, P, extra_args=(ROOT, mode, device.type, *args),
                     timeout=FLEET_WALL_S, check=check)
    return outs, time.perf_counter() - t


def rank_result(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
    if len(lines) != 1:
        raise AssertionError(f"a rank printed {len(lines)} results: {out[-2000:]}")
    return json.loads(lines[0][len(RESULT_TAG):])


def summed(rows: list) -> dict:
    """Each kernel's count summed over the ranks' dicts."""
    return {k: sum(r[k] for r in rows) for k in rows[0]}


def slowest(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def store_rate(nbytes: int = 32 << 20) -> dict:
    """The TCPStore's rate for one blob of `nbytes` (a Partition-sized
    peer blob): two DistComms over a store on localhost in this process,
    rank 0 posts it to rank 1, rank 1 fetches it; host clock, best of 3."""
    from torch.distributed import TCPStore

    from repro_torch.core.comm import DistComm
    from repro_torch.launch.multiproc import free_port

    port = free_port()
    stores = [TCPStore("localhost", port, 2, is_master=r == 0, wait_for_workers=False)
              for r in range(2)]
    c = [DistComm(timeout_s=60, store=st, rank=r, size=2, namespace="rate.")
         for r, st in enumerate(stores)]
    blob = np.random.default_rng(SEED).integers(0, 255, nbytes, dtype=np.uint8)
    best = {"post_s": math.inf, "fetch_s": math.inf}
    for _ in range(3):
        t = time.perf_counter()
        h0 = c[0].ialltoallv([[None, blob]])
        h1 = c[1].ialltoallv([[None, None]])
        t1 = time.perf_counter()
        got = h1.wait()[0][0]
        t2 = time.perf_counter()
        h0.wait()
        if not np.array_equal(got, blob):
            raise AssertionError("the store delivered other bytes")
        best = {"post_s": min(best["post_s"], t1 - t), "fetch_s": min(best["fetch_s"], t2 - t1)}
    del c, stores
    out = {"bytes": nbytes, **best, "post_MBps": nbytes / best["post_s"] / 1e6,
           "fetch_MBps": nbytes / best["fetch_s"] / 1e6}
    print(f"  TCPStore on localhost, one {nbytes:,} B blob (1 MiB chunks): post {best['post_s']:.4f} s "
          f"({out['post_MBps']:.0f} MB/s), fetch {best['fetch_s']:.4f} s ({out['fetch_MBps']:.0f} "
          "MB/s); host clock, best of 3", flush=True)
    return out


def multi_process_path(ref: dict, path: tuple = PATH3, device=torch.device("cuda")) -> dict:
    """Phase 3m: phase 3 as four rank processes on the card (`run_ranks`,
    DistComm over a TCPStore on localhost; `rank_pipeline`).  Per rank,
    every forest and ghost field's SHA-256 must equal phase 3's, and each
    phase's bytes summed over the ranks phase 3's `SimComm(4)` counts;
    overlapped and serialized Balance and Ghost must agree, wire digests
    included; validate of the gathered world must hold; no plain version
    may run in any rank."""
    rate = store_rate()
    outs, fleet = rank_fleet("3m", MULTI_P, device, *path)
    res = [rank_result(out) for out, _err in outs]
    for r, x in enumerate(res):
        bad = [k for k in x["digests"] if x["digests"][k] != ref["digests"][r][k]]
        if bad:
            raise AssertionError(f"3m: rank {r}'s {bad} differ from phase 3's")
        if not x["overlap_equal"] or x["digest_ov"] != x["digest_ser"]:
            raise AssertionError(f"3m: rank {r}: overlapped and serialized Balance/Ghost differ")
        if device.type == "cuda" and any(x["plain"].values()):
            raise AssertionError(f"3m: rank {r} called plain versions {x['plain']}")
    if res[0]["validate"] is not True:
        raise AssertionError("3m: validate(forests, ghosts) of the gathered world is not True")
    got_bytes = {k: sum(x["bytes"].get(k, 0) for x in res) for k in ref["bytes"]}
    if got_bytes != ref["bytes"] or set().union(*(x["bytes"] for x in res)) != set(ref["bytes"]):
        raise AssertionError(f"3m: bytes per phase {got_bytes} differ from phase 3's {ref['bytes']}")
    walls = slowest([x["walls"] for x in res])
    launches = summed([x["launches"] for x in res])
    print(f"  four rank processes, one card, DistComm over a TCPStore: fleet wall {fleet:.3f} s "
          "(process start, CUDA init and library load included)", flush=True)
    for k, v in walls.items():
        print(f"  {k:32s} {v:8.3f} s (slowest rank)"
              + (f"; phase 3 on SimComm(4) {ref['walls'][k]:.3f} s" if k in ref["walls"] else ""),
              flush=True)
    print(f"  per rank: elements {[x['elements'] for x in res]}, ghosts {[x['ghosts'] for x in res]}"
          f", peak device memory {[x['peak_bytes'] for x in res]} B (phase 3, all four in one "
          f"process: {ref['peak_bytes']} B)", flush=True)
    print(f"  every forest and ghost field's SHA-256 equal to phase 3's on every rank; bytes per "
          f"phase summed over the ranks {got_bytes}, as phase 3's; overlapped == serialized with "
          "equal wire digests on every rank; validate of the gathered world True", flush=True)
    print(f"  kernel launches summed over the ranks {launches} (phase 3: {ref['launches']}); "
          "plain calls 0 in every rank", flush=True)
    return {"fleet_s": fleet, "walls_s": walls, "peak_bytes": [x["peak_bytes"] for x in res],
            "launches": launches, "bytes": got_bytes, "store_rate": rate}


def chaos_path(ref: dict, path: tuple = PATH3, device=torch.device("cuda")) -> dict:
    """Phase 3r(a): phase 3's path at full size on `ChaosComm(SimComm(4))`
    with seeded corruption, truncation, duplication and delay in Partition,
    Balance and Ghost: every forest and ghost field and every phase's bytes
    equal phase 3's, and every injected byte fault detected."""
    from repro_torch.core import forest as F
    from repro_torch.core.resilience import ChaosComm

    ch = ChaosComm(F.SimComm(MULTI_P), seed=SEED, phases=CHAOS_PHASES, **CHAOS_RATES)
    t = time.perf_counter()
    fs, gh, _comm, facts = run_path(*path, MULTI_P, device, comm=ch)
    wall = time.perf_counter() - t
    if field_digests(fs, gh) != ref["digests"]:
        raise AssertionError("3r(a): a forest or ghost under byte faults differs from phase 3's")
    if facts["bytes"] != ref["bytes"]:
        raise AssertionError(f"3r(a): bytes {facts['bytes']} differ from phase 3's {ref['bytes']}")
    fc = dict(ch.fault_counts)
    injected = fc["corrupt"] + fc["truncate"] + fc["duplicate"]
    if not injected or fc["detected"] != injected:
        raise AssertionError(f"3r(a): fault counts {fc}")
    print(f"  ChaosComm(SimComm(4), seed {SEED}, {CHAOS_RATES} in {CHAOS_PHASES}): wall "
          f"{wall:.3f} s (phase 3: {sum(ref['walls'].values()):.3f} s); fault counts {fc}: "
          f"{injected} byte faults, all detected; forests, ghosts and bytes as phase 3's",
          flush=True)
    return {"wall_s": wall, "fault_counts": fc}


def kill_one_rank(path: tuple = PATH3, device=torch.device("cuda")) -> dict:
    """Phase 3r(b): four rank processes run phase 3's path to Balance with
    an Autosaver at balance:begin; rank 3 dies at its CRASH_AT-th Balance
    collective; ranks 0-2 must each raise `CommTimeoutError` with phase
    balance and pending [3] within the deadline.  A fresh world of three
    then recovers the checkpoint (saved by four, restored onto three),
    finishes Balance and Ghost, and must equal an in-process `SimComm(3)`
    run of the same path on the card, element for element, with validate
    of its gathered world True."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "autosave"
        outs, crash_wall = rank_fleet("3r-crash", MULTI_P, device, *path, ckpt, check=False)
        if outs[3][2] != 2:
            raise AssertionError(f"3r(b): rank 3 exited {outs[3][2]}, want 2: {outs[3][1][-2000:]}")
        surv = []
        for r in range(3):
            out, err, rc = outs[r]
            if rc != 3:
                raise AssertionError(f"3r(b): survivor {r} exited {rc}: {err[-3000:]}")
            x = rank_result(out)
            if x["phase"] != "balance" or x["pending"] != [3] or x["detect_s"] > CRASH_DEADLINE_S + 1:
                raise AssertionError(f"3r(b): survivor {r}: {x}")
            if device.type == "cuda" and any(x["plain"].values()):
                raise AssertionError(f"3r(b): survivor {r} called plain versions {x['plain']}")
            surv.append(x)
        manifest = json.loads((ckpt / "step_0" / "manifest.json").read_text())
        if manifest["meta"]["num_ranks"] != MULTI_P:
            raise AssertionError(f"3r(b): the checkpoint was saved by {manifest['meta']['num_ranks']}")
        outs, rec_wall = rank_fleet("3r-recover", 3, device, ckpt)
    res = [rank_result(out) for out, _err in outs]
    plain = device.type == "cuda" and any(any(x["plain"].values()) for x in res)
    if plain or res[0]["validate"] is not True:
        raise AssertionError(f"3r(b): plain calls or validate failed: {res}")
    fs3, _gh3, _c3, _f3 = run_path(*path, 3, device)
    counts = [x["count"] for x in res]
    if sum(counts) != sum(f.num_local for f in fs3):
        raise AssertionError(f"3r(b): {sum(counts)} elements after recovery, SimComm(3) "
                             f"{sum(f.num_local for f in fs3)}")
    want = slice_digests(fs3, counts)
    for r, x in enumerate(res):
        if x["digests"] != want[r]:
            raise AssertionError(f"3r(b): rank {r}'s recovered world differs from SimComm(3)'s")
    walls = slowest([x["walls"] for x in res])
    print(f"  crash world: rank 3 exit 2; ranks 0-2 CommTimeoutError phase balance pending [3], "
          f"detail {[x['detail'] for x in surv]}; time to detect {[round(x['detect_s'], 3) for x in surv]}"
          f" s (deadline {CRASH_DEADLINE_S} s), Balance entry to raise "
          f"{[round(x['balance_to_raise_s'], 3) for x in surv]} s; autosave at balance:begin "
          f"{max(x['save_s'] for x in surv):.3f} s (slowest rank); fleet wall {crash_wall:.3f} s",
          flush=True)
    print(f"  recovery world of 3: restored {[x['restored'] for x in res]} elements per rank; "
          f"walls (slowest rank) {({k: round(v, 3) for k, v in walls.items()})}; fleet wall "
          f"{rec_wall:.3f} s; peak device memory {[x['peak_bytes'] for x in res]} B; balanced "
          f"{counts} = SimComm(3)'s global sequence, element for element; validate True",
          flush=True)
    return {"crash_fleet_s": crash_wall, "recover_fleet_s": rec_wall,
            "detect_s": [x["detect_s"] for x in surv], "save_s": max(x["save_s"] for x in surv),
            "recover_walls_s": walls,
            "launches": summed([x["launches"] for x in surv + res])}


# ------------------------------------------------ 2a, 4 and 6: the LM path
# The LM path's constants: phase 6 serves qwen3-1.7b at full width and
# depth; the attention kernel's bound uses the H100 SXM's dense bf16/fp16
# tensor-core peak (NVIDIA's H100 data sheet, 700 W).
SERVE_ARCH = "qwen3-1.7b"
TC_FLOPS_PER_S = 989e12
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:69 flash_attention"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
# A tighter check beside FLASH_TOL: the largest relative L2 error of one
# output row, ||got - want|| / ||want|| over hd.  Late rows of a long causal
# band average many keys, so their values are small (about sqrt(1 / qpos))
# and FLASH_TOL's absolute floor would pass an error of a whole tile there;
# a row's own norm does not.  Rounding alone gives a few ulps of the dtype
# (p and the output rounded to bf16 / fp16; sums in another order in fp32).
FLASH_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 3e-3}
# The earlier mma.sync body's device time at qwen3's prefill shape (PERF.md
# §6, row 12, "NVIDIA H100 80GB HBM3, 700.00 W"), printed beside the new
# time; not re-measured: that body is gone.
FLASH_EARLIER_DEVICE_MS = 1.5954
# (B, S, H, KV, hd, window, causal): qwen3's prefill shape of phase 6a
# first; S not a multiple of the tile; G = H / KV of 1, 4 and H (MQA); hd
# 32, 64, 96; a window of 100, and one of 20, below every tile (128 keys
# bf16/fp16, 32 fp32); then the 128 x 128 tiles' edges: S = 128, 255, 257,
# windows of 128 and 129 and one longer than S, 3 x 16 x 9 = 432 blocks (3
# waves of 132 and a partial one), and hd 32, 64, 96 around a tile; then
# causal=False (`attention_core` sends only causal attention to the kernel,
# but the wrapper takes the flag): 1, 2, 3 and 8 query tiles (the
# persistent grid runs an odd count's middle tile alone), G = 1, 2, 4 and
# MQA, and windows below, at and past the tile
FLASH_CASES = [
    (8, 2048, 16, 8, 128, None, True),
    (1, 1, 16, 8, 128, None, True), (2, 127, 16, 8, 128, None, True),
    (2, 129, 16, 8, 128, None, True), (1, 1000, 16, 8, 128, None, True),
    (1, 512, 8, 8, 64, None, True), (1, 512, 16, 4, 128, None, True),
    (1, 512, 16, 1, 128, None, True),
    (2, 300, 4, 2, 32, None, True), (2, 300, 8, 4, 64, None, True),
    (1, 700, 32, 32, 96, None, True),
    (1, 1000, 16, 8, 128, 100, True), (1, 1000, 16, 8, 128, 20, True),
    (2, 128, 16, 8, 128, None, True), (1, 255, 16, 8, 128, None, True),
    (1, 257, 16, 8, 128, None, True),
    (1, 1000, 16, 8, 128, 128, True), (1, 1000, 16, 8, 128, 129, True),
    (1, 300, 16, 8, 128, 5000, True),
    (3, 1100, 16, 8, 128, None, True),
    (2, 257, 8, 4, 32, None, True), (1, 255, 8, 2, 64, 128, True),
    (1, 129, 4, 4, 96, 5000, True),
    (2, 127, 8, 8, 64, None, False), (1, 129, 16, 4, 96, None, False),
    (1, 1000, 16, 8, 128, None, False), (1, 257, 16, 8, 128, None, False),
    (1, 300, 16, 1, 128, 100, False), (2, 200, 4, 2, 32, 20, False),
    (1, 1000, 16, 8, 128, 129, False),
]
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 8, 2048, 2304, 128
REQUEST_LENGTHS = (1, 127, 129, 300, 777, 1000, 1536, 2047)
REQUEST_TOKENS = 16
CONSIST_BATCH, CONSIST_S, CONSIST_DECODE = 2, 512, 4
# Phase 6c: fp32 prefill + decode against forward at full width.  Both runs
# are fp32 end to end (no TF32); they differ only in the order of sums
# (cuBLAS picks kernels by shape: 2 x 508 and 2 x 512 rows, 2 at decode;
# decode attends through the plain path, prefill through the kernel), each
# about 1e-6 relative, over 28 layers: 1e-3 leaves some 100 times the
# 1e-5 expected.
CONSIST_TOL = 1e-3
# Phase 4, reduced LMs card vs CPU, fp32 on identical weights: the kernel
# against the plain version and cuBLAS against the CPU's BLAS sum in other
# orders, about 1e-6 relative over 2 layers.
LM_CPU_TOL = 1e-4


def flash_pairs(S: int, window: int | None) -> int:
    """Unmasked (query, key) pairs of one (b, h): causal, and with a window
    min(q + 1, window) a query."""
    if window is None:
        return S * (S + 1) // 2
    q = np.arange(S)
    return int(np.minimum(q + 1, window).sum())


def flash_bound(B: int, S: int, H: int, KV: int, hd: int, window, elsize: int) -> tuple:
    """(bound ms, what bounds it, FLOPs, bytes): 4 hd FLOPs a pair over the
    tensor cores' peak, against q and o once each and k and v once each
    over the memory rate."""
    flops = 4 * B * H * hd * flash_pairs(S, window)
    moved = (2 * B * S * H * hd + 2 * B * S * KV * hd) * elsize
    f_ms, b_ms = flops / TC_FLOPS_PER_S * 1e3, moved / MEM_BYTES_PER_S * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes"), flops, moved


def flash_instructions(build) -> dict:
    """The Hopper instructions in the built attention library's SASS
    (`cuobjdump --dump-sass`): wgmma (HGMMA) and TMA loads (UTMALDG) and
    stores (UTMASTG); raises if the library holds no HGMMA or no UTMALDG.
    Prints the ptxas register and spill lines of the bf16 hd-128 body
    from the build's log."""
    lib = build.build("flash_attention")
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
    print(f"  SASS of {lib.name}: {counts}", flush=True)
    if not counts["HGMMA"] or not counts["UTMALDG"]:
        raise AssertionError(f"flash_attention: no wgmma or no TMA load in the SASS: {counts}")
    lines, entry = [], False
    for line in (build.BUILD_DIR / "flash_attention.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = all(w in line for w in ("flash_tc_kernel", "nv_bfloat16", "Li128E"))
        elif entry and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    if not lines:
        raise AssertionError("flash_attention: no ptxas lines for the bf16 hd-128 body")
    for line in lines:
        print(f"  ptxas, bf16 hd 128: {line}", flush=True)
    return {**counts, "ptxas_bf16_hd128": lines}


def flash_vs_plain(kops, kref) -> dict:
    """Phase 2a: the attention kernel against its plain version on the same
    card tensors, every case of FLASH_CASES in bf16, fp16 and fp32, within
    FLASH_TOL (|got - want| <= tol + tol |want|) and FLASH_ROW_TOL; then,
    at qwen3's prefill shape, its time both ways beside the earlier body's
    (from PERF.md), the plain version's, SDPA's, and the bound.  Returns the
    row of the `kernels` line."""
    import torch.nn.functional as tF

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {dt: 0.0 for dt in FLASH_TOL}
    worst_row = {dt: 0.0 for dt in FLASH_TOL}
    timed = {}
    for case in FLASH_CASES:
        B, S, H, KV, hd, window, causal = case
        for dt, tol in FLASH_TOL.items():
            q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
            k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dt)
            v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dt)
            got = kops.flash_attention(q, k, v, causal=causal, window=window)
            want = kref.flash_attention(q, k, v, causal=causal, window=window)
            sync()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            excess = float((diff - tol * (1 + want.float().abs())).max())
            row = float((diff.norm(dim=-1) / want.float().norm(dim=-1).clamp_min(1e-30)).max())
            label = (f"B={B} S={S} H={H} KV={KV} hd={hd} window={window}"
                     f"{'' if causal else ' causal=False'} {str(dt)[6:]}")
            if got.dtype != dt or not torch.isfinite(got).all() or excess > 0:
                raise AssertionError(f"flash_attention {label}: max |err| {err} beyond {tol}")
            if row > FLASH_ROW_TOL[dt]:
                raise AssertionError(f"flash_attention {label}: a row's relative error {row} "
                                     f"beyond {FLASH_ROW_TOL[dt]}")
            worst[dt] = max(worst[dt], err)
            worst_row[dt] = max(worst_row[dt], row)
            print(f"  flash_attention {label}: max |err| {err:.3g} (tolerance {tol}), "
                  f"a row's relative error {row:.3g} (tolerance {FLASH_ROW_TOL[dt]})",
                  flush=True)
            if case == FLASH_CASES[0]:
                timed[dt] = (q, k, v, err)
            del q, k, v, got, want, diff
    B, S, H, KV, hd, window, _causal = FLASH_CASES[0]
    q, k, v, err = timed[torch.bfloat16]
    kernel = lambda: kops.flash_attention(q, k, v)                      # noqa: E731
    plain = lambda: kref.flash_attention(q, k, v)                       # noqa: E731
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: tF.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
    lib_err = float((library().transpose(1, 2).float() - plain().float()).abs().max())
    ms, dev_ms = cuda_ms(kernel, 20), device_ms(kernel)
    plain_ms, library_ms = cuda_ms(plain, 3), cuda_ms(library, 20)
    library_dev_ms = device_ms(library)
    bound_ms, bound_by, flops, moved = flash_bound(B, S, H, KV, hd, window, 2)
    q32, k32, v32, err32 = timed[torch.float32]
    ms32 = cuda_ms(lambda: kops.flash_attention(q32, k32, v32), 5)
    plain_ms32 = cuda_ms(lambda: kref.flash_attention(q32, k32, v32), 3)
    print(f"  flash_attention at qwen3's prefill shape (B={B} S={S} H={H} KV={KV} hd={hd}, "
          f"bf16): kernel {ms:.4f} ms (device {dev_ms:.4f} ms; the earlier mma.sync body "
          f"{FLASH_EARLIER_DEVICE_MS} ms device, from PERF.md, not re-measured: "
          f"{FLASH_EARLIER_DEVICE_MS / dev_ms:.2f}x), plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms (device {library_dev_ms:.4f} ms; max |SDPA - plain| "
          f"{lib_err:.3g}), bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} FLOP, "
          f"{moved} B), bound/kernel {bound_ms / ms:.1%} (device {bound_ms / dev_ms:.1%}), "
          f"{flops / dev_ms / 1e9:.1f} TFLOP/s; fp32 kernel {ms32:.4f} ms, plain "
          f"{plain_ms32:.4f} ms", flush=True)
    del timed, q, k, v, qt, kt, vt, q32, k32, v32
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "max_abs_err_bf16_all": worst[torch.bfloat16],
            "max_abs_err_fp32_all": worst[torch.float32], "max_abs_err_fp32": err32,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "flops": flops, "bytes": moved, "ms_fp32": ms32, "plain_ms_fp32": plain_ms32,
            "max_abs_err_fp16_all": worst[torch.float16],
            "max_row_rel_err_all": {str(dt)[6:]: e for dt, e in worst_row.items()},
            "shape": [B, S, H, KV, hd]}


def lm_card_vs_cpu() -> None:
    """Phase 4, the LM: reduced qwen3, olmo and phi3 in fp32 on identical
    weights on both devices: a 37-token prefill (batch 2) and 6 greedy
    decode steps give equal tokens and logits within LM_CPU_TOL."""
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("qwen3-1.7b", "olmo-1b", "phi3-mini-3.8b"):
        cfg = replace(reduced(get_config(arch)), dtype="float32")
        prompt = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                                       (2, 37)))
        prefill, step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
        runs = []
        for dev in ("cuda", "cpu"):
            params = init_params(cfg, seed=SEED, device="cpu").to(dev)
            logits, cache = prefill(params, {"tokens": prompt.to(dev)},
                                    init_cache(cfg, 2, 48, device=dev))
            out, toks = [logits.cpu()], []
            for i in range(6):
                tok = logits.argmax(-1, keepdim=True)
                toks.append(tok.cpu())
                logits, cache = step(params, cache, tok, 37 + i)
                out.append(logits.cpu())
            runs.append((torch.stack(out), torch.cat(toks, 1)))
        (lg, tg), (lc, tc) = runs
        err = float((lg - lc).abs().max())
        if not torch.equal(tg, tc) or err > LM_CPU_TOL * (1 + float(lc.abs().max())):
            raise AssertionError(f"{arch} reduced: card vs CPU tokens {tg.tolist()} vs "
                                 f"{tc.tolist()}, max |logit err| {err}")
        print(f"  {arch} reduced, fp32: card == CPU greedy tokens {tg[0].tolist()}; max "
              f"|logit difference| {err:.3g} (tolerance {LM_CPU_TOL})", flush=True)


def _finite(label: str, t: torch.Tensor) -> None:
    if not torch.isfinite(t).all():
        raise AssertionError(f"{label}: logits not finite")


def serve_batched(cfg, params, serve) -> dict:
    """Phase 6a: 8 requests of 2048 tokens prefilled into a cache of 2304
    slots, then 128 greedy decode steps; walls on the host clock ending in
    a synchronize, peak memory."""
    from repro_torch.models import init_cache

    dev = torch.device("cuda")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(dev)
    prefill, step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    cache = init_cache(cfg, SERVE_BATCH, SERVE_CACHE, device=dev)
    torch.cuda.reset_peak_memory_stats()
    sync()
    t = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    sync()
    t_prefill = time.perf_counter() - t
    _finite("6a prefill", logits)
    toks = []
    t = time.perf_counter()
    for i in range(SERVE_STEPS):
        tok = logits.argmax(-1, keepdim=True)
        toks.append(tok)
        logits, cache = step(params, cache, tok, SERVE_PROMPT + i)
    sync()
    t_decode = time.perf_counter() - t
    _finite("6a decode", logits)
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    cache_bytes = sum(t.numel() * t.element_size() for t in cache["layers"].values())
    floor_ms = (weight_bytes + cache_bytes) / MEM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    facts = {"prefill_s": t_prefill, "prefill_tok_s": SERVE_BATCH * SERVE_PROMPT / t_prefill,
             "decode_ms_step": t_decode / SERVE_STEPS * 1e3,
             "decode_tok_s": SERVE_BATCH * SERVE_STEPS / t_decode,
             "decode_floor_ms": floor_ms, "weight_bytes": weight_bytes,
             "cache_bytes": cache_bytes, "peak_bytes": peak,
             "first_tokens": torch.cat(toks[:8], 1)[0].tolist()}
    print(f"  6a: prefill {SERVE_BATCH} x {SERVE_PROMPT} tokens in {t_prefill:.4f} s "
          f"({facts['prefill_tok_s']:.0f} tokens/s); {SERVE_STEPS} decode steps of "
          f"{SERVE_BATCH} in {t_decode:.4f} s ({facts['decode_ms_step']:.3f} ms/step, "
          f"{facts['decode_tok_s']:.1f} tokens/s) against a floor of {floor_ms:.3f} ms/step "
          f"(weights {weight_bytes} B + cache {cache_bytes} B once a step); peak "
          f"{peak} B; request 0's first tokens {facts['first_tokens']}", flush=True)
    return facts


def serve_requests(cfg, params, serve) -> dict:
    """Phase 6b: requests at batch 1 with the prompt lengths of
    REQUEST_LENGTHS, each prefilled into its own cache, answering
    REQUEST_TOKENS greedy tokens."""
    from repro_torch.models import init_cache

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    prefill, step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    walls = []
    sync()
    t0 = time.perf_counter()
    for n in REQUEST_LENGTHS:
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(dev)
        t = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompt},
                                init_cache(cfg, 1, n + REQUEST_TOKENS, device=dev))
        for i in range(REQUEST_TOKENS):
            logits, cache = step(params, cache, logits.argmax(-1, keepdim=True), n + i)
        sync()
        _finite(f"6b request of {n}", logits)
        walls.append(time.perf_counter() - t)
    total = time.perf_counter() - t0
    print(f"  6b: {len(REQUEST_LENGTHS)} requests (prompts {list(REQUEST_LENGTHS)}), "
          f"{REQUEST_TOKENS} tokens each, in {total:.4f} s; per request "
          f"{[round(w, 4) for w in walls]} s", flush=True)
    return {"total_s": total, "walls_s": walls}


def serve_consistency(cfg, serve) -> dict:
    """Phase 6c: fp32 at full width (no TF32): prefill S - 4 tokens, decode
    4, against forward's logits at those positions, within CONSIST_TOL."""
    from dataclasses import replace

    from repro_torch.models import forward, init_cache, init_params
    from repro_torch.models.lm import unembed

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg32 = replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=SEED, device=dev)
    B, S, n = CONSIST_BATCH, CONSIST_S, CONSIST_DECODE
    tok = torch.from_numpy(np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size,
                                                                    (B, S))).to(dev)
    hidden, _, _ = forward(cfg32, params, {"tokens": tok})
    want = unembed(cfg32, params, hidden[:, S - n - 1:]).float()
    logits, cache = serve.make_prefill_step(cfg32)(params, {"tokens": tok[:, :S - n]},
                                                   init_cache(cfg32, B, S, device=dev))
    got = [logits]
    step = serve.make_decode_step(cfg32)
    for pos in range(S - n, S):
        logits, cache = step(params, cache, tok[:, pos:pos + 1], pos)
        got.append(logits)
    got = torch.stack(got, 1)
    _finite("6c", got)
    _finite("6c forward", want)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"  6c: fp32, B={B}, prefill {S - n} + decode {n} against forward at positions "
          f"{S - n - 1}..{S - 1}: max |logit difference| {err:.3g} (max |logit| "
          f"{scale:.3g}; tolerance {CONSIST_TOL})", flush=True)
    if err > CONSIST_TOL:
        raise AssertionError(f"6c: prefill/decode differ from forward by {err}")
    return {"max_abs_err": err, "max_abs_logit": scale}


def serve_breakdown(cfg, params, serve) -> dict:
    """Where phase 6a's time goes, outside the counted run: one 8 x 2048
    prefill and one decode step of 8 after it, each under torch.profiler —
    the host's time to enqueue, the wall to a synchronize, the kernels'
    device time summed, kernel launches and aten ops, and the three aten
    ops with the most device time.  A decode step's device idle share is 1
    - device / wall.  (`device_ms` cannot time a whole step: a step's
    thousands of launches fill the launch queue behind its spinning kernel.)
    A profile that sees no device time prints "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_cache

    dev = torch.device("cuda")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(dev)
    prefill, step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    cache = init_cache(cfg, SERVE_BATCH, SERVE_CACHE, device=dev)
    holder = {}

    def run_prefill():
        holder["logits"], _ = prefill(params, {"tokens": tokens}, cache)

    def run_decode():
        step(params, cache, holder["logits"].argmax(-1, keepdim=True), SERVE_PROMPT)

    out = {}
    for name, fn in (("prefill", run_prefill), ("decode", run_decode)):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            host = time.perf_counter() - t
            sync()
            wall = time.perf_counter() - t
        ka = prof.key_averages()
        dev_ms = sum(e.self_device_time_total for e in ka
                     if e.device_type == DeviceType.CUDA) / 1e3
        launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
        aten = sum(e.count for e in ka if e.key.startswith("aten::"))
        top = sorted((e for e in ka if e.key.startswith("aten::")),
                     key=lambda e: -e.self_device_time_total)[:3]
        row = {"host_ms": host * 1e3, "wall_ms": wall * 1e3, "device_ms": dev_ms or None,
               "launches": launches, "aten_ops": aten,
               "top": {e.key: e.self_device_time_total / 1e3 for e in top}}
        idle = f"device idle {1 - dev_ms / row['wall_ms']:.1%}" if dev_ms else "not measured"
        print(f"  6a {name} under the profiler: host enqueue {row['host_ms']:.2f} ms, wall "
              f"{row['wall_ms']:.2f} ms, kernels' device time "
              f"{f'{dev_ms:.2f} ms' if dev_ms else 'not measured'} ({idle}); {launches} "
              f"launches, {aten} aten ops; most device time: "
              f"{', '.join(f'{k} {v:.2f} ms' for k, v in row['top'].items())}", flush=True)
        out[name] = row
    return out


def serve_path(kops, kref) -> dict:
    """Phase 6: qwen3-1.7b served at full width and depth on the card, from
    random weights drawn on the card from a seed.  A warm-up (a prefill of
    8 x 128 tokens and one decode step) runs first, uncounted; then each
    sub-phase is counted on its own (`counted`).  Returns their facts and
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params

    cfg = get_config(SERVE_ARCH)
    t = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=torch.device("cuda"))
    sync()
    n = sum(p.numel() for p in params.parameters())
    if n != cfg.param_count() + (2 * cfg.num_layers + 1) * cfg.d_model + \
            2 * cfg.num_layers * cfg.resolved_head_dim:
        raise AssertionError(f"{SERVE_ARCH}: {n} parameters")
    print(f"  {SERVE_ARCH}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied; {n:,} parameters ({cfg.param_count():,} without the "
          f"norm scales), drawn on the card in {time.perf_counter() - t:.2f} s", flush=True)
    warm = torch.zeros((SERVE_BATCH, 128), dtype=torch.int64, device=params.tok_embed.device)
    logits, cache = serve.make_prefill_step(cfg)(params, {"tokens": warm},
                                                 init_cache(cfg, SERVE_BATCH, 129))
    serve.make_decode_step(cfg)(params, cache, logits.argmax(-1, keepdim=True), 128)
    del cache
    sync()
    out = {}
    for key, run in (("6a", lambda: serve_batched(cfg, params, serve)),
                     ("6b", lambda: serve_requests(cfg, params, serve))):
        facts, launches, plain, _cls = counted(kops, kref, run)
        out[key] = (facts, launches, plain)
        if key == "6a":
            facts["breakdown"] = serve_breakdown(cfg, params, serve)
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    facts, launches, plain, _cls = counted(kops, kref, lambda: serve_consistency(cfg, serve))
    out["6c"] = (facts, launches, plain)
    torch.cuda.empty_cache()
    return out


# Phase 7: the twins of the JAX package's examples (`repro_torch.examples`)
# on the card, each held to its own lines on the CPU; then Fig. 11's New to
# level 8 and the finite-volume solver at about 26 M leaves.
TWINS = ("quickstart", "amr_fractal", "multitree_cube", "fem_diffusion",
         "sfc_expert_placement", "serve_lm")
FIG11_LEVELS = (4, 5, 6, 7, 8)          # one tree; level 8 is 8^8 = 16,777,216 tets
FIG11_PASSES = 5                        # after one warm-up pass
FEM_FULL = (5, 9)                       # New's level and the blob's depth
SERVE_PREFILL_LAUNCHES = 20             # 2 layers x 10 prefills, fp32 at hd 32


SERVE_TOL = 2e-4          # serve_lm's decode logits, card against CPU, abs and rel
SERVE_TIE_GAP = 1e-4      # a top-2 gap under this may pick either token ...
SERVE_TIE_TOL = 1e-4      # ... if the logits agree within this


def twin_lines(name: str, device: str) -> tuple[list, dict, list]:
    """A twin's `main(device)`: its lines as `untimed` leaves them, the dict
    it returns and, for `serve_lm`, each decode step's logits in call order;
    on the CPU with one thread (its tensors are small)."""
    from repro_torch.examples import untimed

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    buf, held = io.StringIO(), []
    if name == "serve_lm":
        inner = mod.decode_step

        def recording(*args, **kw):
            logits, cache = inner(*args, **kw)
            held.append(logits[0].detach().clone())
            return logits, cache

        mod.decode_step = recording
    try:
        with contextlib.redirect_stdout(buf):
            r = mod.main(device=device)
        if device == "cuda":
            sync()
    finally:
        torch.set_num_threads(threads)
        if name == "serve_lm":
            mod.decode_step = inner
    return untimed(buf.getvalue()), r, [t.float().cpu().numpy() for t in held]


def serve_per_request(calls: list, n: int, B: int, max_new: int) -> list:
    """serve_lm's decode calls as each request's logits, step by step: the
    loop's slot schedule depends on counts only (a freed slot takes the
    next request, then every active slot decodes one token, in slot
    order), so replaying it maps each call to its request."""
    slots, queue, out, done = [None] * B, list(range(n)), [[] for _ in range(n)], 0
    calls = iter(calls)
    while done < n:
        for s in range(B):
            if slots[s] is None and queue:
                slots[s] = [queue.pop(0), max_new]
        for s in range(B):
            if slots[s] is None:
                continue
            out[slots[s][0]].append(next(calls))
            slots[s][1] -= 1
            if slots[s][1] == 0:
                slots[s] = None
                done += 1
    if next(calls, None) is not None:
        raise AssertionError("serve_lm made more decode calls than its schedule")
    return out


def serve_card_vs_cpu(got: dict, got_calls: list, want: dict, want_calls: list) -> dict:
    """serve_lm's tokens on the card against the CPU's, request by request,
    and each decode step's logits within SERVE_TOL; a differing token passes
    only at a near tie, and ends that request's comparison.  Returns the
    steps compared, the near ties and the largest |logit difference|."""
    n, B, m = want["requests"], want["B"], len(want["tokens"][0])
    got_l = serve_per_request(got_calls, n, B, m)
    want_l = serve_per_request(want_calls, n, B, m)
    steps, ties, worst = 0, 0, 0.0
    for r in range(n):
        for i, (g, w) in enumerate(zip(got_l[r], want_l[r])):
            err = float(np.abs(g - w).max())
            worst, steps = max(worst, err), steps + 1
            top2 = np.sort(w)[-2:]
            if got["tokens"][r][i] == want["tokens"][r][i]:
                tol, tie = SERVE_TOL, False
            elif top2[1] - top2[0] < SERVE_TIE_GAP:
                tol, tie = SERVE_TIE_TOL, True
            else:
                raise AssertionError(f"phase 7 serve_lm: request {r} step {i}: the card's "
                                     f"token {got['tokens'][r][i]}, the CPU's "
                                     f"{want['tokens'][r][i]}, top-2 gap {top2[1] - top2[0]}")
            if not np.all(np.abs(g - w) <= tol + tol * np.abs(w)):
                raise AssertionError(f"phase 7 serve_lm: request {r} step {i}: logits differ "
                                     f"by {err} (tolerance {tol})")
            if tie:
                ties += 1
                break
    return {"steps_compared": steps, "near_ties": ties, "max_abs_logit_err": worst}


def examples_path(kops, kref, smi: str) -> dict:
    """Phase 7.  (a) each twin's `main()` on the card, counted: its lines
    equal to its lines on the CPU, no plain version called, the kernels of
    its path launched (every kernel of phase 3's path in `quickstart` and
    `multitree_cube`, `tree_transform` in `multitree_cube`, `morton_key`,
    `decode` and `face_neighbor` called by `quickstart` itself, 20
    `flash_attention` launches in `serve_lm`'s prefills), and `serve_lm`'s
    tokens and decode logits equal to the CPU's on the same weights
    (`serve_card_vs_cpu`); (b) Fig. 11's New
    on one tree at levels 4-8, a warm-up pass and five more, each level's
    median wall and ns per element; (c) `fem_diffusion` with New at level 5 and the blob refined
    to level 9: leaves, pairs, walls, peak memory and the example's two
    assertions.  Returns the launches of each sub-phase and the facts."""
    from repro_torch.examples import amr_fractal, fem_diffusion

    device = torch.device("cuda")
    queries = ("successor", "face_neighbor")
    path3 = [k for k in REPLACES if k not in ("tree_transform", *queries)]
    must = {"quickstart": path3 + ["face_neighbor"], "multitree_cube": path3 + ["tree_transform"],
            "amr_fractal": ["morton_key", "decode", "children"],
            "fem_diffusion": ["morton_key", "decode", "children", "face_sweep"],
            "sfc_expert_placement": [], "serve_lm": ["flash_attention"]}
    facts, launches = {}, {}
    print(f"  (a) the twins' main() on the card against the CPU (card {smi})", flush=True)
    for name in TWINS:
        want, want_r, want_calls = twin_lines(name, "cpu")
        t = time.perf_counter()
        (got, r, calls), lc, pc, _cls = counted(kops, kref, lambda: twin_lines(name, "cuda"))
        wall = time.perf_counter() - t
        for line in got:
            print(f"    {name}: {line}", flush=True)
        if got != want:
            raise AssertionError(f"phase 7 {name}: the card's lines {got} differ from the "
                                 f"CPU's {want}")
        if any(pc.values()):
            raise AssertionError(f"phase 7 {name}: plain versions ran: {pc}")
        if not all(lc[k] > 0 for k in must[name]):
            raise AssertionError(f"phase 7 {name}: want {must[name]} launched: {lc}")
        if name == "serve_lm" and lc["flash_attention"] != SERVE_PREFILL_LAUNCHES:
            raise AssertionError(f"phase 7 serve_lm: flash_attention launched "
                                 f"{lc['flash_attention']} times, want {SERVE_PREFILL_LAUNCHES}")
        launches[name] = lc
        facts[name] = {"wall_s": wall, "lines_equal_cpu": True}
        if name == "serve_lm":
            same = serve_card_vs_cpu(r, calls, want_r, want_calls)
            print(f"    serve_lm: tokens equal to the CPU's on the same weights over "
                  f"{same['steps_compared']} decode steps ({same['near_ties']} near ties); "
                  f"logits within {SERVE_TOL} (max |err| {same['max_abs_logit_err']:.3e})",
                  flush=True)
            facts[name].update(serve_wall_s=r["wall_s"], **same)
        print(f"    {name}: lines equal to the CPU's; wall {wall:.3f} s; kernel launches "
              f"{ {k: v for k, v in lc.items() if v} }; no plain call", flush=True)

    print(f"  (b) Fig. 11: New on one tree, one rank, levels {FIG11_LEVELS[0]}-"
          f"{FIG11_LEVELS[-1]}, a warm-up pass and {FIG11_PASSES} more (card {smi})", flush=True)
    passes, lc = [], None
    for k in range(FIG11_PASSES + 1):        # pass 0 warms the allocator's cache
        rows, lc, pc, _cls = counted(kops, kref,
                                     lambda: amr_fractal.fig11(FIG11_LEVELS, device))
        if any(pc.values()) or lc["decode"] < len(FIG11_LEVELS):
            raise AssertionError(f"phase 7 Fig. 11: launches {lc}, plain calls {pc}")
        if k:
            passes.append(rows)
        else:
            print("    warm-up pass: " + ", ".join(f"level {x['level']} {x['wall_s'] * 1e3:.3f} ms"
                                                  for x in rows), flush=True)
    launches["fig11"] = lc
    median = {}
    for i, level in enumerate(FIG11_LEVELS):
        n = passes[0][i]["elements"]
        if n != 8 ** level:
            raise AssertionError(f"phase 7 Fig. 11: level {level} has {n} elements")
        walls = sorted(p[i]["wall_s"] for p in passes)
        median[level] = walls[len(walls) // 2] / n * 1e9
        print(f"    level {level}: {n:>11,} elements  median {walls[len(walls) // 2] * 1e3:.4f} ms "
              f"(min {walls[0] * 1e3:.4f}, max {walls[-1] * 1e3:.4f})  "
              f"{median[level]:.4f} ns/element", flush=True)
    ratio = median[FIG11_LEVELS[-1]] / median[6]
    print(f"    ns per element, level {FIG11_LEVELS[-1]} / level 6 (medians of {FIG11_PASSES} "
          f"passes): {ratio:.4f}", flush=True)
    facts["fig11"] = {"elements": {lv: 8 ** lv for lv in FIG11_LEVELS},
                      "wall_s": {lv: [p[i]["wall_s"] for p in passes]
                                 for i, lv in enumerate(FIG11_LEVELS)},
                      "ns_per_element_median": median, "ratio_8_to_6": ratio}

    level, deep = FEM_FULL
    print(f"  (c) fem_diffusion at full size: New at level {level}, the blob to level {deep} "
          f"(card {smi})", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sizes, originals = record_launch_sizes(kops)
    try:
        r, lc, pc, _cls = counted(kops, kref,
                                  lambda: fem_diffusion.run(level, deep, device=device))
    finally:
        for name, fn in originals.items():
            setattr(kops, name, fn)
    peak = torch.cuda.max_memory_allocated()
    if any(pc.values()) or not all(lc[k] > 0 for k in must["fem_diffusion"]):
        raise AssertionError(f"phase 7 fem_diffusion at full size: launches {lc}, plain {pc}")
    launches["fem_full"] = lc
    w = r["walls"]
    print(f"    {r['leaves']:,} leaves, levels {r['levels'][0]}..{r['levels'][1]}; "
          f"{r['pairs']:,} interior face pairs", flush=True)
    print(f"    walls: New {w['new']:.3f} s, Adapt {w['adapt']:.3f} s, Balance "
          f"{w['balance']:.3f} s, Iterate {w['iterate']:.3f} s, 60 steps {w['steps']:.3f} s; "
          f"peak device memory {peak:,} B", flush=True)
    for step, umax, err in r["shown"]:
        print(f"    step {step:3d}: max u = {umax:.4f}, conservation error = {err:.2e}",
              flush=True)
    if not (r["conservation_error"] < 1e-12 and r["max_u"] < 1.0):
        raise AssertionError(f"phase 7 fem_diffusion at full size: conservation error "
                             f"{r['conservation_error']}, max u {r['max_u']}")
    print(f"    conservation error {r['conservation_error']:.3e} < 1e-12, max u "
          f"{r['max_u']:.4f} < 1: the example's two assertions hold", flush=True)
    facts["fem_full"] = {"level": level, "deep": deep, "leaves": r["leaves"],
                         "pairs": r["pairs"], "walls_s": w, "peak_bytes": peak,
                         "conservation_error": r["conservation_error"], "max_u": r["max_u"],
                         "largest_launch": {k: max(v) for k, v in sizes.items() if v}}
    del r
    torch.cuda.empty_cache()
    # each kernel the solver's path launched, against its plain version at
    # the largest size that path gave it (random inputs of that size; exact)
    for name, ns in sizes.items():
        if ns:
            _inputs, kernel, plain = kernel_cases(3, max(ns), device)[name]
            _got, _want, err = compare_exact(f"phase 7 {name} n={max(ns)}", kernel, plain)
            print(f"    {name} at its largest launch, n = {max(ns):,} ({len(ns)} launches): "
                  f"equal to its plain version (max |err| {err})", flush=True)
            del _inputs, kernel, plain, _got, _want
            torch.cuda.empty_cache()
    return {"launches": launches, "facts": facts}


def marker_sweep_only(smi: str) -> int:
    """`--marker-sweep`: the launch cost, phases 2 and 2h's P sweeps and
    phase 3p alone (after the build and phase 3), and their rows as one
    JSON line: the same measurement run against another checkout's package
    (a parent design's, for a before/after table)."""
    cost = launch_cost(torch.device("cuda"))
    sweep = []
    for d in (3, 2):
        sweep += marker_sweep(d, kernel_cases(d, N_KERNEL, torch.device("cuda")))
        torch.cuda.empty_cache()
        sweep += marker_sweep(d, hex_kernel_cases(d, N_KERNEL, torch.device("cuda")), tag="hex ")
        torch.cuda.empty_cache()
    print("== 3. main path at full size", flush=True)
    _facts, fs, _comm, _gh = main_path()
    print(f"== 3p. owner_rank and eval_route on phase 3's leaves (card {smi})", flush=True)
    split = real_queries(fs)
    print(json.dumps({"launch_cost": cost, "marker_sweep": sweep, "phase3p": split,
                      "card": smi}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops as kops, ref as kref

    print("== 1. card and build", flush=True)
    smi = nvidia_smi_line()
    print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t = time.perf_counter()
    libs = build.build_all()
    print(f"  built {', '.join(lib.name for lib in libs)} from an empty build directory, "
          f"one nvcc each, started together, in {time.perf_counter() - t:.2f} s", flush=True)
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  {log.stem}: {line.strip()}")

    if sys.argv[1:] == ["--marker-sweep"]:
        return marker_sweep_only(smi)
    if sys.argv[1:2] == ["--walk-sweep"] and len(sys.argv) <= 3:
        return walk_sweep(smi) if len(sys.argv) == 2 else walk_compare(Path(sys.argv[2]), smi)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    print(f"== 2. kernel vs plain (bound: bytes / {MEM_BYTES_PER_S / 1e12} TB/s; "
          f"card {smi})", flush=True)
    rows, sweep = {}, {}
    for d in (3, 2):
        rows[d], sweep[d] = kernel_vs_plain(d, N_KERNEL, torch.device("cuda"))
    cost = launch_cost(torch.device("cuda"))

    print(f"== 2h. hex kernel vs plain (bound: bytes / {MEM_BYTES_PER_S / 1e12} TB/s; "
          f"card {smi})", flush=True)
    hex_rows, hex_sweep = {}, {}
    for d in (3, 2):
        hex_rows[d], hex_sweep[d] = hex_kernel_vs_plain(d, N_KERNEL, torch.device("cuda"))

    print(f"== 2a. flash_attention vs plain (bound: max(FLOP / {TC_FLOPS_PER_S / 1e12:.0f} "
          f"TFLOP/s, bytes / {MEM_BYTES_PER_S / 1e12} TB/s); card {smi})", flush=True)
    flash = {**flash_vs_plain(kops, kref), "sass": flash_instructions(build)}

    print("== 3. main path at full size", flush=True)
    sizes, originals = record_launch_sizes(kops)
    (facts3, fs, comm, gh), launches, plain_calls, _cls = counted(kops, kref, main_path)
    ref3 = {"digests": field_digests(fs, gh), "bytes": facts3["bytes"], "walls": facts3["wall_s"],
            "peak_bytes": facts3["peak_bytes"], "launches": launches}
    runs = {"phase 3": {"unbalanced": facts3.pop("unbalanced"), "balanced": fs, "ghosts": gh,
                        "P": 4, "cmesh": None, "max_level": 8, "eclass": "simplex",
                        "bytes": {k: facts3["bytes"][k] for k in ("balance", "ghost")}}}
    print("== 3d. element queries on phase 3's forests", flush=True)
    _walls, launches_d, plain_calls_d, _cls = counted(kops, kref,
                                                      lambda: element_queries(fs, comm))
    face_neighbor_vs_plain(max(fs, key=lambda f: f.num_local), kops, kref)
    del fs, gh
    torch.cuda.empty_cache()
    print("== 3c. the coarse-mesh path at full size", flush=True)
    (facts_c, unbalanced, balanced, gh, cm), launches_c, plain_calls_c, _cls = counted(
        kops, kref, cmesh_path)
    for name, fn in originals.items():
        setattr(kops, name, fn)
    print(f"== 3p. owner_rank and eval_route on phase 3's leaves (card {smi})", flush=True)
    split = real_queries(runs["phase 3"]["balanced"])
    check_level_jumps(unbalanced, balanced, TREE_FACES_LEVEL)
    runs["phase 3c"] = {"unbalanced": unbalanced, "balanced": balanced, "ghosts": gh, "P": 4,
                        "cmesh": cm, "max_level": 7, "eclass": "simplex",
                        "bytes": {k: facts_c["bytes"][k] for k in ("balance", "ghost")}}
    del unbalanced, balanced, gh
    forest_counts = forest_phases(runs, kops, kref)
    del runs
    torch.cuda.empty_cache()

    print("== 3h. the hex path at full size", flush=True)
    (facts_h, unbalanced, balanced, comm_h, gh, cm), launches_h, plain_calls_h, cls_h = counted(
        kops, kref, hex_path)
    check_level_jumps(unbalanced, balanced, TREE_FACES_LEVEL)
    torch.cuda.empty_cache()
    print("== 3h. element queries on phase 3h's forests", flush=True)
    _walls, launches_hq, plain_calls_hq, cls_hq = counted(
        kops, kref, lambda: element_queries(balanced, comm_h))
    face_neighbor_vs_plain(max(balanced, key=lambda f: f.num_local), kops, kref)
    runs = {"phase 3h": {"unbalanced": unbalanced, "balanced": balanced, "ghosts": gh, "P": 4,
                         "cmesh": cm, "max_level": 8, "eclass": "hex",
                         "bytes": {k: facts_h["bytes"][k] for k in ("balance", "ghost")}}}
    del unbalanced, balanced, gh
    for phase, counts_h in forest_phases(runs, kops, kref).items():
        forest_counts[phase] += counts_h
    del runs
    torch.cuda.empty_cache()

    print(f"== 3t. the d = 2 main path at full size (card {smi})", flush=True)
    _facts_t, launches_t, plain_calls_t, sizes_t = d2_path(kops, kref)

    print(f"== 3m. phase 3 as {MULTI_P} rank processes on the card (card {smi})", flush=True)
    multi = multi_process_path(ref3)
    print(f"== 3r. resilience on the card: (a) byte faults at full size (card {smi})", flush=True)
    chaos, launches_ra, plain_calls_ra, _cls = counted(kops, kref, lambda: chaos_path(ref3))
    torch.cuda.empty_cache()
    print(f"== 3r. (b) kill rank 3 of {MULTI_P} mid-Balance, recover onto 3 (card {smi})",
          flush=True)
    killed = kill_one_rank()
    torch.cuda.empty_cache()

    print(f"== 3b. kernels at the sizes phases 3, 3c and 3d launched (card {smi})", flush=True)
    time_at_launch_sizes(sizes)
    print(f"== 3b. morton_key and decode at the sizes phase 3t launched, d = 2 (card {smi})",
          flush=True)
    time_at_launch_sizes({k: sizes_t[k] for k in ("morton_key", "decode")}, d=2)
    new_uniform_methods()

    print("== 4. card vs CPU", flush=True)
    card_vs_cpu()
    lm_card_vs_cpu()

    print(f"== 6. serving {SERVE_ARCH} at full width and depth (card {smi})", flush=True)
    served = serve_path(kops, kref)

    print(f"== 7. the examples' twins on the card (card {smi})", flush=True)
    examples = examples_path(kops, kref, smi)
    launches7 = {k: sum(lc[k] for lc in examples["launches"].values()) for k in kops.launch_counts}
    print(f"  kernel launches in phase 7, summed over (a)-(c): {launches7}", flush=True)

    print("== 5. launch counts", flush=True)
    print(f"  kernel launches in phase 3: {launches}; plain calls: {plain_calls}", flush=True)
    print(f"  kernel launches in phase 3c: {launches_c}; plain calls: {plain_calls_c}",
          flush=True)
    print(f"  kernel launches in phase 3d: {launches_d}; plain calls: {plain_calls_d}",
          flush=True)
    print(f"  kernel launches in phase 3t: {launches_t}; plain calls: {plain_calls_t}",
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
    hex_of = {k: cls_h[k]["hex"] for k in REPLACES}
    hex_q = {k: cls_hq[k]["hex"] for k in REPLACES}
    print(f"  hex-body launches in phase 3h: {hex_of}; in its queries: {hex_q}; plain calls: "
          f"{plain_calls_h}, {plain_calls_hq}", flush=True)
    if not all(hex_of[k] > 0 for k in REPLACES if k not in queries[1:]):
        raise AssertionError(f"a hex body was not launched on the phase-3h path: {hex_of}")
    if not all(hex_q[k] > 0 for k in queries):
        raise AssertionError(f"a hex query body was not launched in phase 3h: {hex_q}")
    if any(v["simplex"] for v in cls_h.values()) or any(v["simplex"] for v in cls_hq.values()):
        raise AssertionError("a simplex body ran on the hex path")
    if any(plain_calls_h.values()) or any(plain_calls_hq.values()):
        raise AssertionError(f"plain versions ran on the hex path: {plain_calls_h}, "
                             f"{plain_calls_hq}")
    check_forest_phase_launches(forest_counts)
    path3 = [k for k in REPLACES if k not in ("tree_transform", *queries[1:])]
    launches_r = {k: launches_ra[k] + killed["launches"][k] for k in REPLACES}
    print(f"  kernel launches in phase 3m (summed over the ranks): {multi['launches']}; in 3r(a): "
          f"{launches_ra}, plain calls {plain_calls_ra}; in 3r(b) (survivors and the recovery "
          f"world): {killed['launches']}; no plain call in any rank process", flush=True)
    for label, lc in (("3t", launches_t), ("3m", multi["launches"]), ("3r(a)", launches_ra),
                      ("3r", launches_r)):
        if not all(lc[k] > 0 for k in path3):
            raise AssertionError(f"phase {label}: a kernel of phase 3's path was not launched: {lc}")
    if any(plain_calls_ra.values()) or any(plain_calls_t.values()):
        raise AssertionError(f"plain versions ran in phase 3r(a) or 3t: {plain_calls_ra}, "
                             f"{plain_calls_t}")
    hybrid_face_sweeps(kops)
    prefills = {"6a": 1, "6b": len(REQUEST_LENGTHS), "6c": 2}     # 6c: prefill and forward
    layers = get_config(SERVE_ARCH).num_layers
    for key, (_facts, lc, pc) in served.items():
        print(f"  phase {key}: kernel launches {lc}; plain calls {pc}", flush=True)
        if lc["flash_attention"] != layers * prefills[key] or any(pc.values()):
            raise AssertionError(f"phase {key}: flash_attention launched "
                                 f"{lc['flash_attention']} times, want {layers} x "
                                 f"{prefills[key]}; plain calls {pc}")
    kernels = []
    for name in REPLACES:
        r = next(x for x in rows[3] if x["name"] == name)
        r2 = next(x for x in rows[2] if x["name"] == name)
        entry = {
            "name": f"{name}_kernel", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name] or launches_c[name] or launches_d[name],
            "launches_phase3": launches[name], "launches_phase3c": launches_c[name],
            "launches_phase3d": launches_d[name], "launches_phase3t": launches_t[name],
            **{f"launches_phase{ph}": sum(row[1][name] for row in forest_counts[ph])
               for ph in ("3o", "3k", "3i")},
            "launches_phase3m": multi["launches"][name], "launches_phase3r": launches_r[name],
            "launches_phase7": launches7[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "d": 3, "n": r["n"],
            "ms_d2": r2["ms"], "device_ms_d2": r2["device_ms"], "bound_ms_d2": r2["bound_ms"]}
        if name in ("eval_route", "owner_rank"):
            for dd, sfx in ((3, ""), (2, "_d2")):
                pts = [x for x in sweep[dd] if x["name"] == name]
                entry.update({f"sweep_device_ms{sfx}": {x["P"]: x["device_ms"] for x in pts},
                              f"sweep_bound_ms{sfx}": {x["P"]: x["bound_ms"] for x in pts}})
            entry["max_abs_err_sweep"] = max(x["max_abs_err"] for dd in (3, 2)
                                             for x in sweep[dd] if x["name"] == name)
            entry.update({f"phase3p_{k}": {x["P"]: x[k] for x in split if x["name"] == name}
                          for k in ("device_ms", "bound_ms")})
            entry["host_us_a_launch"] = {f"d={x['d']} P={x['P']}": x["enqueue_us"]
                                         for x in cost if x["name"] == name}
        entry.update({"hex_replaces": HEX_REPLACES[name],
                      "hex_launches_phase3h": hex_of[name] + hex_q[name]})
        h3 = next((x for x in hex_rows[3] if x["name"] == name), None)
        if h3 is not None:      # owner_rank has one body for both classes
            h2 = next(x for x in hex_rows[2] if x["name"] == name)
            entry.update({"hex_max_abs_err": max(h3["max_abs_err"], h2["max_abs_err"]),
                          "hex_ms": h3["ms"], "hex_device_ms": h3["device_ms"],
                          "hex_plain_ms": h3["plain_ms"], "hex_bound_ms": h3["bound_ms"],
                          "hex_ms_d2": h2["ms"], "hex_device_ms_d2": h2["device_ms"],
                          "hex_plain_ms_d2": h2["plain_ms"], "hex_bound_ms_d2": h2["bound_ms"]})
        if name == "eval_route":
            for dd, sfx in ((3, ""), (2, "_d2")):
                entry.update({f"hex_sweep_device_ms{sfx}": {x["P"]: x["device_ms"]
                                                            for x in hex_sweep[dd]},
                              f"hex_sweep_bound_ms{sfx}": {x["P"]: x["bound_ms"]
                                                           for x in hex_sweep[dd]}})
        kernels.append(entry)
    kernels.append({
        "name": "flash_attention_kernel", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": served["6a"][1]["flash_attention"],
        "launches_phase6b": served["6b"][1]["flash_attention"],
        "launches_phase6c": served["6c"][1]["flash_attention"],
        "launches_phase7": launches7["flash_attention"], **flash,
        "serve": {k: v[0] for k, v in served.items()}})
    print(json.dumps({"runtime": {"3m": {k: v for k, v in multi.items() if k != "launches"},
                                  "3r_faults": chaos,
                                  "3r_kill": {k: v for k, v in killed.items() if k != "launches"}},
                      "examples": examples["facts"]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
