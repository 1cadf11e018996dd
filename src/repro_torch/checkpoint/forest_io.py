"""Forest checkpoints: packed at-rest blobs and partition markers, elastic.

Counterpart of `repro.checkpoint.forest_io`, byte for byte: a checkpoint
holds the paper's Remark 20 encoding (`core.types.pack`: int32 coordinates,
int8 level, int8 type; 10 / 14 bytes a simplex, and 9 / 13 a hex, which
has no type column) of the GLOBAL leaf sequence in (tree, key) order, its
tree column, the partition markers of the ranks that wrote it (keys as hi
and lo uint32 words), a CRC32 of every column in the manifest, and, over a
mesh of two classes, the per-tree class column.  The manifest's "eclass"
is 0 (simplex, also when absent), 1 (hex) or "mixed"; a non-simplex
checkpoint restores only with its coarse mesh.

Restore is elastic: onto the writer's rank count the saved markers give the
same partition; onto another the global sequence is split into equal
contiguous runs; with weights by the paper's weighted Partition rule
(`placement.target_ranks_np`), landing where `forest.repartition` would.
Every restored column is CRC32-checked, the count cross-checked, and the
global sequence must pass `forest.validate` on the target device before it
is sliced onto the ranks; any failure raises `CheckpointIntegrityError`.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path

import numpy as np
import torch

from ..core import forest as forest_mod
from ..core.batch import lex_search
from ..core.cmesh import Cmesh
from ..core.comm import Comm
from ..core.errors import CheckpointIntegrityError
from ..core.forest import Forest, partition_markers
from ..core.placement import target_ranks_np
from ..core.types import ECLASS_HEX, ECLASS_SIMPLEX, Simplex, pack, resolve_device, to_numpy
from .store import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_forest", "load_forest"]


def _column_crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _gather_global(forests: list[Forest], comm: Comm):
    """The global (anchor int32, level int8, stype int8, tree int32) host
    columns: one allgather of every rank's, concatenated in rank order,
    which is the global SFC order (the partition invariant)."""
    parts = comm.allgather([(to_numpy(f.anchor).astype(np.int32),
                             to_numpy(f.level).astype(np.int8),
                             to_numpy(f.stype).astype(np.int8),
                             to_numpy(f.tree).astype(np.int32)) for f in forests])
    return tuple(np.concatenate([p[c] for p in parts]) for c in range(4))


def save_forest(path, forests: list[Forest], comm: Comm, *, step: int = 0):
    """Persist the forests as packed blobs and partition markers, under
    <path>/step_<step>; returns that directory.

    Collective: every rank takes part in the gather (the "checkpoint"
    phase); the process hosting global rank 0 writes, then all meet at
    `comm.barrier()`."""
    f0 = forests[0]
    cm = f0.cmesh
    ecs = f0.eclasses
    with comm.phase("checkpoint"):
        anchor, level, stype, tree = _gather_global(forests, comm)
        mt, mk = partition_markers(forests, comm)
    s = Simplex(anchor, level.astype(np.int32), stype.astype(np.int32))
    if ecs == (ECLASS_HEX,):
        blob, eclass_meta = pack(s, eclass=ECLASS_HEX), ECLASS_HEX
    else:   # simplex, or mixed (the type column is 0 on hex rows)
        blob = pack(s)
        eclass_meta = ECLASS_SIMPLEX if len(ecs) == 1 else "mixed"
    payload = {
        "anchor": blob["anchor"],
        "level": blob["level"],
        "tree": tree,
        "marker_tree": mt,
        "marker_key_hi": (mk >> np.uint64(32)).astype(np.uint32),
        "marker_key_lo": (mk & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    }
    if "stype" in blob:
        payload["stype"] = blob["stype"]
    if eclass_meta == "mixed":
        payload["tree_eclass"] = np.asarray(cm.tree_eclass, np.int32)
    meta = {"kind": "forest", "d": int(f0.d), "num_trees": int(f0.num_trees),
            "num_ranks": int(comm.size), "count": int(len(level)), "eclass": eclass_meta,
            "crc32": {k: _column_crc(v) for k, v in payload.items()}}
    out = (save_checkpoint(path, payload, step=step, extra_meta=meta)
           if 0 in comm.local_ranks else None)
    comm.barrier()
    return out


def load_forest(path, comm: Comm, *, step: int | None = None, cmesh: Cmesh | None = None,
                weights=None, verify: bool = True, device=None) -> list[Forest]:
    """Restore a forest checkpoint onto `comm`, on `device` (the card by
    default), elastically: at the writer's rank count the saved markers
    split it as it was; at another rank count into equal contiguous runs;
    with `weights` (one nonnegative float per GLOBAL element, in the saved
    order) by the weighted Partition rule, at any rank count.  A hex or
    mixed checkpoint needs its `cmesh`.  With `verify` every column's CRC32,
    the element count and `validate` of the global sequence are checked
    first, and any failure, an unreadable or truncated blob included,
    raises `CheckpointIntegrityError`.  Returns one Forest per local
    rank."""
    dev = resolve_device(device)
    eclass_meta = _peek_eclass(path, step)
    cols = ["anchor", "level", "tree", "marker_tree", "marker_key_hi", "marker_key_lo"]
    if eclass_meta != ECLASS_HEX:
        cols.insert(2, "stype")
    if eclass_meta == "mixed":
        cols.append("tree_eclass")
    try:
        payload, manifest = restore_checkpoint(path, dict.fromkeys(cols, np.zeros(0, np.uint8)),
                                               step=step)
    except (CheckpointIntegrityError, FileNotFoundError):
        raise
    except Exception as e:
        raise CheckpointIntegrityError(f"unreadable forest checkpoint at {path!s}: {e}") from e
    meta = manifest.get("meta", {})
    if meta.get("kind") != "forest":
        raise CheckpointIntegrityError(f"not a forest checkpoint: kind={meta.get('kind')!r}")
    if verify and meta.get("crc32") is not None:
        for k, v in payload.items():
            want, got = meta["crc32"].get(k), _column_crc(v)
            if want is None or int(want) != got:
                raise CheckpointIntegrityError(
                    f"checkpoint column {k!r} failed its integrity check: stored "
                    f"crc32={want}, recomputed {got} — the blob was corrupted or truncated "
                    "at rest")
    d, num_trees = int(meta["d"]), int(meta["num_trees"])
    anchor = np.asarray(payload["anchor"], np.int32).reshape(-1, d)
    level = np.asarray(payload["level"], np.int32).reshape(-1)
    N = len(level)
    stype = (np.asarray(payload["stype"], np.int32).reshape(-1) if "stype" in payload
             else np.zeros(N, np.int32))
    tree = np.asarray(payload["tree"], np.int32).reshape(-1)
    if eclass_meta != ECLASS_SIMPLEX:
        if cmesh is None:
            raise CheckpointIntegrityError(
                f"checkpoint at {path!s} holds a non-simplex mesh (eclass={eclass_meta!r}); "
                "pass the matching cmesh to load_forest")
        if eclass_meta == "mixed":
            saved = np.asarray(payload["tree_eclass"], np.int32).reshape(-1)
            if not np.array_equal(saved, np.asarray(cmesh.tree_eclass)):
                raise CheckpointIntegrityError(
                    "checkpoint per-tree element classes disagree with the given cmesh")
        elif tuple(cmesh.eclasses) != (ECLASS_HEX,):
            raise CheckpointIntegrityError(
                f"hex checkpoint restored against a cmesh with classes {cmesh.eclasses}")
    if verify:
        want_n = int(meta.get("count", N))
        if not len(anchor) == len(stype) == len(tree) == N == want_n:
            raise CheckpointIntegrityError(
                f"checkpoint element counts disagree: manifest says {want_n}, columns hold "
                f"{(len(anchor), N, len(stype), len(tree))}")
    # the global sequence on the device, keys encoded per class
    gf = forest_mod._empty(d, num_trees, 0, 1, dev, cmesh).replace_elements(
        *(torch.from_numpy(c) for c in (anchor, level, stype, tree)))
    if verify:
        try:
            ok = forest_mod.validate([gf])
        except Exception as e:
            raise CheckpointIntegrityError(f"restored forest failed validate(): {e}") from e
        if not ok:
            raise CheckpointIntegrityError(
                "restored forest failed validate(): the checkpoint decodes but is not a "
                "well-formed global SFC sequence (order, overlap, root containment, or "
                "coverage violated)")
    P = comm.size
    if weights is not None:
        w = to_numpy(weights).astype(np.float64).reshape(-1)
        if len(w) != N:
            raise ValueError(f"need one weight per saved element: {len(w)} vs {N}")
        t = target_ranks_np(np.cumsum(w) - w / 2.0, P, float(w.sum()))
        bounds = np.searchsorted(t, np.arange(P + 1)).tolist()
    elif P == int(meta["num_ranks"]):
        # the saved markers: rank r starts at the first (tree, key) lex->= its marker
        mt = np.asarray(payload["marker_tree"], np.int64).reshape(-1)
        mk = ((np.asarray(payload["marker_key_hi"], np.uint64).reshape(-1) << np.uint64(32))
              | np.asarray(payload["marker_key_lo"], np.uint64).reshape(-1))
        starts = lex_search(gf.tree, gf.keys, torch.from_numpy(mt).to(dev),
                            torch.from_numpy(mk.astype(np.int64)).to(dev))
        bounds = starts.tolist() + [N]
    else:
        bounds = [(N * r) // P for r in range(P + 1)]
    out = []
    for g in comm.local_ranks:
        a, b = bounds[g], bounds[g + 1]
        out.append(dataclasses.replace(
            gf, rank=g, num_ranks=P, anchor=gf.anchor[a:b], level=gf.level[a:b],
            stype=gf.stype[a:b], tree=gf.tree[a:b], keys=gf.keys[a:b]))
    return out


def _peek_eclass(path, step):
    """The manifest's "eclass" (0 when absent: older checkpoints are
    simplex) without restoring a column."""
    p = Path(path)
    if step is None:
        step = latest_step(p)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    mf = p / f"step_{step}" / "manifest.json"
    try:
        meta = json.loads(mf.read_text()).get("meta", {})
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointIntegrityError(
            f"unreadable forest checkpoint manifest at {mf}: {e}") from e
    return meta.get("eclass", ECLASS_SIMPLEX)
