"""Core of the port: SFC tables, element types and ops, the batched-ops seam,
the in-process comm layer, the partition rule, and the forest.

Layers, as in the JAX package's `repro.core`:
  tables     — derived lookup tables (types, TM order, neighbors, Prop. 23)
  types      — the Simplex struct of tensors, byte encodings at rest and on the wire
  keys       — int64 level-padded keys and their spans
  ops        — the element algorithms of paper Section 4, batched
  batch      — `BatchedOps`: the element ops over kernels or plain versions
  cmesh      — coarse-mesh inter-tree connectivity (gluing tables, transforms)
  comm       — the Comm surface: SimComm / LocalComm + byte meters
  forest     — forest-of-trees AMR: New / Adapt / Partition / Balance / Ghost
  placement  — the partition rule

The package exports the JAX package's names but these, on purpose:
`u64` (keys are native int64), `get_backend`, `set_backend` and
`use_backend` (no backend knob: a tensor's device chooses kernel or plain
version), and `DistComm` (not ported yet).
"""

from .tables import MAXLEVEL, SFCTables, get_tables
from .types import Simplex, root, simplex
from .ops import SimplexOps, get_ops, ops2d, ops3d
from .batch import BatchedOps, get_batch_ops
from .comm import Comm, LocalComm, SimComm
from .cmesh import (
    Cmesh,
    cmesh_brick,
    cmesh_disconnected,
    cmesh_rotated_pair,
    cmesh_single,
    cmesh_unit_cube,
)

__all__ = [
    "MAXLEVEL",
    "SFCTables",
    "get_tables",
    "Cmesh",
    "cmesh_brick",
    "cmesh_disconnected",
    "cmesh_rotated_pair",
    "cmesh_single",
    "cmesh_unit_cube",
    "Simplex",
    "root",
    "simplex",
    "SimplexOps",
    "get_ops",
    "ops2d",
    "ops3d",
    "BatchedOps",
    "Comm",
    "LocalComm",
    "SimComm",
    "get_batch_ops",
]
