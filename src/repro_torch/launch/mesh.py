"""Production meshes on a torch `DeviceMesh` (counterpart of the JAX
package's `repro.launch.mesh`).

Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2, data=16,
model=16), 512 ranks; 'pod' is a second data-parallel axis, whose
collectives cross the slow links between pods (the gradient reduction
only; `optim.compression` has the int8 cross-pod mean).

A mesh needs a process group of its size.  `init_fake_process_group`
gives one of any size in a single process (`torch.distributed`'s fake
backend: collectives return at once and move nothing), on which the dry
run traces a production mesh.  The spec functions read only the axis
names and sizes, so they take a `DeviceMesh` or a `MeshShape`, which needs
no process group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["MeshShape", "axis_sizes", "make_production_mesh", "make_host_mesh", "dp_axes",
           "batch_spec_axes", "production_shape", "init_fake_process_group", "mesh_device"]


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices or a process group."""
    mesh_dim_names: tuple
    shape: tuple


def production_shape(multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or `MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_device(device=None) -> str:
    """The device type of a mesh: "cuda" unless `device` says otherwise;
    raises without a card."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a CPU mesh")
    return kind


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """A process group of `world_size` ranks in this one process, as rank
    `rank` (the fake backend: collectives return at once and move no
    data).  Replaces a group already initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"), on the default process group (256 or 512 ranks)."""
    names, shape = production_shape(multi_pod)
    return init_device_mesh(mesh_device(device), shape, mesh_dim_names=names)


def make_host_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """(world // model_parallel, model_parallel) over ("data", "model") on
    the default process group (tests, examples, one card)."""
    n = dist.get_world_size()
    dp = max(1, n // model_parallel)
    return init_device_mesh(mesh_device(device), (dp, model_parallel),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def batch_spec_axes(mesh, batch: int) -> tuple:
    """The largest prefix of the data-parallel axes whose product divides
    `batch` (possibly none: long_500k has a global batch of 1)."""
    sizes = axis_sizes(mesh)
    axes, prod = [], 1
    for a in dp_axes(mesh):
        if batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)
