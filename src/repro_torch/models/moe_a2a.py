"""Expert-parallel MoE dispatch over an all-to-all: not ported yet.

The JAX package's `repro.models.moe_a2a` shards the tokens and the experts
over a mesh's 'model' axis and moves token payloads with one all-to-all
each way; it runs only where `set_moe_impl` installed a mesh whose model
axis is above 1.  The port has no mesh yet (ROADMAP.md §1, item 6: the
launch tooling), so `moe.moe_layer` runs every MoE layer and
`set_moe_impl` refuses a mesh.
"""

from __future__ import annotations

__all__ = ["set_moe_impl"]


def set_moe_impl(mesh=None) -> None:
    """Install the all-to-all dispatch on `mesh`; with mesh=None (no
    dispatch, the only state the port has) it does nothing."""
    if mesh is not None:
        raise NotImplementedError("the all-to-all MoE dispatch needs a mesh, not ported yet "
                                  "(ROADMAP.md §1, item 6: the launch tooling's DeviceMesh)")
