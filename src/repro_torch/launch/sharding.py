"""Parameter / optimizer / batch / cache sharding rules on a DeviceMesh
(counterpart of the JAX package's `repro.launch.sharding`).

Path-name rules: every parameter's leaf name maps to a spec over ('model',
fsdp axes), as in the JAX package:

  TP ('model'):   attention heads (wq/wk/wv in, wo out), FFN hidden
                  (w_gate/w_up in, w_down out), vocab (tok_embed rows /
                  out_head cols), experts (leading E dim = expert parallel),
                  MLA up-projections, RG-LRU width.
  FSDP ('data', and 'pod' on two pods): the other large dim of each matrix
                  when cfg.fsdp (ZeRO-3: `models.spmd.use` all-gathers a
                  weight at its use, a layer at a time, and its gradient
                  is reduce-scattered back).
  Replicated:     norms, scalars, routers, small SSM tensors.

A spec is a tuple with one entry a tensor dimension, as `PartitionSpec`
has it: None, an axis name, or a tuple of axis names; () is replicated.
The port keeps one parameter a layer where the JAX package stacks the
layers on a leading axis; the rules apply to the last dims in both, so the
JAX spec of a stacked leaf is the port's with a leading None.  Dims that
do not divide fall back to replication.  `to_named` turns a spec into
DTensor placements (`Shard(dim)` on each named mesh dimension, a dim over
('pod', 'data') sharded on both, `Replicate()` elsewhere), and
`distribute_params` / `distribute_tree` carry tensors onto the mesh.
"""

from __future__ import annotations

from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.config import ModelConfig
from ..models.spmd import to_placements
from ..optim import OptState
from ..optim.optimizers import stack_key
from .mesh import axis_sizes, batch_spec_axes, dp_axes

__all__ = ["param_pspec", "params_pspecs", "opt_state_pspecs", "batch_pspecs", "cache_pspecs",
           "to_named", "distribute_params", "distribute_tree", "spec_divisor"]

# leaf name -> axes template applied to the LAST len(template) dims
# 'tp' = model axis, 'fsdp' = data axes (if cfg.fsdp), None = replicate
_RULES: dict[str, tuple] = {
    "tok_embed": ("tp", "fsdp"),
    "out_head": ("fsdp", "tp"),
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "router": (None, None),
    # expert parallel when E divides the model axis; otherwise fall back to
    # tensor-parallel inside each expert (mixtral: E=8 < model=16)
    "experts_gate": ("tp", "fsdp", None),
    "experts_up": ("tp", "fsdp", None),
    "experts_down": ("tp", None, "fsdp"),
    "shared_gate": (None, "fsdp", "tp"),
    "shared_up": (None, "fsdp", "tp"),
    "shared_down": (None, "tp", "fsdp"),
    "q_down": ("fsdp", None),
    "q_up": (None, "tp"),
    "kv_down": ("fsdp", None),
    "k_up": (None, "tp"),
    "v_up": (None, "tp"),
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "gate_proj": ("fsdp", "tp"),
    "w_r": (None, "tp"),
    "w_i": (None, "tp"),
    "conv_w": (None, "tp"),
    "mtp_proj": ("fsdp", None),
}

_EXPERT_FALLBACK = {
    # when num_experts doesn't divide the model axis: TP inside each expert
    "experts_gate": (None, "fsdp", "tp"),
    "experts_up": (None, "fsdp", "tp"),
    "experts_down": (None, "tp", "fsdp"),
}


def _leaf_name(path: str) -> str:
    """The last name of a dotted path that is not a layer index."""
    for part in reversed(path.split(".")):
        if not part.isdigit() and part != "*":
            return part
    return ""


def param_pspec(cfg: ModelConfig, mesh, path: str, leaf) -> tuple:
    """The spec of the parameter `path` ("layers.3.attn.wq") of `leaf`'s
    shape."""
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    tmpl = _RULES.get(name)
    if tmpl is None or ndim == 0:
        return ()
    sizes = axis_sizes(mesh)
    k = len(tmpl)
    if cfg.parallelism == "fsdp_sp":
        # pure FSDP: shard the first dim that divides over ALL mesh axes
        all_ax = tuple(mesh.mesh_dim_names)
        total = 1
        for a in all_ax:
            total *= sizes[a]
        for i in range(k):
            dim = ndim - k + i
            if dim >= 0 and tmpl[i] is not None and shape[dim] % total == 0:
                axes = [None] * ndim
                axes[dim] = all_ax
                return tuple(axes)
        return ()
    if name in _EXPERT_FALLBACK and shape[ndim - 3] % sizes.get("model", 1) != 0:
        tmpl = _EXPERT_FALLBACK[name]
    tp_size = sizes.get("model", 1)
    # FSDP spans every data-parallel axis present (pod + data on two pods)
    fsdp_ax = dp_axes(mesh) if cfg.fsdp else ()
    fsdp_size = 1
    for a in fsdp_ax:
        fsdp_size *= sizes[a]
    axes: list = [None] * ndim
    for i, a in enumerate(tmpl):
        dim = ndim - k + i
        if dim < 0 or a is None:
            continue
        if a == "tp" and tp_size > 1 and shape[dim] % tp_size == 0:
            axes[dim] = "model"
        elif a == "fsdp" and fsdp_ax and shape[dim] % fsdp_size == 0:
            axes[dim] = fsdp_ax if len(fsdp_ax) > 1 else fsdp_ax[0]
    return tuple(axes)


def _named(params) -> dict:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def params_pspecs(cfg: ModelConfig, mesh, params) -> dict:
    """{parameter name: spec} of a module's parameters (or a flat dict of
    tensors)."""
    return {n: param_pspec(cfg, mesh, n, p) for n, p in _named(params).items()}


def opt_state_pspecs(cfg: ModelConfig, mesh, pspecs: dict, params, optimizer: str) -> OptState:
    """The specs of `optim.init_opt_state(params, optimizer)`: AdamW's
    moments share their parameter's spec; Adafactor keeps factored (row,
    col) states with the matching sub-specs, a stacked group
    "<root>.*.<path>" (its state of the JAX package's stacked leaf) under
    the member's spec with a leading None."""
    if optimizer == "adamw":
        return OptState((), dict(pspecs), dict(pspecs))
    named = _named(params)
    stacked = getattr(params, "stacked_roots", ())
    specs: dict = {}
    for n, p in named.items():
        key = stack_key(n, stacked)
        if key is None:
            specs[n] = (pspecs[n], len(p.shape))
        elif key not in specs:
            spec = pspecs[n]
            specs[key] = ((None, *spec) if spec else (), len(p.shape) + 1)

    def factored(spec, ndim):
        if ndim >= 2:
            row = tuple(spec[:-1]) if len(spec) else ()
            col = (*spec[:-2], spec[-1]) if len(spec) >= 2 else ()
            return (row, col)
        return (spec, ())

    return OptState((), {k: () for k in specs}, {k: factored(*v) for k, v in specs.items()})


def _entry(axes: tuple):
    """A spec entry of mesh axes, as `PartitionSpec` keeps it: None for
    none, the name for one, the tuple for several."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def batch_pspecs(mesh, batch: dict) -> dict:
    """tokens (B, S) -> (dp axes, None); frames and patches likewise."""
    def one(leaf):
        return (_entry(batch_spec_axes(mesh, leaf.shape[0])),) + (None,) * (len(leaf.shape) - 1)

    return {k: one(v) for k, v in batch.items()}


def cache_pspecs(cfg: ModelConfig, mesh, cache: dict) -> dict:
    """Decode caches, in the JAX package's stacked layout: the batch dim
    (1, after the stacked layer dim) over DP; the KV-head dim of (L, B, C,
    KV, hd) over 'model' when it divides, else the sequence dim (context
    parallel); MLA's latent cache (L, B, C, r) by sequence; the SSD state
    (L, B, H, P, N) by head; the rest unsharded."""
    tp = axis_sizes(mesh).get("model", 1)

    def one(name, leaf):
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        if len(shape) >= 2:
            axes[1] = _entry(batch_spec_axes(mesh, shape[1]))
        if name in ("k", "v", "cross_k", "cross_v") and len(shape) == 5:
            if shape[3] % tp == 0:
                axes[3] = "model"
            elif shape[2] % tp == 0 and shape[2] >= tp:
                axes[2] = "model"
        if name == "lat" and len(shape) == 4 and shape[2] % tp == 0 and shape[2] >= tp:
            axes[2] = "model"
        if name == "state" and len(shape) == 5 and shape[2] % tp == 0:
            axes[2] = "model"
        return tuple(axes)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else one(k, v) for k, v in tree.items()}

    return walk(cache)


def to_named(mesh, spec: tuple) -> tuple:
    """The DTensor placements of `spec` on `mesh` (`models.spmd.to_placements`:
    `Shard(dim)` on every mesh dimension named by the spec's entry for
    `dim`, `Replicate()` on the others)."""
    return to_placements(mesh, spec)


def spec_divisor(mesh, spec: tuple) -> int:
    """How many ways a tensor of this spec is split (its bytes a rank are
    its global bytes over this)."""
    sizes = axis_sizes(mesh)
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
            n *= sizes[a]
    return n


def _distribute(t, mesh, spec):
    """`t` on `mesh` at `spec`: each rank keeps its chunk of its own copy
    (no data moves; every rank holds the same tensor, from one seed)."""
    if isinstance(t, DTensor):
        want = to_named(mesh, spec)
        if tuple(t.placements) != want:
            raise ValueError(f"a DTensor at {t.placements}, its spec asks for {want}")
        return t
    return distribute_tensor(t, mesh, to_named(mesh, spec), src_data_rank=None)


def distribute_params(cfg: ModelConfig, model: nn.Module, mesh, pspecs: dict | None = None):
    """Replace every parameter of `model` by a DTensor parameter on `mesh`
    at its `param_pspec` (or `pspecs`), keeping `requires_grad`; returns
    `model`.  Each rank keeps its chunk of its own full copy, which the
    caller made from the same seed on every rank (`init_params`,
    `convert.lm_params_from_reference`)."""
    pspecs = pspecs if pspecs is not None else params_pspecs(cfg, mesh, model)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = _distribute(p.detach(), mesh, pspecs[name])
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return model


def distribute_tree(tree, specs, mesh):
    """Every tensor of `tree` (nested dicts, tuples and named tuples, as
    `specs`) on `mesh` at its spec; None stays None."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [distribute_tree(v, s, mesh) for v, s in zip(tree, specs)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if tree is None:
        return None
    return _distribute(tree, mesh, specs)
