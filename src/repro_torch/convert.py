"""Carry forest state between the JAX package and the port.

This system has no weights: a forest's state is its element fields.  The
JAX package's `repro.core.forest.Forest` holds them as host numpy arrays
(uint64 keys, int32 for the rest); the port's `Forest` holds them as tensors
on a device (int64 keys).  `forest_from_reference` and
`forest_to_reference` convert a dict of those fields — d, num_trees, rank,
num_ranks, anchor, level, stype, tree, keys, and cmesh — in either
direction, so a forest built by one package can be carried into the other
and go on there.  A coarse mesh is a dict of numpy tables under the JAX
package's `Cmesh` field names (`CMESH_FIELDS`): `cmesh_to_reference` gives
it (build the JAX `Cmesh` with `Cmesh(**tables)`), and `cmesh_from_reference`
takes it, or the JAX `Cmesh` itself.
A ghost layer is a dict of element fields — anchor, level, stype, tree,
owner — host numpy in the JAX package, tensors here;
`ghost_from_reference` and `ghost_to_reference` carry it across.  The
element class of a forest's leaves is its coarse mesh's (`tree_eclass`,
hex trees included); a forest without one holds simplices.

An LM's state is its parameters and its optimizer state:
`lm_params_from_reference` loads the JAX package's parameter tree
(`repro.models.init_params`, as numpy arrays) into the port's
`models.lm.LM`, so both packages compute with the same weights, and
`lm_params_to_reference` gives the port's parameters back in that tree
(layers stacked), so a checkpoint of them is the JAX package's;
`opt_state_from_reference` / `opt_state_to_reference` carry AdamW's and
Adafactor's state likewise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.cmesh import CMESH_FIELDS, Cmesh
from .core.forest import Forest, resolve_device
from .core.keys import from_u64, to_u64
from .core.types import ECLASS_HEX, ECLASS_SIMPLEX, to_numpy
from .models.config import ModelConfig
from .models.lm import LM, STACKED
from .optim import OptState
from .optim.optimizers import stack_key

__all__ = ["FIELDS", "GHOST_FIELDS", "CMESH_FIELDS", "forest_from_reference",
           "forest_to_reference", "ghost_from_reference", "ghost_to_reference",
           "cmesh_from_reference", "cmesh_to_reference", "lm_params_from_reference",
           "lm_params_to_reference", "load_lm_params", "opt_state_from_reference",
           "opt_state_to_reference"]

FIELDS = ("d", "num_trees", "rank", "num_ranks", "anchor", "level", "stype", "tree", "keys",
          "cmesh")
GHOST_FIELDS = ("anchor", "level", "stype", "tree", "owner")


def forest_from_reference(arrays: dict, device=None) -> Forest:
    """A port `Forest` on `device` (the card by default) from the JAX
    forest's fields, its coarse mesh (`cmesh`, a table dict or the JAX
    `Cmesh`; absent or None for isolated trees) included.  The leaves'
    element class is the mesh's; an `eclass` entry, where given (the JAX
    forest's `eclass` property), must be one of the mesh's classes, so a
    hex forest needs its coarse mesh (ValueError otherwise)."""
    cm = arrays.get("cmesh")
    cm = None if cm is None else cmesh_from_reference(cm)
    ec = arrays.get("eclass")
    if ec is not None:
        have = (ECLASS_SIMPLEX,) if cm is None else cm.eclasses
        if int(ec) not in have:
            raise ValueError(f"a forest of element class {ec} over a mesh of classes {have}")
    dev = resolve_device(device)
    n = len(arrays["level"])
    d = int(arrays["d"])

    def col(name, shape):
        a = np.asarray(arrays[name])
        if a.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {a.shape}")
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    return Forest(
        d, int(arrays["num_trees"]), int(arrays["rank"]), int(arrays["num_ranks"]),
        col("anchor", (n, d)), col("level", (n,)), col("stype", (n,)), col("tree", (n,)),
        from_u64(np.asarray(arrays["keys"], np.uint64).reshape(n), dev), cm,
    )


def forest_to_reference(f: Forest) -> dict:
    """The port forest's fields as the JAX forest holds them: host numpy
    arrays, uint64 keys, int32 for the rest; `cmesh` as a table dict
    (`cmesh_to_reference`) or None."""
    return {
        "d": f.d, "num_trees": f.num_trees, "rank": f.rank, "num_ranks": f.num_ranks,
        "anchor": to_numpy(f.anchor).astype(np.int32),
        "level": to_numpy(f.level).astype(np.int32),
        "stype": to_numpy(f.stype).astype(np.int32),
        "tree": to_numpy(f.tree).astype(np.int32),
        "keys": to_u64(f.keys),
        "cmesh": None if f.cmesh is None else cmesh_to_reference(f.cmesh),
    }


def cmesh_from_reference(cm) -> Cmesh:
    """A port `Cmesh` from the JAX package's coarse mesh: a dict of its
    tables under `CMESH_FIELDS`, or the JAX `Cmesh` itself.  Every table is
    copied with the reference's dtype; the per-face tables are nf_max wide
    (2d where the mesh has hex trees, else d + 1).  The construction-time
    proofs do not run again (the tables are the reference's own)."""
    if not isinstance(cm, dict):
        cm = {k: getattr(cm, k) for k in CMESH_FIELDS}
    d, K = int(cm["d"]), int(cm["num_trees"])
    ecl = np.asarray(cm["tree_eclass"] if cm.get("tree_eclass") is not None
                     else np.zeros(K, np.int32))
    nf, nt = (2 * d if (ecl == ECLASS_HEX).any() else d + 1), math.factorial(d)
    want = {"face_tree": ((K, nf), np.int32), "face_face": ((K, nf), np.int32),
            "face_M": ((K, nf, d, d), np.int32), "face_c": ((K, nf, d), np.int64),
            "face_typemap": ((K, nf, nt), np.int32),
            "face_facemap": ((K, nf, nt, nf), np.int32),
            "tree_embed_M": ((K, d, d), np.int32), "tree_embed_o": ((K, d), np.int64),
            "tree_eclass": ((K,), np.int32)}
    cm = dict(cm, tree_eclass=ecl)
    tables = {}
    for name, (shape, dtype) in want.items():
        a = np.asarray(cm[name])
        if a.shape != shape:
            raise ValueError(f"cmesh {name}: expected shape {shape}, got {a.shape}")
        tables[name] = a.astype(dtype)
    return Cmesh(d=d, num_trees=K, **tables)


def cmesh_to_reference(cm: Cmesh) -> dict:
    """The port's coarse mesh as a dict of the JAX `Cmesh`'s fields (copies
    of the host numpy tables, the reference's dtypes)."""
    return {k: (getattr(cm, k) if k in ("d", "num_trees") else np.array(getattr(cm, k)))
            for k in CMESH_FIELDS}


def ghost_from_reference(ghost: dict, device=None) -> dict:
    """A ghost layer of the JAX package (`ghost` output: host int32 arrays)
    as the port's: int32 tensors on `device` (the card by default)."""
    dev = resolve_device(device)
    n = len(ghost["level"])
    anchor = np.asarray(ghost["anchor"])
    d = anchor.shape[1] if anchor.ndim == 2 else -1
    out = {}
    for name in GHOST_FIELDS:
        a = np.asarray(ghost[name])
        want = (n, d) if name == "anchor" else (n,)
        if a.shape != want:
            raise ValueError(f"{name}: expected shape {want}, got {a.shape}")
        out[name] = torch.from_numpy(a.astype(np.int32)).to(dev)
    return out


def ghost_to_reference(ghost: dict) -> dict:
    """The port's ghost layer as the JAX package holds it: host int32
    arrays."""
    return {name: to_numpy(ghost[name]).astype(np.int32) for name in GHOST_FIELDS}


def _ref_leaf(tree: dict, name: str):
    """The entry of the JAX tree `tree` for the port's parameter `name`:
    "<root>.<i>.<path>", for a stacked root (`STACKED`), is layer i of the
    stacked leaf at <root>/<path> (for `super`, <path> starts with the
    block's name in the pattern, rec0, rec1, attn2)."""
    path = name.split(".")
    if path[0] not in STACKED:
        node = tree
        for part in path:
            node = node[part]
        return node
    node = tree[path[0]]
    for part in path[2:]:
        node = node[part]
    return node[int(path[1])]


def _tensor(x, device=None) -> torch.Tensor:
    """A JAX-side leaf (numpy, anything `np.asarray` takes, or a tensor) as
    a tensor on `device` (its own for a tensor unless given); host data is
    copied (a JAX array's numpy view is read-only), bfloat16 through
    float32, exactly."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def load_lm_params(model: LM, params: dict) -> LM:
    """Copy the JAX tree `params` (as `lm_params_from_reference` takes it,
    numpy arrays or tensors) into `model`'s parameters in place, each cast
    to the parameter's dtype; raises if a leaf is missing, left over or of
    another shape.  Returns `model`."""
    for name, p in model.named_parameters():
        leaf = _tensor(_ref_leaf(params, name))
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(leaf.shape)}, "
                             f"port {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(leaf)
    n_port = sum(1 for name, _ in model.named_parameters()
                 if name.split(".")[0] not in STACKED or name.split(".")[1] == "0")
    n_ref = sum(1 for _ in _leaves(params))
    if n_port != n_ref:
        raise ValueError(f"the reference tree has {n_ref} leaves, the port {n_port}")
    return model


def lm_params_from_reference(cfg: ModelConfig, params: dict, device=None) -> LM:
    """The port's `LM` holding the JAX package's parameters: `params` is the
    JAX tree (tok_embed, out_head, final_norm, and layers with a leading
    layer axis), as numpy arrays, anything `np.asarray` takes, or tensors
    (a restored checkpoint's bfloat16 leaves); the hybrid family's `super`
    and `tail`, the encoder-decoder's `enc`, `enc_norm` and `dec` where the
    config has them.  Each stacked layer axis is split into the blocks of
    the root of its name; every weight keeps JAX's (in, out) layout, so no
    matrix is transposed.  Each leaf is cast to the parameter's dtype (bf16
    leaves go through fp32, exactly).  Raises if a leaf is missing, left
    over or of another shape.  On `device`, the card unless given."""
    return load_lm_params(LM(cfg, 0, device), params)


def _slots(module, prefix: str = ""):
    """(name, parameter or None) of every parameter slot under `module`, a
    slot registered as None included (the non-parametric norms, a tied
    head)."""
    for name, p in module._parameters.items():
        yield prefix + name, p
    for name, sub in module._modules.items():
        yield from _slots(sub, f"{prefix}{name}.")


def _detached(x):
    return tuple(t.detach() for t in x) if isinstance(x, tuple) else x.detach()


def _reference_tree(model: LM, flat: dict) -> dict:
    """The JAX package's tree of the LM, with the entry of each port
    parameter name taken from `flat` (name -> tensor, or a tuple of them)
    and the entries of each stacked root (`STACKED`) stacked on a leading
    axis, or taken whole from `flat`'s "<root>.*.<path>" where it has one
    (Adafactor's state of a stacked leaf): tok_embed, out_head unless
    tied, final_norm, and layers {attn_norm, attn {...}, mlp_norm, mlp
    {...} or moe {...}} (ssm: {norm, ssm {...}}); super {rec0, rec1,
    attn2} and tail (hybrid); enc, enc_norm and dec (encdec); mtp_proj,
    mtp_block, mtp_norm with the multi-token prediction head; None where
    the config has no such parameter (the non-parametric norms)."""
    tree: dict = {}
    for name, p in _slots(model):
        parts = name.split(".")
        if parts[0] in STACKED:
            if parts[1] != "0":
                continue
            root, path = parts[0], ".".join(parts[2:])
            parts = [root, *parts[2:]]
            key = stack_key(name, STACKED)
            if p is None:
                leaf = None
            elif key in flat:
                leaf = _detached(flat[key])
            else:
                leaf = torch.stack([flat[f"{root}.{i}.{path}"].detach()
                                    for i in range(len(getattr(model, root)))])
        else:
            leaf = None if p is None else _detached(flat[name])
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    if model.cfg.tie_embeddings:
        del tree["out_head"]
    return tree


def lm_params_to_reference(model: LM) -> dict:
    """The inverse of `lm_params_from_reference`: the JAX package's tree of
    `model`'s parameters (tensors on its device, in its dtypes, layers
    stacked on a leading axis and copied), as `repro.models.init_params`
    gives it; a checkpoint of it is the JAX package's byte for byte."""
    return _reference_tree(model, dict(model.named_parameters()))


def opt_state_to_reference(model: LM, opt: OptState) -> OptState:
    """The port's optimizer state as the JAX package's: the moments in the
    parameter tree's layout (`lm_params_to_reference`; AdamW's, kept a
    parameter each, stacked; Adafactor's 0-d `mu` and (vr, vc) pairs of a
    stacked leaf, kept whole under "<root>.*.<path>", as they are), the step
    a 0-d int32 tensor."""
    return OptState(opt.step, _reference_tree(model, opt.mu), _reference_tree(model, opt.nu))


def opt_state_from_reference(model: LM, opt) -> OptState:
    """The JAX package's AdamW or Adafactor state (`repro.optim.OptState` or
    any (step, mu, nu) of numpy arrays or tensors) as the port's, for
    `model`, on the parameters' device, in its saved dtypes: AdamW's
    moments keyed by parameter name (layer i of each stacked leaf);
    Adafactor's (a (vr, vc) pair a leaf) by parameter name outside the
    stacked roots and by "<root>.*.<path>" for a stacked leaf, whole, as
    `init_opt_state(model, "adafactor")` keeps them.  The step is a 0-d
    int32 host tensor."""
    step, mu, nu = opt
    names = [name for name, _ in model.named_parameters()]
    dev = model.tok_embed.device

    def tensor(x):
        if isinstance(x, tuple):
            return tuple(_tensor(t, dev).contiguous() for t in x)
        return _tensor(x, dev).contiguous()

    if not isinstance(nu["tok_embed"], tuple):          # AdamW
        return OptState(torch.tensor(int(step), dtype=torch.int32),
                        {n: tensor(_ref_leaf(mu, n)) for n in names},
                        {n: tensor(_ref_leaf(nu, n)) for n in names})
    paths = {}
    for n in names:
        key, parts = stack_key(n, STACKED), n.split(".")
        paths[key or n] = [parts[0], *parts[2:]] if key else parts

    def whole(tree, path):
        for part in path:
            tree = tree[part]
        return tensor(tree)

    return OptState(torch.tensor(int(step), dtype=torch.int32),
                    {k: whole(mu, path) for k, path in paths.items()},
                    {k: whole(nu, path) for k, path in paths.items()})


def _leaves(tree):
    """The non-None leaves of a nested dict."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif v is not None:
            yield v
