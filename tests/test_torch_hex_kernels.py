"""The hex bodies' plain versions (`repro_torch.kernels.ref` through the
wrappers of `kernels.ops`, with `eclass=ECLASS_HEX`) against the JAX
package's Pallas kernels' hex branches in interpret mode, exactly, at
d = 2 and 3 and n <= 250: encode, decode, parent, children, the face sweep
over 2d faces, inside-root, successor and the single-face neighbor;
`eval_route` over nf = 2d face planes; and `tree_transform` across every
glued face of a periodic hex brick, the dual face through the coarse
mesh's face map.  Also: every C entry point of `sfc.cu` takes as many
arguments as its wrapper passes (ctypes would pass extra ones unconverted).

The hex branches compile in seconds in interpret mode (no table walks), so
unlike the simplex encode and decode they need no file of their own.  The
CUDA hex bodies are held against these plain versions on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cmesh as JC
from repro.core import u64 as u64m
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro.kernels import ops as jkops
from repro_torch.core import cmesh as TC
from repro_torch.core.tables import MAXLEVEL
from repro_torch.core.types import ECLASS_HEX
from repro_torch.kernels import build, ops as kops
from test_torch_sweep import _pad_markers

H = ECLASS_HEX
BLOCK = 256


def _inputs(d, n, seed):
    """Numpy (key with garbage below each level, level, anchor, box anchor,
    face): hexes of every level 0..L decoded from the keys by the JAX
    package (rows 2-3 the last element of levels L and 3), and the same
    levels with h-aligned anchors anywhere in [-2^L, 2^L)^d; one face of 2d
    each."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:4] = (0, L, L, 3)
    key = rng.integers(0, 1 << (d * L), n, dtype=np.uint64)
    key[2:4] = (1 << (d * L)) - 1
    s = jget_ops(d, H).decode_key(u64m.from_int(key), jnp.asarray(level))
    h = (1 << (L - level.astype(np.int64)))[:, None]
    box = (np.floor_divide(rng.integers(-(1 << L), 1 << L, (n, d)), h) * h).astype(np.int32)
    face = rng.integers(0, 2 * d, n).astype(np.int32)
    return key, level, np.array(s.anchor), box, face


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _js(anchor, level):
    return JSimplex(jnp.asarray(anchor), jnp.asarray(level),
                    jnp.zeros(len(level), jnp.int32))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _port(name, d, key, level, anchor, box, face):
    """The port's wrapper outputs for one hex body, as numpy (keys uint64)."""
    z = torch.zeros(len(level), dtype=torch.int32)
    lv = _t(level)
    if name == "morton_key":
        return (kops.morton_key(_t(box), z, H).numpy().astype(np.uint64),)
    if name == "decode":
        return tuple(x.numpy() for x in kops.decode(d, _t(key.astype(np.int64)), lv, H))
    if name == "face_sweep":
        a, b, du, ins, k = kops.face_sweep(_t(box), lv, z, H)
        return a.numpy(), b.numpy(), du.numpy(), ins.numpy(), k.numpy().astype(np.uint64)
    if name == "inside_root":
        return (kops.inside_root(_t(box), lv, z, H).numpy(),)
    if name == "face_neighbor":
        return tuple(x.numpy() for x in kops.face_neighbor(_t(box), lv, z, _t(face), H))
    fn = getattr(kops, name)
    return tuple(x.numpy() for x in fn(_t(anchor), lv, z, H))


def _pallas(name, d, key, level, anchor, box, face):
    """The JAX package's Pallas kernel, hex branch, in interpret mode."""
    if name == "morton_key":
        return (u64m.to_np(jkops.morton_key(d, _js(box, level), BLOCK, H)),)
    if name == "decode":
        s = jkops.decode(d, u64m.from_int(key), jnp.asarray(level), BLOCK, H)
        return s.anchor, s.stype
    if name == "face_sweep":
        nb, dual, inside, k = jkops.face_sweep(d, _js(box, level), BLOCK, H)
        return nb.anchor, nb.stype, dual, inside, u64m.to_np(k)
    if name == "inside_root":
        return (jkops.is_inside_root(d, _js(box, level), BLOCK, H),)
    if name == "face_neighbor":
        nb, dual = jkops.face_neighbor(d, _js(box, level), jnp.asarray(face), BLOCK, H)
        return nb.anchor, nb.stype, dual
    s = _js(anchor, level)
    if name == "parent":
        p, iloc = jkops.parent_and_local_index(d, s, BLOCK, H)
        return p.anchor, p.level, p.stype, iloc
    if name == "children":
        k = jkops.children(d, s, BLOCK, H)
        return k.anchor, k.level, k.stype
    nxt = jkops.successor(d, s, BLOCK, H)
    return nxt.anchor, nxt.stype


@pytest.mark.parametrize("name", ["morton_key", "decode", "parent", "children", "face_sweep",
                                  "inside_root", "successor", "face_neighbor"])
@pytest.mark.parametrize("d", [2, 3])
def test_hex_plain_version_matches_pallas_hex_kernel(name, d):
    args = _inputs(d, 250, seed=11 * d)
    got, want = _port(name, d, *args), _pallas(name, d, *args)
    _assert_same(got, want)
    if name in ("face_sweep", "inside_root"):
        inside = got[3] if name == "face_sweep" else got[0]
        assert inside.any() and not inside.all()
    if name == "successor":           # the last element of a level wraps to element 0
        assert not got[0][2:4].any()


@pytest.mark.parametrize("d", [2, 3])
def test_eval_route_over_hex_faces_matches_pallas(d):
    """eval_route reads nf = 2d off its (2d, n) inputs: end keys and owner
    ranges equal the Pallas kernel's, against markers with an empty rank."""
    L, n, nf = MAXLEVEL[d], BLOCK, 2 * d
    rng = np.random.default_rng(30 + d)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    shift = (np.uint64(d) * (np.uint64(L) - level.astype(np.uint64)))[None, :]
    key = (rng.integers(0, 1 << (d * L), (nf, n), dtype=np.uint64) >> shift) << shift
    tgt = rng.integers(0, 4, (nf, n)).astype(np.int32)
    q = np.uint64(1) << np.uint64(d * L - 2)
    mt = np.array([0, 1, 1, 2], np.int32)
    mk = np.array([0, q, q, 3 * q], np.uint64)
    kend, first, last = kops.eval_route(d, _t(tgt), _t(key.astype(np.int64)), _t(level),
                                        _t(mt), _t(mk.astype(np.int64)))
    mt_p, mk_p = _pad_markers(mt, mk)
    hh, hl, jf, jl = jkops.eval_route(
        d, jnp.asarray(tgt), jnp.asarray((key >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(key.astype(np.uint32)), jnp.asarray(np.broadcast_to(level, (nf, n))),
        jnp.asarray(mt_p), jnp.asarray((mk_p >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(mk_p.astype(np.uint32)), BLOCK)
    jend = (np.asarray(hh).astype(np.uint64) << np.uint64(32)) | np.asarray(hl).astype(np.uint64)
    assert kend.shape == (nf, n)
    np.testing.assert_array_equal(kend.numpy().astype(np.uint64), jend)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jl))
    assert sorted(np.unique(first.numpy()).tolist()) == [0, 2, 3]


@pytest.mark.parametrize("d", [2, 3])
def test_tree_transform_across_every_hex_face_matches_pallas(d):
    """The same-level outside neighbors of a periodic hex brick's boundary
    hexes, across each of the 2d faces of each tree, through the packed
    connection rows in one call: anchor and type equal the Pallas kernel's
    per connection, the dual face the coarse mesh's face map, the tree the
    neighbor tree; every result lies in the neighbor tree's root."""
    from repro_torch.core import forest as TF

    tcm = TC.cmesh_hex_brick(d, (2,) * d, periodic=(True,) * d)
    jcm = JC.cmesh_hex_brick(d, (2,) * d, periodic=(True,) * d)
    f = TF.new_uniform(d, tcm.num_trees, 2, TF.SimComm(1), cmesh=tcm, device="cpu")[0]
    nb, _t0, dual, inside, _k = kops.face_sweep(f.anchor, f.level, f.stype, H)
    fidx, eidx = torch.nonzero(~inside, as_tuple=True)
    assert torch.unique(fidx).numel() == 2 * d
    t1 = f.tree[eidx].long()
    conn = (t1 * tcm.nf_max + fidx).to(torch.int32)
    x_anchor, x_dual = nb[fidx, eidx].contiguous(), dual[fidx, eidx].contiguous()
    lv = f.level[eidx].contiguous()
    a2, b2, d2, t2 = kops.tree_transform(conn, x_anchor, lv, torch.zeros_like(lv), x_dual,
                                         tcm.gluing("cpu").conn, H)
    assert kops.inside_root(a2, lv, b2, H).all() and not b2.any()
    for t, fc in {(int(t), int(fc)) for t, fc in zip(t1, fidx)}:
        m = ((t1 == t) & (fidx == fc)).numpy()
        M = tuple(map(tuple, jcm.face_M[t, fc].tolist()))
        c = tuple(JC.wrap_i32(jcm.face_c[t, fc]).tolist())
        want = jkops.tree_transform(d, _js(x_anchor.numpy()[m], lv.numpy()[m]), M, c,
                                    tuple(jcm.face_typemap[t, fc].tolist()), BLOCK, H)
        np.testing.assert_array_equal(a2.numpy()[m], np.asarray(want.anchor))
        np.testing.assert_array_equal(b2.numpy()[m], np.asarray(want.stype))
        np.testing.assert_array_equal(d2.numpy()[m],
                                      jcm.face_facemap[t, fc, 0, x_dual.numpy()[m]])
        assert (t2.numpy()[m] == jcm.face_tree[t, fc]).all()


def test_c_entry_points_take_the_wrappers_argument_counts():
    """Every `extern "C"` entry point of every source in `csrc/` (`sfc.cu`
    and `flash_attention.cu`) has as many parameters as `kernels.ops`
    declares for it."""
    sigs = {}
    for path in sorted(build.CSRC_DIR.glob("*.cu")):
        src = path.read_text()
        body = src[src.index('extern "C"'):]
        sigs.update({m.group(1): len([p for p in m.group(2).split(",") if p.strip()])
                     for m in re.finditer(r"int ((?:sfc|fa)_\w+)\((.*?)\)\s*\{", body, re.S)})
    assert sigs and set(sigs) == set(kops._ARGTYPES) and "fa_flash_attention" in sigs
    for name, count in sigs.items():
        assert len(kops._ARGTYPES[name]) == count, name
