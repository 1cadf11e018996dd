"""The port's hex and mixed-class coarse meshes (`repro_torch.core.cmesh`)
against the JAX package's, exactly: `cmesh_hex_brick` at d = 2 and 3 with
and without periodic axes and `cmesh_hybrid_pair` at d = 2 and 3, table for
table; `root_face_of` of hex elements on every root face;
`transform_across_face` and `world_vertices` of hex trees; the packed hex
connection rows the `tree_transform` kernel reads; and the tables carried
between the packages by `convert`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cmesh as JC
from repro.core import u64 as u64m
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro_torch import convert
from repro_torch.core import cmesh as TC
from repro_torch.core.ops import get_ops
from repro_torch.core.tables import MAXLEVEL
from repro_torch.core.types import ECLASS_HEX, ECLASS_SIMPLEX, Simplex

MESHES = {
    "hex_d2": ("cmesh_hex_brick", (2, (2, 3)), {}),
    "hex_d2_periodic": ("cmesh_hex_brick", (2, (2, 2)), {"periodic": (True, True)}),
    "hex_d3": ("cmesh_hex_brick", (3, (2, 1, 2)), {}),
    "hex_d3_periodic": ("cmesh_hex_brick", (3, (2, 2, 2)), {"periodic": (True, True, False)}),
    "hybrid_d2": ("cmesh_hybrid_pair", (2,), {}),
    "hybrid_d3": ("cmesh_hybrid_pair", (3,), {}),
}


def _pair(name):
    fn, args, kw = MESHES[name]
    return getattr(TC, fn)(*args, **kw), getattr(JC, fn)(*args, **kw)


@pytest.mark.parametrize("name", list(MESHES))
def test_cmesh_tables_match_reference(name):
    tcm, jcm = _pair(name)
    for k in TC.CMESH_FIELDS:
        got, want = getattr(tcm, k), getattr(jcm, k)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert tcm.eclasses == tuple(jcm.eclasses)
    assert [tcm.eclass_of(t) for t in range(tcm.num_trees)] == [
        jcm.eclass_of(t) for t in range(jcm.num_trees)]
    assert tcm.nf_max == (2 * tcm.d)
    back = TC.Cmesh(**convert.cmesh_to_reference(tcm))
    again = convert.cmesh_from_reference(jcm)
    for k in TC.CMESH_FIELDS:
        np.testing.assert_array_equal(getattr(back, k), getattr(jcm, k), err_msg=k)
        np.testing.assert_array_equal(getattr(again, k), getattr(jcm, k), err_msg=k)


def test_hybrid_pair_glues_within_classes_only():
    """The face between the hex tree and the Kuhn cube is a domain boundary;
    the simplex trees glue among themselves, the lone hex tree to none."""
    for d in (2, 3):
        tcm, _ = _pair(f"hybrid_d{d}")
        assert tcm.eclasses == (ECLASS_SIMPLEX, ECLASS_HEX)
        assert (tcm.face_tree[0] < 0).all()
        glued = tcm.face_tree[1:, :d + 1]
        assert (glued[glued >= 0] >= 1).all() and (glued >= 0).any()
        assert (tcm.face_tree[1:, d + 1:] < 0).all()


@pytest.mark.parametrize("d", [2, 3])
def test_root_face_of_hex_elements_matches_reference(d):
    """Which of the 2d root faces holds each face of a hex: every face of
    every level-2 hex of a tree, against the JAX package."""
    tcm, jcm = _pair(f"hex_d{d}")
    L, lv = MAXLEVEL[d], 2
    o = get_ops(d, ECLASS_HEX)
    ids = np.arange(1 << (d * lv), dtype=np.uint64)
    js = jget_ops(d, ECLASS_HEX).from_linear_id(u64m.from_int(ids),
                                                jnp.full(len(ids), lv, jnp.int32))
    ts = o.from_linear_id(torch.from_numpy(ids.astype(np.int64)),
                          torch.full((len(ids),), lv, dtype=torch.int32))
    hits = set()
    for f in range(2 * d):
        got = tcm.root_face_of(ts, f, ECLASS_HEX).numpy()
        want = jcm.root_face_of(js, f, eclass=ECLASS_HEX)
        np.testing.assert_array_equal(got, want)
        hits |= set(got[got >= 0].tolist())
        assert set(got[got >= 0].tolist()) <= {f}
    assert hits == set(range(2 * d)) and L > lv


@pytest.mark.parametrize("name", ["hex_d3_periodic", "hex_d2_periodic", "hybrid_d3"])
def test_transforms_and_world_vertices_match_reference(name):
    """transform_across_face of the level-1 outside neighbors across every
    glued face (the plain map and through the `tree_transform` wrapper), and
    world_vertices of every tree's level-1 elements, against the JAX
    package."""
    from repro_torch.core.batch import get_batch_ops

    tcm, jcm = _pair(name)
    d = tcm.d
    crossed = 0
    for t in range(tcm.num_trees):
        ec = tcm.eclass_of(t)
        o, jo = get_ops(d, ec), jget_ops(d, ec)
        n = 1 << d
        ids = np.arange(n, dtype=np.uint64)
        js = jo.from_linear_id(u64m.from_int(ids), jnp.ones(n, jnp.int32))
        ts = o.from_linear_id(torch.from_numpy(ids.astype(np.int64)),
                              torch.ones(n, dtype=torch.int32))
        np.testing.assert_array_equal(tcm.world_vertices(t, ts).numpy(),
                                      jcm.world_vertices(t, js))
        for f in range(o.nf):
            nb_t, _ = o.face_neighbor(ts, f)
            nb_j, _ = jo.face_neighbor(js, f)
            rf = tcm.root_face_of(ts, f, ec)
            np.testing.assert_array_equal(rf.numpy(), jcm.root_face_of(js, f, eclass=ec))
            for r in sorted(set(rf.tolist()) - {-1}):
                if not tcm.is_connected(t, r):
                    continue
                sel = torch.nonzero(rf == r).squeeze(1)
                st = Simplex(*(x[sel] for x in nb_t))
                sj = JSimplex(*(x[sel.numpy()] for x in nb_j))
                (a, t2), (b, u2) = (tcm.transform_across_face(st, t, r),
                                    jcm.transform_across_face(sj, t, r))
                assert t2 == u2
                for g, w in zip(a, b):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                (c, t3) = tcm.transform_across_face(st, t, r, bops=get_batch_ops(d, ec))
                assert t3 == t2 and all(torch.equal(x, y) for x, y in zip(c, a))
                assert o.is_inside_root(a).all()
                crossed += len(sel)
    assert crossed > 0


@pytest.mark.parametrize("d", [2, 3])
def test_packed_hex_connection_rows(d):
    """A hex row holds its 2d face-map entries where a simplex row holds
    type 0's, and the rest of the row as for simplices; the device table
    has one row per (tree, root face) of the widest class."""
    tcm, jcm = _pair(f"hex_d{d}_periodic")
    L = MAXLEVEL[d]
    nt = 2 if d == 2 else 6
    conn = tcm.gluing("cpu").conn.numpy()
    assert conn.shape == (tcm.num_trees * 2 * d, TC.conn_row_width(d))
    for t in range(tcm.num_trees):
        for f in range(2 * d):
            row = conn[t * 2 * d + f]
            M = jcm.face_M[t, f]
            code = [int(np.nonzero(M[k])[0][0]) | (4 if M[k].sum() < 0 else 0) for k in range(d)]
            assert row[:d].tolist() == code
            np.testing.assert_array_equal(row[d:2 * d], JC.wrap_i32(jcm.face_c[t, f]))
            np.testing.assert_array_equal(row[2 * d:2 * d + nt], jcm.face_typemap[t, f])
            np.testing.assert_array_equal(row[2 * d + nt:2 * d + nt + 2 * d],
                                          jcm.face_facemap[t, f, 0])
            assert row[-1] == max(int(jcm.face_tree[t, f]), 0)
    rot = np.eye(d, dtype=np.int64)
    rot[:2, :2] = [[0, -1], [1, 0]]
    row = TC.pack_connection(d, rot, np.full(d, 1 << L), np.zeros(nt), TC._hex_face_map(d, rot),
                             7, eclass=ECLASS_HEX)
    np.testing.assert_array_equal(row[2 * d + nt:2 * d + nt + 2 * d],
                                  JC._hex_face_map(d, rot))
    assert row[:2].tolist() == [1 | 4, 0] and row[-1] == 7
    with pytest.raises(ValueError):
        TC.pack_connection(d, 2 * np.eye(d), np.zeros(d), np.zeros(nt), eclass=ECLASS_HEX)
