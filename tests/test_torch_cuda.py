"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a card these tests skip.  On a machine with a card
(and nvcc) run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; the plain versions themselves are held against the
JAX package by `tests/test_torch_kernels.py` on the CPU."""

import numpy as np
import pytest
import torch

from repro_torch.core import cmesh as TC
from repro_torch.core import forest as TF
from repro_torch.core.keys import span_mask
from repro_torch.core.tables import MAXLEVEL
from repro_torch.core.types import ECLASS_HEX
from repro_torch.kernels import ops as kops, ref as kref

KERNELS = ["morton_key", "decode", "parent", "children", "face_sweep", "inside_root"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(d, n, seed, dev):
    """(key with garbage below each level, level, anchor, stype) on `dev`;
    levels 0..L (the first two elements at 0 and L), the elements decoded
    from the keys by the plain decode."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:2] = (0, L)
    key = torch.from_numpy(rng.integers(0, 1 << (d * L), n, dtype=np.uint64).astype(np.int64))
    key, level = key.to(dev), torch.from_numpy(level).to(dev)
    anchor, stype = kref.decode(d, key, level)
    return key, level, anchor, stype


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_kernel_matches_plain_version(name, d, n):
    """Exact equality, the ragged edge of the last block included, and the
    kernel's launch counter moves by one."""
    dev = _card()
    key, level, anchor, stype = _inputs(d, max(n, 2), seed=n + d, dev=dev)
    key, level, anchor, stype = key[:n], level[:n], anchor[:n], stype[:n]
    if name == "morton_key":
        args, kernel, plain = (anchor, stype), kops.morton_key, kref.morton_key
    elif name == "decode":
        args = (key, level)
        kernel, plain = (lambda *a: kops.decode(d, *a)), (lambda *a: kref.decode(d, *a))
    else:
        args = (anchor, level, stype)
        kernel, plain = getattr(kops, name), getattr(kref, name)
    before = kops.launch_counts[name]
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert kops.launch_counts[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_wrappers_never_fall_back():
    """A CUDA tensor reaches the kernel (the plain counters stay put); an
    empty batch launches nothing."""
    dev = _card()
    key, level, anchor, stype = _inputs(3, 64, seed=1, dev=dev)
    kref.reset_call_counts()
    kops.reset_launch_counts()
    kops.morton_key(anchor, stype)
    kops.decode(3, key, level)
    kops.parent(anchor, level, stype)
    kops.children(anchor, level, stype)
    kops.face_sweep(anchor, level, stype)
    kops.inside_root(anchor, level, stype)
    tgt, nkey, mt, mk = _route_inputs(3, level, dev)
    kops.eval_route(3, tgt, nkey, level, mt, mk)
    conn, table = _transform_inputs(3, 64, dev)[:2]
    kops.tree_transform(conn, anchor, level, stype, tgt[0] & 3, table)
    kops.owner_rank(tgt[0], key, mt, mk)
    kops.successor(anchor, level, stype)
    kops.face_neighbor(anchor, level, stype, tgt[0] & 3)
    assert kops.morton_key(anchor[:0], stype[:0]).shape == (0,)
    assert kops.launch_counts == {**{k: 1 for k in KERNELS + ["eval_route", "tree_transform",
                                                              "owner_rank", "successor",
                                                              "face_neighbor"]},
                                  "flash_attention": 0}
    assert not any(kref.call_counts.values())
    with pytest.raises(ValueError):
        kops.morton_key(anchor, stype.cpu())
    with pytest.raises(ValueError, match="at least 1"):    # the kernel needs a marker
        kops.owner_rank(tgt[0], key, mt[:0], mk[:0])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_pipeline_matches_cpu(d):
    """New -> Adapt -> Partition on the card equals the CPU run field for
    field, with equal per-phase bytes."""
    dev = _card()
    runs = []
    for device in (dev, torch.device("cpu")):
        comm = TF.SimComm(3)
        fs = TF.new_uniform(d, 4, 1, comm, device=device)
        fs = [TF.adapt(f, lambda t, e: ((e.stype == 0) & (e.level < 4)).int(), recursive=True)
              for f in fs]
        fs = [TF.adapt(f, lambda t, e: torch.where((e.level == 4) & (t >= 2), -1, 0))
              for f in fs]
        fs = TF.partition(fs, comm)
        fs = TF.repartition(fs, comm, weights=[1.0 + (f.level == 4).double() for f in fs])
        runs.append((fs, comm.counters))
    (fg, cg), (fc, cc) = runs
    assert cg == cc
    for a, b in zip(fg, fc, strict=True):
        for name in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))


def _cube_inputs(d, n, seed, dev):
    """Elements anywhere in the root cube, of every type and level 0..L —
    most outside the root simplex, so their neighbors' keys and inside
    masks are the garbage lanes a sweep also computes."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:2] = np.array([0, L])[:n]
    h = (1 << (L - level.astype(np.int64)))[:, None]
    anchor = (rng.integers(0, 1 << L, (n, d)) // h * h).astype(np.int32)
    stype = rng.integers(0, 2 if d == 2 else 6, n).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (anchor, level, stype))


def _route_inputs(d, level, dev, P=4, seed=0, nf=None):
    """Per (face, element) pair of nf faces (d + 1 by default) a target
    tree and a span-aligned key at the element's level; P lex-sorted
    markers with an empty rank (a repeated marker) and a trailing
    (num_trees, 0) sentinel."""
    L = MAXLEVEL[d]
    nf = d + 1 if nf is None else nf
    rng = np.random.default_rng(seed)
    n = level.shape[0]
    lv = level.cpu().numpy().astype(np.int64)
    shift = (d * (L - lv))[None, :]
    raw = rng.integers(0, 1 << (d * L), (nf, n), dtype=np.uint64).astype(np.int64)
    key = (raw >> shift) << shift
    tgt = rng.integers(0, 4, (nf, n)).astype(np.int32)
    mk = np.sort(rng.integers(0, 1 << (d * L), P - 1)).astype(np.int64)
    mt = np.array([0, 1, 1, 3][:P - 1] + [3], np.int32)
    mk = np.concatenate([[0], mk[1:], [0]])
    mk[2] = mk[1]
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    return (torch.from_numpy(tgt).to(dev), torch.from_numpy(key).to(dev),
            torch.from_numpy(mt).to(dev), torch.from_numpy(mk).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_sweep_and_inside_match_plain_outside_the_root(d, n):
    """face_sweep and inside_root equal their plain versions on elements
    anywhere in the root cube, the garbage lanes included."""
    dev = _card()
    anchor, level, stype = _cube_inputs(d, n, seed=n + d, dev=dev)
    got = kops.face_sweep(anchor, level, stype) + (kops.inside_root(anchor, level, stype),)
    want = kref.face_sweep(anchor, level, stype) + (kref.inside_root(anchor, level, stype),)
    torch.cuda.synchronize()
    if n > 1:
        assert bool(want[3].any()) and not bool(want[3].all())
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_eval_route_matches_plain(d, n):
    """eval_route equals its plain version at levels 0..L (the d = 3,
    level-0 end key 2^63 - 1 included) against markers with an empty rank."""
    dev = _card()
    _anchor, level, _stype = _cube_inputs(d, n, seed=n, dev=dev)
    tgt, key, mt, mk = _route_inputs(d, level, dev, seed=n)
    before = kops.launch_counts["eval_route"]
    got = kops.eval_route(d, tgt, key, level, mt, mk)
    want = kref.eval_route(d, tgt, key, level, mt, mk)
    torch.cuda.synchronize()
    assert kops.launch_counts["eval_route"] == before + 1
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_balance_ghost_validate_match_cpu(d):
    """Balance -> Ghost -> validate on the card equals the CPU run, forest
    and ghost field for field, with equal per-phase bytes."""
    dev = _card()
    runs = []
    for device in (dev, torch.device("cpu")):
        comm = TF.SimComm(3)
        fs = TF.new_uniform(d, 2, 1, comm, device=device)
        fs = [TF.adapt(f, lambda t, e: ((e.anchor.sum(1) == 0) & (e.level < 5)).int(),
                       recursive=True) for f in fs]
        fs = TF.balance(TF.partition(fs, comm), comm)
        gh = TF.ghost(fs, comm)
        assert TF.validate(fs, gh)
        runs.append((fs, gh, comm.counters))
    (fg, gg, cg), (fc, gc, cc) = runs
    assert cg == cc and cg["balance"]["alltoallv_bytes"] > 0
    for a, b in zip(fg, fc, strict=True):
        for name in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
    for a, b in zip(gg, gc, strict=True):
        for name in ("anchor", "level", "stype", "tree", "owner"):
            assert torch.equal(a[name].cpu(), b[name])


def _transform_inputs(d, n, dev, seed=0):
    """(conn, table, wrapped) for n crossings: each element picks a random
    connection among the glued faces of a periodic brick, and of the
    rotated pair at d = 2 (sigma = -1); at d = 3, whose meshes here glue
    with sigma = +1 only, of reflected rows made by `pack_connection` too.
    `wrapped` counts the table's translations that wrap past int32."""
    rng = np.random.default_rng(seed)
    cms = [TC.cmesh_brick(d, (2,) * d, periodic=(True,) * d)]
    rows = []
    if d == 2:
        cms.append(TC.cmesh_rotated_pair())
    else:
        for sigma in (1, -1):
            M = sigma * np.roll(np.eye(3, dtype=np.int64), 1, axis=1)
            tm, vm = TC.signed_perm_maps(3, M)
            rows.append(TC.pack_connection(3, M, np.array([2, -1, 1]) << MAXLEVEL[3], tm, vm, 5))
    for cm in cms:
        t, f = np.nonzero(cm.face_tree >= 0)
        rows.append(cm.gluing("cpu").conn.numpy()[t * (d + 1) + f])
    table = np.concatenate([np.atleast_2d(r) for r in rows]).astype(np.int32)
    conn = rng.integers(0, len(table), n).astype(np.int32)
    wrapped = int((np.abs(np.concatenate([c.face_c.reshape(-1) for c in cms])) >= 1 << 31).sum())
    return (torch.from_numpy(conn).to(dev), torch.from_numpy(table).to(dev), wrapped)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_tree_transform_matches_plain(d, n):
    """tree_transform equals its plain version on elements of every level
    and type anywhere in the root cube, crossing connections of either
    sign, with translations that wrap past 2^31 - 1 at d = 2."""
    dev = _card()
    anchor, level, stype = _cube_inputs(d, n, seed=n + 7 * d, dev=dev)
    conn, table, wrapped = _transform_inputs(d, n, dev, seed=n)
    dual = torch.randint(0, d + 1, (n,), dtype=torch.int32, device=dev)
    before = kops.launch_counts["tree_transform"]
    got = kops.tree_transform(conn, anchor, level, stype, dual, table)
    want = kref.tree_transform(conn, anchor, level, stype, dual, table)
    torch.cuda.synchronize()
    assert kops.launch_counts["tree_transform"] == before + 1
    assert (wrapped > 0) == (d == 2)
    signs = ((table[:, :d] >> 2) & 1).any(dim=1)
    assert bool(signs.any()) and not bool(signs.all())
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("P", [4097, 8192])
def test_cuda_eval_route_beyond_shared_markers_matches_plain(d, P):
    """Past 4096 markers the kernel binary searches them in global memory;
    it equals the plain compare-and-count on lex-sorted markers with empty
    ranks (repeated markers) and a trailing sentinel."""
    dev = _card()
    L = MAXLEVEL[d]
    rng = np.random.default_rng(P + d)
    _anchor, level, _stype = _cube_inputs(d, 100_000, seed=P, dev=dev)
    tgt, key, _mt, _mk = _route_inputs(d, level, dev, seed=P)
    mt = np.sort(rng.integers(0, 4, P)).astype(np.int32)
    mk = rng.integers(0, 1 << (d * L), P, dtype=np.uint64).astype(np.int64)
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    mk[10:20], mt[10:20] = mk[9], mt[9]
    mt[-2:], mk[-2:] = 4, 0
    mt, mk = torch.from_numpy(mt).to(dev), torch.from_numpy(mk).to(dev)
    before = kops.launch_counts["eval_route"]
    got = kops.eval_route(d, tgt, key, level, mt, mk)
    want = kref.eval_route(d, tgt, key, level, mt, mk)
    torch.cuda.synchronize()
    assert kops.launch_counts["eval_route"] == before + 1
    assert torch.unique(want[1]).numel() > 1000
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["brick_d3", "brick_d2", "rotated_pair"])
def test_cuda_multitree_pipeline_matches_cpu(name):
    """Balance -> Ghost -> validate over a coarse mesh on the card equals
    the CPU run, forest and ghost field for field, with equal bytes, and
    the card's crossings went through the tree_transform kernel."""
    dev = _card()
    cm = {"brick_d3": lambda: TC.cmesh_brick(3, (2, 1, 1), periodic=(True, False, False)),
          "brick_d2": lambda: TC.cmesh_brick(2, (2, 2), periodic=(True, True)),
          "rotated_pair": TC.cmesh_rotated_pair}[name]()
    runs = []
    for device in (dev, torch.device("cpu")):
        comm = TF.SimComm(3)
        kops.reset_launch_counts()
        fs = TF.new_uniform(cm.d, cm.num_trees, 1, comm, cmesh=cm, device=device)
        fs = [TF.adapt(f, lambda t, e: ((t == 0) & (e.anchor.sum(1) == 0) & (e.level < 5)).int(),
                       recursive=True) for f in fs]
        fs = TF.balance(TF.partition(fs, comm), comm)
        gh = TF.ghost(fs, comm)
        assert TF.validate(fs, gh)
        runs.append((fs, gh, comm.counters, kops.launch_counts["tree_transform"]))
    (fg, gg, cg, lg), (fc, gc, cc, lc) = runs
    assert lg > 0 and lc == 0
    assert cg == cc and cg["balance"]["alltoallv_bytes"] > 0
    for a, b in zip(fg, fc, strict=True):
        for k in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k))
    for a, b in zip(gg, gc, strict=True):
        for k in ("anchor", "level", "stype", "tree", "owner"):
            assert torch.equal(a[k].cpu(), b[k])


def _markers(P, trees, d, seed, dev):
    """P lex-sorted markers over `trees` trees with empty ranks (repeated
    markers) and a trailing (trees, 0) sentinel."""
    rng = np.random.default_rng(seed)
    mt = np.sort(rng.integers(0, trees, P)).astype(np.int32)
    mk = rng.integers(0, 1 << (d * MAXLEVEL[d]), P, dtype=np.uint64).astype(np.int64)
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    mt[0], mk[0] = 0, 0
    mk[2:4], mt[2:4] = mk[1], mt[1]
    mt[-1], mk[-1] = trees, 0
    return torch.from_numpy(mt).to(dev), torch.from_numpy(mk).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("P", [4, 4096, 4097, 8192])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_owner_rank_matches_plain(d, P, n):
    """owner_rank equals its plain version on either side of the 4096
    markers the kernel keeps in shared memory, with empty ranks."""
    dev = _card()
    key = _inputs(d, max(n, 2), seed=n + P, dev=dev)[0][:n].contiguous()
    tree = torch.randint(0, 5, (n,), dtype=torch.int32, device=dev)
    mt, mk = _markers(P, 4, d, seed=P + d, dev=dev)
    before = kops.launch_counts["owner_rank"]
    got, want = kops.owner_rank(tree, key, mt, mk), kref.owner_rank(tree, key, mt, mk)
    torch.cuda.synchronize()
    assert kops.launch_counts["owner_rank"] == before + 1
    if n > 1000:
        assert torch.unique(want).numel() > min(P - 4, 1000)
    assert got.device.type == "cuda" and got.dtype == torch.int32 and torch.equal(got, want)


SUCCESSOR_KINDS = 8


def _successor_inputs(d, n, seed, dev):
    """(anchor, level, stype, kind, carry level) on `dev`, kind i % 8 of row
    i: 0 an element inside the root simplex at a level 0..L (rows 0 and 8 at
    levels 0 and L), 1 element 0 of its level, 2 its level's last element
    (whose successor wraps to element 0), 3 and 7 an element whose +1
    carries from its level up to level i, i = 1, 2, ..., L in turn (its key
    digits of levels i + 1..level are 2^d - 1, digit i is not), 4 an
    element anywhere in the root cube, of any type (most outside the root
    simplex), 5 and 6 the anchors of kinds 0 and 4 with random bits finer
    than their level.  The carry level is 0 outside kinds 3 and 7."""
    L, nc = MAXLEVEL[d], 1 << d
    rng = np.random.default_rng(seed)
    kind = np.arange(n) % SUCCESSOR_KINDS
    level = rng.integers(0, L + 1, n)
    level[:1], level[8:9] = 0, L
    carry = (kind == 3) | (kind == 7)
    i = np.zeros(n, np.int64)
    i[carry] = 1 + np.arange(carry.sum()) % L
    level[carry] = rng.integers(i[carry], L + 1)
    key = rng.integers(0, 1 << (d * L), n, dtype=np.uint64).astype(np.int64)
    at_i = d * (L - np.maximum(i, 1))                 # bit of level i's digit
    lvl = torch.from_numpy(level.astype(np.int32))
    below = span_mask(d, L, lvl).numpy()               # the digits below the level
    digit = ((key >> at_i) & (nc - 1)) % (nc - 1)
    ones = ((1 << at_i) - 1) & ~below
    key = np.where(carry, (key & ~((nc - 1) << at_i)) | (digit << at_i) | ones, key)
    key = np.where(kind == 1, 0, np.where(kind == 2, (1 << (d * L)) - 1, key)) & ~below
    anchor, stype = (x.numpy().copy() for x in kref.decode(d, torch.from_numpy(key), lvl))
    h = (1 << (L - level))[:, None]
    cube = (kind == 4) | (kind == 6)
    anchor[cube] = rng.integers(0, 1 << L, (int(cube.sum()), d)) // h[cube] * h[cube]
    stype[cube] = rng.integers(0, 2 if d == 2 else 6, int(cube.sum()))
    fine = (kind == 5) | (kind == 6)
    anchor[fine] |= (rng.integers(0, 1 << L, (int(fine.sum()), d)) % h[fine]).astype(np.int32)
    return (torch.from_numpy(anchor).to(dev), lvl.to(dev), torch.from_numpy(stype).to(dev),
            kind, i)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_successor_matches_plain(d, n):
    """successor equals its plain version at levels 0..L, element 0 and the
    last element of a level (which wraps to element 0) included, on
    elements whose carry stops at every level 1..L (the constant-time
    branch), outside the root simplex and at level 0 (the walk), and on
    anchors with bits finer than their level, which both drop; the hex
    body on the same anchors too."""
    dev = _card()
    anchor, level, stype, kind, carry_level = _successor_inputs(d, n, seed=n + 5 * d, dev=dev)
    if n >= 1000:
        assert set(carry_level[(kind == 3) | (kind == 7)]) == set(range(1, MAXLEVEL[d] + 1))
        inside = kref.inside_root(anchor, level, stype).cpu().numpy()
        assert inside[kind == 0].all() and 0 < inside[kind == 4].mean() < 1
        fine = (anchor.cpu().numpy() % (1 << (MAXLEVEL[d] - level.cpu().numpy()))[:, None]).any(1)
        assert fine[(kind == 5) | (kind == 6)].mean() > 0.9
    before = kops.launch_counts["successor"]
    got, want = kops.successor(anchor, level, stype), kref.successor(anchor, level, stype)
    torch.cuda.synchronize()
    assert kops.launch_counts["successor"] == before + 1
    last = torch.from_numpy(kind == 2).to(dev)
    assert not bool(want[0][last].any()) and not bool(want[1][last].any())
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)
    zero = torch.zeros_like(stype)
    got = kops.successor(anchor, level, zero, ECLASS_HEX)
    want = kref.successor(anchor, level, zero, ECLASS_HEX)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_face_neighbor_matches_plain(d, n):
    """face_neighbor equals its plain version on elements anywhere in the
    root cube, one random face each."""
    dev = _card()
    anchor, level, stype = _cube_inputs(d, n, seed=n + 11 * d, dev=dev)
    face = torch.randint(0, d + 1, (n,), dtype=torch.int32, device=dev)
    before = kops.launch_counts["face_neighbor"]
    got = kops.face_neighbor(anchor, level, stype, face)
    want = kref.face_neighbor(anchor, level, stype, face)
    torch.cuda.synchronize()
    assert kops.launch_counts["face_neighbor"] == before + 1
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_element_queries_match_cpu(d):
    """The `BatchedOps` queries on a balanced forest's leaves, on the card
    and on the CPU, are equal; `new_uniform(method="successor")` on the
    card equals the decode method."""
    dev = _card()
    outs = []
    for device in (dev, torch.device("cpu")):
        comm = TF.SimComm(3)
        fs = TF.new_uniform(d, 2, 1, comm, device=device, method="successor")
        fs = [TF.adapt(f, lambda t, e: ((e.anchor.sum(1) == 0) & (e.level < 5)).int(),
                       recursive=True) for f in fs]
        fs = TF.balance(TF.partition(fs, comm), comm)
        mt, mk = TF.partition_markers(fs, comm)
        mt, mk = torch.from_numpy(mt).to(device), torch.from_numpy(mk.astype(np.int64)).to(device)
        out = []
        for f in fs:
            b, s = f.bops, f.simplices()
            nb, dual = b.face_neighbor(s, 1)
            out += [b.owner_rank(f.tree, f.keys, mt, mk), *b.successor(s), *b.predecessor(s),
                    b.local_index(s), *nb, dual]
        outs.append(out)
    for g, c in zip(*outs, strict=True):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), c)
    for method in ("decode", "successor"):
        f = TF.new_uniform_rank(d, 3, 3, 1, 4, method=method, device=dev)
        outs.append([f.anchor, f.level, f.stype, f.tree])
    for a, b in zip(outs[-2], outs[-1], strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- hex bodies
HEX_KERNELS = ["morton_key", "decode", "parent", "children", "face_sweep", "inside_root",
               "successor", "face_neighbor"]


def _hex_inputs(d, n, seed, dev):
    """(key with garbage below each level, level, anchor, zero types, box
    anchor, face) on `dev`: hexes of levels 0..L decoded from the keys, and
    the same levels with h-aligned anchors anywhere in [-2^L, 2^L)^d, so
    that neighbors leave the root on every side; one face of 2d each."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:2] = np.array([0, L])[:n]
    key = torch.from_numpy(rng.integers(0, 1 << (d * L), n, dtype=np.uint64).astype(np.int64))
    h = (1 << (L - level.astype(np.int64)))[:, None]
    box = (np.floor_divide(rng.integers(-(1 << L), 1 << L, (n, d)), h) * h).astype(np.int32)
    face = rng.integers(0, 2 * d, n).astype(np.int32)
    key, level = key.to(dev), torch.from_numpy(level).to(dev)
    anchor, zero = kref.decode(d, key, level, ECLASS_HEX)
    return (key, level, anchor, zero, torch.from_numpy(box).to(dev),
            torch.from_numpy(face).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name", HEX_KERNELS)
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_hex_kernel_matches_plain_version(name, d, n):
    """Each hex body equals its plain version exactly — on hexes inside
    the root and, for the sweep, inside-root test and single-face
    neighbor, anywhere in a box twice the root cube — and the kernel's hex
    launch count moves by one."""
    dev = _card()
    key, level, anchor, zero, box, face = _hex_inputs(d, n, seed=n + 10 * d, dev=dev)
    H = ECLASS_HEX
    if name == "morton_key":
        args, kernel, plain = (box, zero), kops.morton_key, kref.morton_key
    elif name == "decode":
        args = (key, level)
        kernel = lambda *a, eclass: kops.decode(d, *a, eclass)     # noqa: E731
        plain = lambda *a, eclass: kref.decode(d, *a, eclass)      # noqa: E731
    elif name in ("face_sweep", "inside_root"):
        args, kernel, plain = (box, level, zero), getattr(kops, name), getattr(kref, name)
    elif name == "face_neighbor":
        args, kernel, plain = (box, level, zero, face), kops.face_neighbor, kref.face_neighbor
    else:
        args, kernel, plain = (anchor, level, zero), getattr(kops, name), getattr(kref, name)
    before = dict(kops.class_launch_counts[name])
    got, want = kernel(*args, eclass=H), plain(*args, eclass=H)
    torch.cuda.synchronize()
    assert kops.class_launch_counts[name] == dict(before, hex=before["hex"] + 1)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_hex_tree_transform_crosses_every_face(d):
    """Across every glued face of a periodic hex brick (each of the 2d
    faces of each tree), the same-level outside neighbors of the tree's
    boundary hexes map into the neighbor tree's root, with the dual face
    through the hex face map: the kernel equals the plain version, and so
    do synthetic rows with a permuted and reflected axis."""
    dev = _card()
    cm = TC.cmesh_hex_brick(d, (2,) * d, periodic=(True,) * d)
    table = cm.gluing(dev).conn
    L, lv = MAXLEVEL[d], 3
    fs = TF.new_uniform(d, cm.num_trees, lv, TF.SimComm(1), cmesh=cm, device=dev)[0]
    nb, _t, dual, inside, _k = kops.face_sweep(fs.anchor, fs.level, fs.stype, ECLASS_HEX)
    fidx, eidx = torch.nonzero(~inside, as_tuple=True)
    conn = (fs.tree[eidx].long() * cm.nf_max + fidx).to(torch.int32)
    assert torch.unique(fidx).numel() == 2 * d
    args = (conn, nb[fidx, eidx].contiguous(), fs.level[eidx], torch.zeros_like(conn),
            dual[fidx, eidx].contiguous(), table)
    got = kops.tree_transform(*args, eclass=ECLASS_HEX)
    want = kref.tree_transform(*args, eclass=ECLASS_HEX)
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and torch.equal(g, w)
    assert bool(kops.inside_root(got[0], args[2], got[1], ECLASS_HEX).all())
    assert torch.equal(got[2], fidx.to(torch.int32) ^ 1)     # identity gluings: dual f ^ 1
    rot = np.eye(d, dtype=np.int64)
    rot[:2, :2] = [[0, -1], [1, 0]]
    row = TC.pack_connection(d, rot, np.full(d, 1 << L), np.zeros(2 if d == 2 else 6),
                             TC._hex_face_map(d, rot), 1, eclass=ECLASS_HEX)
    one = torch.as_tensor(row, device=dev)[None]
    zero = torch.zeros_like(conn)
    args = (zero, args[1], args[2], zero, args[4], one)
    for g, w in zip(kops.tree_transform(*args, eclass=ECLASS_HEX),
                    kref.tree_transform(*args, eclass=ECLASS_HEX), strict=True):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("P", [4, 4097])
def test_cuda_eval_route_over_hex_faces_matches_plain(d, P):
    """eval_route over nf = 2d face planes equals its plain version, with
    the markers in shared memory (P = 4) and binary searched (P = 4097)."""
    dev = _card()
    _anchor, level, _stype = _cube_inputs(d, 100_001, seed=P + 3, dev=dev)
    tgt, key, mt, mk = _route_inputs(d, level, dev, P=4, seed=P, nf=2 * d)
    if P > 4:
        rng = np.random.default_rng(P)
        mt = torch.from_numpy(np.sort(rng.integers(0, 4, P)).astype(np.int32)).to(dev)
        mk = torch.from_numpy(np.sort(rng.integers(0, 1 << (d * MAXLEVEL[d]), P,
                                                   dtype=np.uint64)).astype(np.int64)).to(dev)
    before = kops.class_launch_counts["eval_route"]["hex"]
    got = kops.eval_route(d, tgt, key, level, mt, mk)
    want = kref.eval_route(d, tgt, key, level, mt, mk)
    torch.cuda.synchronize()
    assert kops.class_launch_counts["eval_route"]["hex"] == before + 1
    assert got[0].shape == (2 * d, 100_001)
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hex_brick_d2", "hex_brick_d3", "hybrid_d2", "hybrid_d3"])
def test_cuda_hex_and_hybrid_pipeline_matches_cpu(name):
    """New -> Adapt -> Partition -> Balance -> Ghost -> validate over a hex
    brick and the hybrid pair on the card equals the CPU run, forest and
    ghost field for field, with equal per-phase bytes; the hex bodies ran."""
    dev = _card()
    cm = {"hex_brick_d2": lambda: TC.cmesh_hex_brick(2, (2, 2), periodic=(True, True)),
          "hex_brick_d3": lambda: TC.cmesh_hex_brick(3, (2, 2, 1)),
          "hybrid_d2": lambda: TC.cmesh_hybrid_pair(2),
          "hybrid_d3": lambda: TC.cmesh_hybrid_pair(3)}[name]()
    runs = []
    for device in (dev, torch.device("cpu")):
        kops.reset_launch_counts()
        comm = TF.SimComm(3)
        fs = TF.new_uniform(cm.d, cm.num_trees, 1, comm, cmesh=cm, device=device)
        fs = [TF.adapt(f, lambda t, e: ((e.anchor.sum(1) == 0) & (e.level < 4)).int(),
                       recursive=True) for f in fs]
        fs = TF.balance(TF.partition(fs, comm), comm)
        gh = TF.ghost(fs, comm)
        assert TF.validate(fs, gh)
        runs.append((fs, gh, comm.counters, dict(kops.class_launch_counts["face_sweep"])))
    (fg, gg, cg, lg), (fc, gc, cc, _l) = runs
    assert cg == cc and lg["hex"] > 0 and (lg["simplex"] > 0) == name.startswith("hybrid")
    for a, b in zip(fg, fc, strict=True):
        for k in ("anchor", "level", "stype", "tree", "keys"):
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k))
    for a, b in zip(gg, gc, strict=True):
        for k in ("anchor", "level", "stype", "tree", "owner"):
            assert torch.equal(a[k].cpu(), b[k])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simplex_d3", "simplex_d2", "brick_d3", "hex_brick_d3",
                                  "hybrid_d2"])
def test_cuda_iterate_oracles_and_checkpoints_match_cpu(name, tmp_path):
    """Iterate's pair tensor on every rank, both global-table oracles (their
    forests, layers and bytes), the bytes `save_forest` writes and the
    restore of them on the card equal the CPU run's; the sweep ran as a
    kernel, crossings through tree_transform, decode in ghost_oracle."""
    dev = _card()
    cm = {"simplex_d3": lambda: None, "simplex_d2": lambda: None,
          "brick_d3": lambda: TC.cmesh_brick(3, (2, 1, 1), periodic=(True, False, False)),
          "hex_brick_d3": lambda: TC.cmesh_hex_brick(3, (2, 2, 1)),
          "hybrid_d2": lambda: TC.cmesh_hybrid_pair(2)}[name]()
    d = 2 if name.endswith("d2") else 3
    trees = 4 if cm is None else cm.num_trees
    runs = []
    for device in (dev, torch.device("cpu")):
        from repro_torch.checkpoint import load_forest, save_forest

        kops.reset_launch_counts()
        comm = TF.SimComm(3)
        fs = TF.new_uniform(d, trees, 1, comm, cmesh=cm, device=device)
        fs = TF.partition([TF.adapt(f, lambda t, e: ((t == 0) & (e.anchor.sum(1) == 0)
                                                      & (e.level < 4)).int(), recursive=True)
                           for f in fs], comm)
        ob = TF.balance_oracle(fs, comm)
        og = TF.ghost_oracle(ob, comm)
        pairs = [TF.iterate(f, face_fn=lambda f, p: p)[0] for f in ob]
        step = save_forest(tmp_path / device.type, ob, comm)
        files = {p.name: p.read_bytes() for p in sorted(step.iterdir())}
        back = load_forest(tmp_path / device.type, TF.SimComm(2), cmesh=cm, device=device)
        runs.append((ob, og, pairs, files, back, comm.counters, dict(kops.launch_counts)))
    (fg, gg, pg, filg, bg, cg, lg), (fc, gc, pc, filc, bc, cc, lc) = runs
    assert cg == cc and filg == filc
    assert lg["face_sweep"] > 0 and lg["decode"] > 0 and not any(lc.values())
    assert (lg["tree_transform"] > 0) == (cm is not None)
    for a, b in zip(fg + bg, fc + bc, strict=True):
        for k in ("anchor", "level", "stype", "tree", "keys"):
            assert getattr(a, k).device.type == "cuda"
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k))
    for a, b in zip(gg, gc, strict=True):
        for k in ("anchor", "level", "stype", "tree", "owner"):
            assert torch.equal(a[k].cpu(), b[k])
    assert sum(len(p) for p in pg) > 0
    for a, b in zip(pg, pc, strict=True):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


# ---------------------------------------------------------------- attention
FLASH_CASES = [
    # (B, S, H, KV, hd, window, causal): ragged S, G = 1, 2, 4 and H (MQA),
    # every hd, a window of 100 and one smaller than a tile
    (1, 1, 4, 2, 32, None, True),
    (2, 127, 8, 8, 64, None, True),
    (1, 129, 16, 4, 96, None, True),
    (1, 1000, 16, 8, 128, None, True),
    (1, 300, 16, 1, 128, 100, True),
    (2, 200, 4, 2, 32, 20, True),
    # the 128-query, 128-key tiles of the bf16/fp16 body: S = 127, 128, 129,
    # 255, 257; windows of 128 and 129 and one longer than S; 3 x 16 x 9 =
    # 432 blocks (3 waves of 132 and a partial one); hd 32, 64, 96 at the
    # tile's edges
    (1, 127, 16, 8, 128, None, True),
    (2, 128, 16, 8, 128, None, True),
    (1, 129, 16, 8, 128, None, True),
    (1, 255, 16, 8, 128, None, True),
    (1, 257, 16, 8, 128, None, True),
    (1, 1000, 16, 8, 128, 128, True),
    (1, 1000, 16, 8, 128, 129, True),
    (1, 300, 16, 8, 128, 5000, True),
    (3, 1100, 16, 8, 128, None, True),
    (2, 257, 8, 4, 32, None, True),
    (1, 255, 8, 2, 64, 128, True),
    (1, 129, 4, 4, 96, 5000, True),
    # causal=False: ragged S (1, 2, 3 and 8 query tiles of 128: the
    # persistent grid pairs tile j with n_qt - 1 - j and runs an odd n_qt's
    # middle tile alone), G = 1, 2, 4 and H (MQA), and windows below, at and
    # past the tile with no causal bound on the keys
    (2, 127, 8, 8, 64, None, False),
    (1, 129, 16, 4, 96, None, False),
    (1, 1000, 16, 8, 128, None, False),
    (1, 257, 16, 8, 128, None, False),
    (1, 300, 16, 1, 128, 100, False),
    (2, 200, 4, 2, 32, 20, False),
    (1, 1000, 16, 8, 128, 129, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_matches_plain_version(case, dtype):
    """The attention kernel against its plain version on the same card
    tensors: 2e-5 in fp32 (CUDA cores, no TF32), 2e-2 in bf16/fp16 (p
    rounded for the tensor cores, the output rounded to the dtype), and
    each output row within 1e-5 / 1e-2 / 3e-3 (fp32 / bf16 / fp16) of its
    own norm, which small late rows of a long band would pass under the
    absolute floor; one launch, no plain call from the wrapper."""
    dev = _card()
    B, S, H, KV, hd, window, causal = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(S + hd)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dt)
    kops.reset_launch_counts()
    kref.reset_call_counts()
    got = kops.flash_attention(q, k, v, causal=causal, window=window)
    assert kops.launch_counts["flash_attention"] == 1 and not any(kref.call_counts.values())
    want = kref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.dtype == dt and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    row_tol = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 3e-3}[dtype]
    rows = (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)
    assert float(rows.max()) <= row_tol


@pytest.mark.cuda
def test_cuda_serving_matches_cpu():
    """Reduced qwen3 in fp32, the same weights on both devices: a prefill and
    4 greedy decode steps give equal tokens and logits within 1e-4; the
    kernel ran once a layer, no plain version."""
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params

    dev = _card()
    cfg = replace(reduced(get_config("qwen3-1.7b")), dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 37)))
    prefill, step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    runs = []
    for device in (dev, torch.device("cpu")):
        p = params.to(device)
        kops.reset_launch_counts()
        kref.reset_call_counts()
        logits, cache = prefill(p, {"tokens": prompt.to(device)}, init_cache(cfg, 2, 48,
                                                                           device=device))
        out, toks = [logits.cpu()], []
        for i in range(4):
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok.cpu())
            logits, cache = step(p, cache, tok, 37 + i)
            out.append(logits.cpu())
        runs.append((out, toks, dict(kops.launch_counts), dict(kref.call_counts)))
    (og, tg, lg, cg), (oc, tc, _l, _c) = runs
    assert lg["flash_attention"] == cfg.num_layers and not any(cg.values())
    for a, b in zip(tg, tc, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(og, oc, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_two_rank_processes_match_simcomm(tmp_path):
    """Two rank processes on the card (`run_ranks`, DistComm over a
    TCPStore) run the two-process pipeline at small size: equal to
    `SimComm(2)` on the card, forests, ghosts and bytes, with every kernel
    on the card."""
    from repro_torch.launch.multiproc import run_ranks
    from _torch_ranks import (PIPELINE_SCRIPT, assert_ranks_equal, corner_cb, load_ranks,
                              summed_bytes)

    dev = _card()
    run_ranks(PIPELINE_SCRIPT, 2, extra_args=(tmp_path, "cuda"), timeout=300.0)
    arrays, facts = load_ranks(tmp_path, 2)
    assert [f["device"] for f in facts] == ["cuda", "cuda"]
    sim = TF.SimComm(2)
    fs = TF.new_uniform(2, 2, 2, sim, device=dev)
    fs = [TF.adapt(f, corner_cb(), recursive=True) for f in fs]
    fs = TF.balance(fs, sim)
    gh = TF.ghost(fs, sim)
    n = TF.count_global(fs, sim)
    fs = TF.partition(fs, sim)
    assert TF.count_global(fs, sim) == n == facts[0]["n_global"]
    assert_ranks_equal(arrays, fs, gh)
    assert summed_bytes(facts) == {k: sim.bytes_for(k) for k in sim.counters}
