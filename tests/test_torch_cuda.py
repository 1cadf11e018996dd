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
    assert kops.launch_counts == {k: 1 for k in KERNELS + ["eval_route", "tree_transform",
                                                           "owner_rank", "successor",
                                                           "face_neighbor"]}
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


def _route_inputs(d, level, dev, P=4, seed=0):
    """Per (face, element) pair a target tree and a span-aligned key at the
    element's level; P lex-sorted markers with an empty rank (a repeated
    marker) and a trailing (num_trees, 0) sentinel."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    n = level.shape[0]
    lv = level.cpu().numpy().astype(np.int64)
    shift = (d * (L - lv))[None, :]
    raw = rng.integers(0, 1 << (d * L), (d + 1, n), dtype=np.uint64).astype(np.int64)
    key = (raw >> shift) << shift
    tgt = rng.integers(0, 4, (d + 1, n)).astype(np.int32)
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_successor_matches_plain(d, n):
    """successor equals its plain version at levels 0..L, element 0 and the
    last element of a level (which wraps to element 0) included."""
    dev = _card()
    key, level, _a, _b = _inputs(d, max(n, 2), seed=n + 5 * d, dev=dev)
    key, level = key[:n], level[:n]
    span1 = span_mask(d, MAXLEVEL[d], level)
    pick = torch.arange(n, device=dev) % 3
    key = torch.where(pick == 1, 0, torch.where(pick == 2, ((1 << (d * MAXLEVEL[d])) - 1) ^ span1,
                                                key))
    anchor, stype = kref.decode(d, key, level)
    before = kops.launch_counts["successor"]
    got, want = kops.successor(anchor, level, stype), kref.successor(anchor, level, stype)
    torch.cuda.synchronize()
    assert kops.launch_counts["successor"] == before + 1
    last = pick == 2
    assert not bool(want[0][last].any()) and not bool(want[1][last].any())
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


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
