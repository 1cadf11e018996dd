"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a card these tests skip.  On a machine with a card
(and nvcc) run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; the plain versions themselves are held against the
JAX package by `tests/test_torch_kernels.py` on the CPU."""

import re

import numpy as np
import pytest
import torch

from repro_torch.core import cmesh as TC
from repro_torch.core import forest as TF
from repro_torch.core.keys import span_mask
from repro_torch.core.tables import MAXLEVEL
from repro_torch.core.types import ECLASS_HEX
from repro_torch.kernels import build, ops as kops, ref as kref

KERNELS = ["morton_key", "decode", "parent", "children", "face_sweep", "inside_root"]

# Marker counts of the owner-count tests: none, few, around a warp, around
# the 4096 the kernels once kept in shared memory, around 8192, around the
# 2^14 splitters of their shared-memory table (past it a splitter every 2
# markers and a window in global memory), and around the paper's 131,072
# ranks (8 markers a splitter; 131,071 leaves a last window of 7).
MARKER_COUNTS = [0, 1, 2, 31, 32, 33, 4095, 4096, 4097, 8191, 8192, 8193, 16383, 16384, 16385,
                 131071, 131072]


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


def _walk_grid():
    """(elements a block, elements a stride of the persistent grid) of the
    simplex key and decode walks (one element a thread), from the
    constants of `csrc/sfc.cu` and the card's SM count."""
    src = (build.CSRC_DIR / "sfc.cu").read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
         for k in ("kWalkThreads", "kWalkBlocks")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return c["kWalkThreads"], c["kWalkThreads"] * c["kWalkBlocks"] * sms


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["morton_key", "decode"])
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_walks_match_plain_at_grid_edges(name, d):
    """The simplex bodies of morton_key and decode (m levels a table lookup
    on a persistent grid, one element a thread) equal their plain versions
    at n = 0, 1, 2 and 31, one under, at and one past a block and the
    grid's stride, and 2^22 + 3; decode on keys with garbage digits below
    their levels, morton_key on anchors with bits above L (negative ones
    among them) on every other row.  Every launch moves the counter by one;
    n = 0 launches nothing."""
    dev = _card()
    block, stride = _walk_grid()
    sizes = sorted({0, 1, 2, 31, block - 1, block, block + 1, stride - 1, stride, stride + 1,
                    (1 << 22) + 3})
    L = MAXLEVEL[d]
    key, level, anchor, stype = _inputs(d, sizes[-1], seed=7 + d, dev=dev)
    assert bool((key & span_mask(d, L, level)).any())
    gen = torch.Generator(device=dev)
    gen.manual_seed(d)
    high = torch.randint(0, 1 << (32 - L), anchor.shape, generator=gen, device=dev,
                         dtype=torch.int32)
    odd = (torch.arange(sizes[-1], device=dev) & 1).bool()[:, None]
    anchor = torch.where(odd, anchor ^ torch.bitwise_left_shift(high, L), anchor).contiguous()
    assert bool((anchor < 0).any())
    for n in sizes:
        if name == "morton_key":
            args = (anchor[:n], stype[:n])
            kernel, plain = kops.morton_key, kref.morton_key
        else:
            args = (key[:n], level[:n])
            kernel, plain = (lambda *a: kops.decode(d, *a)), (lambda *a: kref.decode(d, *a))
        before = kops.launch_counts[name]
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        assert kops.launch_counts[name] == before + (n > 0)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w), n


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
    # no markers: every key to rank 0 on the card too, as the plain version says
    got = kops.owner_rank(tgt[0], key, mt[:0], mk[:0])
    assert torch.equal(got, kref.owner_rank(tgt[0], key, mt[:0], mk[:0])) and not bool(got.any())


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
@pytest.mark.parametrize("P", MARKER_COUNTS)
def test_cuda_eval_route_beyond_shared_markers_matches_plain(d, P):
    """eval_route's one O(log P) search equals the plain compare-and-count
    at every marker count (none included; past 2^14 through the splitter
    table and a window of markers in global memory) on lex-sorted markers
    with runs of empty ranks (repeated markers) and two trailing
    sentinels, on pairs equal to markers, before the first, past the last
    tree and (d = 3) at key 2^63 - 1; and with all the markers in one tree."""
    dev = _card()
    L = MAXLEVEL[d]
    rng = np.random.default_rng(P + d)
    _anchor, level, _stype = _cube_inputs(d, 100_000, seed=P, dev=dev)
    tgt0, key0, _mt, _mk = _route_inputs(d, level, dev, seed=P)
    for one_tree in (False, True):
        mt = (np.zeros(P, np.int32) if one_tree
              else np.sort(rng.integers(0, 4, P)).astype(np.int32))
        mk = rng.integers(0, 1 << (d * L), P, dtype=np.uint64).astype(np.int64)
        order = np.lexsort((mk, mt))
        mt, mk = mt[order], mk[order]
        mk[10:20], mt[10:20] = mk[9:10], mt[9:10]
        if not one_tree:
            mt[-2:], mk[-2:] = 4, 0
        mt, mk = torch.from_numpy(mt).to(dev), torch.from_numpy(mk).to(dev)
        tgt, key = _edge_queries(tgt0, key0, mt, mk, d, seed=P)
        before = kops.launch_counts["eval_route"]
        got = kops.eval_route(d, tgt, key, level, mt, mk)
        want = kref.eval_route(d, tgt, key, level, mt, mk)
        torch.cuda.synchronize()
        assert kops.launch_counts["eval_route"] == before + 1
        if P >= 4095 and not one_tree:
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


def _markers(P, trees, d, seed, dev, one_tree=False):
    """P lex-sorted markers over `trees` trees, or all in tree 0, the first
    at (0, 0); where P allows, a run of empty ranks (ranks 1-2 repeat rank
    3's marker) and, over several trees, a trailing (trees, 0) sentinel."""
    rng = np.random.default_rng(seed)
    mt = np.zeros(P, np.int32) if one_tree else np.sort(rng.integers(0, trees, P)).astype(np.int32)
    mk = rng.integers(0, 1 << (d * MAXLEVEL[d]), P, dtype=np.uint64).astype(np.int64)
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    if P:
        mt[0], mk[0] = 0, 0
    if P >= 4:
        mk[1:3], mt[1:3] = mk[3], mt[3]
    if P >= 3 and not one_tree:
        mt[-1], mk[-1] = trees, 0
    return torch.from_numpy(mt).to(dev), torch.from_numpy(mk).to(dev)


def _edge_queries(tree, key, mt, mk, d, seed, trees=4):
    """The (tree, key) queries with edge cases written in, in place of some
    random ones: a third equal to a marker, a run before the first marker
    (tree -1), a run past the last tree, and at d = 3 a run of key
    2^63 - 1 in tree 0.  Any shape; returns new tensors."""
    rng = np.random.default_rng(seed)
    t, k = tree.cpu().numpy().copy(), key.cpu().numpy().copy()
    ft, fk = t.reshape(-1), k.reshape(-1)
    m = ft.shape[0]
    if mt.numel():
        eq = np.nonzero(rng.random(m) < 1 / 3)[0]
        j = rng.integers(0, mt.numel(), eq.shape[0])
        ft[eq], fk[eq] = mt.cpu().numpy()[j], mk.cpu().numpy()[j]
    ft[0:4], fk[0:4] = -1, rng.integers(0, 1 << 40, 4)
    ft[4:8], fk[4:8] = trees + 1, 0
    if d == 3:
        ft[8:12], fk[8:12] = 0, (1 << 63) - 1
    return torch.from_numpy(t).to(tree.device), torch.from_numpy(k).to(key.device)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("P", MARKER_COUNTS)
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_cuda_owner_rank_matches_plain(d, P, n):
    """owner_rank equals its plain version at every marker count of the
    one search (none included), with a run of empty ranks and a sentinel,
    on queries equal to markers, before the first, past the last tree and
    (d = 3) at key 2^63 - 1; and with all the markers in one tree."""
    dev = _card()
    key = _inputs(d, max(n, 12), seed=n + P, dev=dev)[0][:max(n, 12)].contiguous()
    tree = torch.randint(0, 5, key.shape, dtype=torch.int32, device=dev)
    for one_tree in (False, True):
        mt, mk = _markers(P, 4, d, seed=P + d, dev=dev, one_tree=one_tree)
        t, k = _edge_queries(tree, key, mt, mk, d, seed=n + P)
        t, k = t[:n].contiguous(), k[:n].contiguous()
        before = kops.launch_counts["owner_rank"]
        got, want = kops.owner_rank(t, k, mt, mk), kref.owner_rank(t, k, mt, mk)
        torch.cuda.synchronize()
        assert kops.launch_counts["owner_rank"] == before + 1
        if n > 1000 and not one_tree:
            assert torch.unique(want).numel() > min(P - 4, 1000)
        assert got.device.type == "cuda" and got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [5, 4097, 20000])
def test_cuda_owner_search_reads_views_at_any_offset(P):
    """Views that start one element into their storage (so not aligned for
    the kernels' vector loads and stores) give what the plain version
    gives, through owner_rank and through eval_route's outputs."""
    dev = _card()
    d = 3
    _anchor, level, _stype = _cube_inputs(d, 3001, seed=P, dev=dev)
    tgt, key, _mt, _mk = _route_inputs(d, level, dev, seed=P)
    mt, mk = _markers(P, 4, d, seed=P, dev=dev)
    tgt, key = _edge_queries(tgt, key, mt, mk, d, seed=P)
    off_t = torch.cat([tgt.new_zeros(1), tgt.reshape(-1)])[1:].view(tgt.shape)
    off_k = torch.cat([key.new_zeros(1), key.reshape(-1)])[1:].view(key.shape)
    got = kops.eval_route(d, off_t, off_k, level, mt, mk)
    want = kref.eval_route(d, tgt, key, level, mt, mk)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    t1, k1 = off_t.reshape(-1)[2:], off_k.reshape(-1)[2:]
    assert t1.data_ptr() % 16 and k1.data_ptr() % 16
    assert torch.equal(kops.owner_rank(t1, k1, mt, mk), kref.owner_rank(t1, k1, mt, mk))


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
@pytest.mark.parametrize("P", [4] + MARKER_COUNTS)
def test_cuda_eval_route_over_hex_faces_matches_plain(d, P):
    """eval_route over nf = 2d face planes equals its plain version at
    every marker count (P = 4: `_route_inputs`' markers with an empty rank;
    else `_markers`' with a run of empty ranks and a sentinel), with the
    edge-case pairs of `_edge_queries`."""
    dev = _card()
    _anchor, level, _stype = _cube_inputs(d, 100_001, seed=P + 3, dev=dev)
    tgt, key, mt, mk = _route_inputs(d, level, dev, P=4, seed=P, nf=2 * d)
    if P != 4:
        mt, mk = _markers(P, 4, d, seed=P, dev=dev)
        tgt, key = _edge_queries(tgt, key, mt, mk, d, seed=P)
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
    # mixtral-8x7b's prefill (chip_smoke.py phase 9a): a window of 4096 at S = 8192
    (2, 8192, 32, 8, 128, 4096, True),
    # hd 256 (its own body: 64-key tiles, no producer warp): ragged S, causal,
    # windowed (below, at and past the 64-key tile) and not, MQA and G = 2, 4
    (1, 300, 4, 1, 256, None, True),
    (2, 129, 4, 2, 256, None, False),
    (1, 1000, 16, 1, 256, 100, True),
    (1, 257, 8, 1, 256, 64, True),
    (2, 200, 4, 2, 256, 50, False),
    (1, 1, 4, 1, 256, None, True),
    (1, 65, 8, 2, 256, 17, True),
    # recurrentgemma-9b's local attention, whisper-medium's encoder and its
    # decoder prompt, and pixtral-12b's prefill at their shapes (chip_smoke.py
    # phases 10b, 10c and 10d)
    (2, 8192, 16, 1, 256, 2048, True),
    (8, 1500, 16, 16, 64, None, False),
    (8, 64, 16, 16, 64, None, True),
    (4, 2048, 32, 8, 128, None, True),
    # mixtral-8x7b's training micro-batch (chip_smoke.py phase 11a): B 1, a
    # window of 4096 at S = 4096
    (1, 4096, 32, 8, 128, 4096, True),
    # the training micro-batches of phase 12: recurrentgemma-9b's local
    # attention (12b), whisper-medium's decoder (12c; its encoder is 10c's
    # shape above) and pixtral-12b's 1024 patches + 3072 tokens (12d)
    (1, 4096, 16, 1, 256, 2048, True),
    (8, 4096, 16, 16, 64, None, True),
    (1, 4096, 32, 8, 128, None, True),
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


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 300, 16, 8, 128, None, True), (1, 257, 8, 1, 64, 100, True),
                                  (1, 200, 4, 4, 32, None, False)])
def test_cuda_flash_function_gradients_match_plain_autograd(case, dtype, rows, monkeypatch):
    """`FlashAttentionFn` on the card (forward: one kernel launch, no plain
    forward; backward: the plain backward) against autograd through the
    plain forward on the same card tensors: each of dq, dk, dv within 1e-4
    relative L2 in fp32; in bf16 each row (over hd) within 2e-2 of its own
    norm, as FLASH_ROW_TOL's check does for the forward.  With `rows`, the
    backward's block bound is cut to that many query rows, so it runs in
    several blocks (and key windows) as it does at training's lengths."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, KV, hd, window, causal = case
    if rows is not None:
        monkeypatch.setattr(kref, "BACKWARD_BLOCK_BYTES", 4 * B * H * S * rows)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(S)
    base = [torch.randn(B, S, n, hd, generator=gen, device=dev).to(dt) for n in (H, KV, KV)]
    do = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
    got = [t.clone().requires_grad_(True) for t in base]
    kops.reset_launch_counts()
    kref.reset_call_counts()
    kops.FlashAttentionFn.apply(*got, causal, window).backward(do)
    assert kops.launch_counts["flash_attention"] == 1
    assert kref.call_counts["flash_attention"] == 0
    assert kref.call_counts["flash_attention_backward"] == 1
    want = [t.clone().requires_grad_(True) for t in base]
    kref.flash_attention(*want, causal=causal, window=window).backward(do)
    for g, w in zip(got, want):
        assert g.grad.dtype == dt and float(g.grad.float().abs().max()) > 0
        if dtype == "float32":
            assert _rel_l2(g.grad, w.grad) <= 1e-4
        else:
            diff = (g.grad.float() - w.grad.float()).norm(dim=-1)
            assert float((diff / w.grad.float().norm(dim=-1).clamp_min(1e-6)).max()) <= 2e-2


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu():
    """The `train_lm` twin's tiny preset (reduced qwen3, fp32, TF32 off) on
    the same weights and batch: every gradient leaf on the card within
    1e-4 relative L2 of the CPU's, wq, wk and wv of every layer nonzero
    (attention's gradient reaches them through the kernel), then one
    `make_train_step` each: the metrics and every parameter within 1e-4."""
    from repro_torch.data import DataPipeline
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import init_opt_state

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, shape = train_lm.preset("tiny")
    batch = DataPipeline(cfg, shape, seed=0, device="cpu").batch(0)
    runs = []
    for device in (dev, torch.device("cpu")):
        model = init_params(cfg, seed=0, device="cpu").to(device).requires_grad_()
        kops.reset_launch_counts()
        loss, _ = loss_fn(cfg, model, {k: v.to(device) for k, v in batch.items()})
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        launches = kops.launch_counts["flash_attention"]
        model.zero_grad(set_to_none=True)
        step = make_train_step(cfg, num_micro=1, lr=1e-3, warmup=1, total_steps=10)
        model, _opt, m = step(model, init_opt_state(model), {k: v.to(device)
                                                          for k, v in batch.items()}, 0)
        runs.append((loss.item(), grads, launches, {k: float(v) for k, v in m.items()},
                     {n: p.detach().cpu() for n, p in model.named_parameters()}))
    (lg, gg, ng, mg, pg), (lc, gc, _nc, mc, pc) = runs
    assert ng == 2 * cfg.num_layers          # forward and the remat recompute
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for name in gc:
        assert _rel_l2(gg[name], gc[name]) <= 1e-4, name
        if name.split(".")[-1] in ("wq", "wk", "wv"):
            assert float(gg[name].abs().max()) > 0, name
    for k in ("loss", "grad_norm", "lr"):
        assert abs(mg[k] - mc[k]) <= 1e-4 * abs(mc[k]), k
    for name in pc:
        assert _rel_l2(pg[name], pc[name]) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8192, 4096])
def test_cuda_flash_function_gradients_at_a_window_that_bites(S):
    """`chip_smoke.py` phase 11c: mixtral's heads under its window of 4096,
    bf16, at S = 8192 (the window bites) and at phase 11a's micro-batch (S
    = 4096): the Function's output (one kernel launch) within 2e-2 + 2e-2
    |want| of the plain forward's and each row within 1e-2; dq, dk and dv
    each row within 2e-2 of the plain forward's autograd."""
    dev = _card()
    B, H, KV, hd, window = 1, 32, 8, 128, 4096
    gen = torch.Generator(device=dev).manual_seed(11)
    base = [torch.randn(B, S, n, hd, generator=gen, device=dev).bfloat16() for n in (H, KV, KV)]
    do = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    got = [t.clone().requires_grad_(True) for t in base]
    kops.reset_launch_counts()
    out = kops.FlashAttentionFn.apply(*got, True, window)
    assert kops.launch_counts["flash_attention"] == 1
    want = [t.clone().requires_grad_(True) for t in base]
    ref_out = kref.flash_attention(*want, causal=True, window=window)
    diff = (out.detach().float() - ref_out.detach().float()).abs()
    assert float((diff - 2e-2 * (1 + ref_out.detach().float().abs())).max()) <= 0
    assert float((diff.norm(dim=-1) / ref_out.detach().float().norm(dim=-1)).max()) <= 1e-2
    out.backward(do)
    ref_out.backward(do)
    del out, ref_out, diff
    for g, w in zip(got, want):
        d = (g.grad.float() - w.grad.float()).norm(dim=-1)
        assert float((d / w.grad.float().norm(dim=-1).clamp_min(1e-6)).max()) <= 2e-2


def _moe_twin(arch: str, changes: dict, dev: torch.device):
    """`chip_smoke.py` phase 11b's run on `dev`: reduced `arch` in fp32 with
    `changes` from the weights drawn on the CPU from seed 0, three steps of
    make_train_step at its config's optimizer and dtypes ((B, S,
    num_micro): mixtral (4, 96, 2), past its window of 64; deepseek-v3 (4,
    32, 4)); returns (losses, parameters on the CPU, row 12's launches)."""
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(reduced(get_config(arch)), dtype="float32", **changes)
    B, S, num_micro = {"mixtral-8x7b": (4, 96, 2), "deepseek-v3-671b": (4, 32, 4)}[arch]
    model = init_params(cfg, seed=0, device="cpu").to(dev)
    opt = init_opt_state(model, cfg.optimizer, cfg.opt_state_dtype)
    step = make_train_step(cfg, num_micro=num_micro, lr=1e-2, warmup=2, total_steps=6,
                           clip_norm=0.5)
    rng = np.random.default_rng(0)
    kops.reset_launch_counts()
    losses = []
    for i in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
        model, opt, m = step(model, opt, {"tokens": toks}, i)
        losses.append(float(m["loss"]))
    return (losses, {n: p.detach().cpu() for n, p in model.named_parameters()},
            kops.launch_counts["flash_attention"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,changes,tol", [
    ("mixtral-8x7b", {}, 1e-4),
    ("deepseek-v3-671b", {"opt_state_dtype": "float32", "grad_acc_dtype": "float32"}, 1e-4),
    ("deepseek-v3-671b", {}, 4 * 2 ** -8)])
def test_cuda_moe_train_steps_match_cpu(arch, changes, tol):
    """`chip_smoke.py` phase 11b: three steps on the card and on the CPU from
    the same weights and batches: each loss within rtol 1e-5, every
    parameter within `tol` relative L2 (fp32 sums in another order; with
    deepseek-v3's own bf16 accumulation over 4 micro-batches and bf16
    Adafactor state, a bf16 rounding a micro-batch: `chip_smoke.MOE_TWIN`);
    mixtral launches row 12 2 x 2 layers x 2 micro-batches a step."""
    dev = _card()
    (lg, pg, ng), (lc, pc, nc) = (_moe_twin(arch, changes, dev),
                                  _moe_twin(arch, changes, torch.device("cpu")))
    assert ng == (24 if arch == "mixtral-8x7b" else 0) and nc == 0
    for a, b in zip(lg, lc, strict=True):
        assert abs(a - b) <= 1e-5 * abs(b), (lg, lc)
    for name in pc:
        assert _rel_l2(pg[name], pc[name]) <= tol, name


@pytest.mark.cuda
def test_cuda_moe_remat_none_and_block_give_the_same_gradients():
    """`chip_smoke.py` phase 11b on the card: reduced mixtral's loss and
    every gradient leaf equal with remat "none" and "block" within rtol
    1e-6 and atol 1e-7, so the recompute routes every token as the
    forward did."""
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params, loss_fn

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(reduced(get_config("mixtral-8x7b")), dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 96))).to(dev)
    runs = []
    for remat in ("block", "none"):
        c = replace(cfg, remat=remat)
        model = init_params(c, seed=0, device="cpu").to(dev).requires_grad_()
        loss = loss_fn(c, model, {"tokens": toks})[0]
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    (lb, gb), (ln, gn) = runs
    assert abs(lb - ln) <= 1e-6 * abs(ln)
    for name in gn:
        torch.testing.assert_close(gb[name], gn[name], rtol=1e-6, atol=1e-7, msg=name)


def _moe_cfg(arch, **moe):
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced

    cfg = replace(reduced(get_config(arch)), dtype="float32")
    return replace(cfg, moe=replace(cfg.moe, **moe)) if moe else cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch,moe", [("mixtral-8x7b", {}),
                                      ("mixtral-8x7b", {"capacity_factor": 0.5}),
                                      ("deepseek-v3-671b", {"num_experts": 16, "top_k": 8})])
def test_cuda_moe_layer_matches_cpu(arch, moe):
    """The reduced MoE layer in fp32 (no TF32) on the same weights and
    inputs: the routing (ids, pos, keep) equal on both devices, drops
    included, the aux loss within 1e-6, the output within 1e-4 of its max
    |value| (cuBLAS and the CPU's BLAS sum in other orders)."""
    from repro_torch.models import lm, moe as tmoe

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg(arch, **moe)
    init = lm._Init(5, torch.device("cpu"), torch.float32)
    p = {n: t.data for n, t in lm._moe_params(cfg, init).items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 24, cfg.d_model),
                                                                  dtype=np.float32))
    runs = []
    for device in (dev, torch.device("cpu")):
        pd = {n: t.to(device) for n, t in p.items()}
        out, aux = tmoe.moe_layer(cfg, pd, x.to(device))
        route = tmoe.route(cfg, pd["router"], x.to(device).reshape(48, -1))
        runs.append((out.cpu(), float(aux), [t.cpu() for t in route[2:]]))
    (og, ag, rg), (oc, ac, rc) = runs
    for a, b in zip(rg, rc, strict=True):
        assert torch.equal(a, b)
    if moe.get("capacity_factor") == 0.5:
        assert not rc[2].all()
    assert abs(ag - ac) <= 1e-6
    assert float((og - oc).abs().max()) <= 1e-4 * float(oc.abs().max())


@pytest.mark.cuda
def test_cuda_ring_cache_and_mla_match_cpu():
    """Reduced mixtral's ring (window 16, 16 slots): a long prefill of 20
    through the kernel with the window, then 6 decode steps past the wrap;
    and reduced deepseek-v3's MLA, expanded and absorbed (a prefill of 20
    into 32 slots, 3 decode steps): each output within 1e-4 card against
    CPU, the ring's positions equal."""
    from dataclasses import replace

    from repro_torch.models import init_cache, init_params
    from repro_torch.models import layers as ly

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(8)
    for arch in ("mixtral-8x7b", "deepseek-v3-671b"):
        cfg = _moe_cfg(arch)
        if cfg.window:
            cfg = replace(cfg, window=16)
        blk = init_params(replace(cfg, num_layers=1), seed=2, device="cpu").layers[0]
        xs = [rng.standard_normal((2, n, cfg.d_model), dtype=np.float32)
              for n in (20, 1, 1, 1)]
        runs = []
        for device in (dev, torch.device("cpu")):
            attn = {n: t.to(device) for n, t in blk.attn.items()}
            cache = {n: t[0] for n, t in init_cache(replace(cfg, num_layers=1), 2, 24 if
                                                    cfg.window else 32,
                                                    device=device)["layers"].items()}
            kops.reset_launch_counts()
            outs, start = [], 0
            for x in xs:
                n = x.shape[1]
                pos = torch.arange(start, start + n, dtype=torch.int32,
                                   device=device)[None].expand(2, n)
                xt = torch.from_numpy(x).to(device)
                if cfg.mla is None:
                    o, _ = ly.gqa_attention(cfg, attn, xt, positions=pos, cache=cache,
                                            cache_pos=start, window=cfg.window)
                else:
                    if start == 0:
                        outs.append(ly.mla_attention(cfg, attn, xt, positions=pos)[0].cpu())
                    o, _ = ly.mla_attention(cfg, attn, xt, positions=pos, cache=cache,
                                            cache_pos=start)
                outs.append(o.cpu())
                start += n
            runs.append((outs, {n: t.cpu() for n, t in cache.items()},
                         kops.launch_counts["flash_attention"]))
        (og, cg, lg), (oc, cc, _lc) = runs
        assert lg == (1 if cfg.mla is None else 0)
        for a, b in zip(og, oc, strict=True):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        if "pos" in cc:
            assert torch.equal(cg["pos"], cc["pos"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_cuda_moe_serving_matches_cpu(arch):
    """Reduced mixtral (window 64) and deepseek-v3 in fp32, the same weights
    on both devices: a prefill of 80 into a cache of 96 and 8 greedy decode
    steps (mixtral's ring wraps) give equal tokens and logits within 1e-4;
    on the card mixtral's prefill launches the kernel once a layer and
    deepseek-v3's none (MLA is outside its domain); no plain flash call."""
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg(arch)
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 80)))
    prefill, step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    runs = []
    for device in (dev, torch.device("cpu")):
        p = params.to(device)
        kops.reset_launch_counts()
        kref.reset_call_counts()
        logits, cache = prefill(p, {"tokens": prompt.to(device)},
                                init_cache(cfg, 2, 96, device=device))
        out, toks = [logits.cpu()], []
        for i in range(8):
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok.cpu())
            logits, cache = step(p, cache, tok, 80 + i)
            out.append(logits.cpu())
        runs.append((out, toks, dict(kops.launch_counts), dict(kref.call_counts)))
    (og, tg, lg, cg), (oc, tc, _l, _c) = runs
    assert lg["flash_attention"] == (cfg.num_layers if cfg.mla is None else 0)
    assert not any(cg.values())
    for a, b in zip(tg, tc, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(og, oc, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b", "whisper-medium",
                                  "pixtral-12b"])
def test_cuda_family_serving_matches_cpu(arch):
    """The ssm, hybrid, encdec and vlm families reduced, in fp32, the same
    weights and inputs on both devices: a prefill of 64 (after 16 patches
    for the vlm; 32 frames for the encdec) into a cache of 96 (the hybrid's
    ring of 64 slots wraps) and 8 greedy decode steps give equal tokens and
    logits within 1e-4, and equal caches within 1e-4 after them; on the
    card the prefill launches the kernel once an attention layer (none for
    the ssm; the encoder's non-causal layers and the decoder's for the
    encdec), no plain flash call."""
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            0.1 * rng.standard_normal((2, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    P = cfg.num_patches if cfg.family == "vlm" else 0
    if P:
        batch["patches"] = torch.from_numpy(
            0.1 * rng.standard_normal((2, P, cfg.d_model), dtype=np.float32))
    prefill, step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    runs = []
    for device in (dev, torch.device("cpu")):
        p = params.to(device)
        kops.reset_launch_counts()
        kref.reset_call_counts()
        cache = init_cache(cfg, 2, 96, device=device)
        logits, cache = prefill(p, {k: v.to(device) for k, v in batch.items()}, cache)
        out, toks = [logits.cpu()], []
        for i in range(8):
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok.cpu())
            logits, cache = step(p, cache, tok, P + 64 + i)
            out.append(logits.cpu())
        runs.append((out, toks, dict(kops.launch_counts), dict(kref.call_counts), cache))
    (og, tg, lg, cg, cache_g), (oc, tc, _l, _c, cache_c) = runs
    attention = {"ssm": 0, "hybrid": cfg.num_layers // 3, "encdec": cfg.encoder_layers
                 + cfg.num_layers, "vlm": cfg.num_layers}[cfg.family]
    assert lg["flash_attention"] == attention and not any(cg.values())
    for a, b in zip(tg, tc, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(og, oc, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])

    for a, b in zip(leaves(cache_g), leaves(cache_c), strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_through_a_one_card_mesh(dtype):
    """Row 12 through a (1, 1) ("data", "model") DeviceMesh over NCCL (a
    world of one): `attention_core` on DTensors launches the kernel on the
    local heads (`models.spmd.attention`), once, and equals the unsharded
    call bit for bit; the plain version never runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import layers as ly

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(2, 256, H, 128, generator=g, device=dev).to(dtype)
               for H in (16, 8, 8))
    want = ly.attention_core(q, k, v, causal=True)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        pl = [Shard(0), Shard(2)]
        dq, dk, dv = (distribute_tensor(t, mesh, pl, src_data_rank=None) for t in (q, k, v))
        kops.reset_launch_counts()
        kref.reset_call_counts()
        got = ly.attention_core(dq, dk, dv, causal=True)
        assert kops.launch_counts["flash_attention"] == 1
        assert kref.call_counts["flash_attention"] == 0
        assert list(got.placements) == [Shard(0), Replicate()]     # heads whole: 'model' of 1
        assert torch.equal(got.redistribute(mesh, [Replicate(), Replicate()]).to_local(), want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_one_card_mesh_train_steps_equal_the_plain_steps():
    """qwen3-1.7b at full width and two layers (bf16, AdamW, remat "block",
    2 micro-batches of 2 x 1024), three `make_train_step` steps plain and
    through a (1, 1) DeviceMesh over NCCL: every loss, gradient norm,
    parameter and moment bit for bit after each step.  The schedule's rate
    is 0 at step 0, so steps 1 and 2 are the first to update; AdamW divides
    by its bias corrections on the card in both (a card kernel divides by
    a host scalar through its reciprocal, a DTensor's division by a
    tensor, and the two rounded apart)."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state

    dev = _card()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2)
    kw = dict(num_micro=2, lr=3e-4, warmup=2, total_steps=7)
    g = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 1024), generator=g,
                                        dtype=torch.int32).to(dev)} for _ in range(3)]
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t      # noqa: E731
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        ref = init_params(cfg, seed=1, device=dev)
        s0 = init_opt_state(ref, cfg.optimizer, cfg.opt_state_dtype)
        params = init_params(cfg, seed=1, device=dev)
        pspecs = sh.params_pspecs(cfg, mesh, params)
        sh.distribute_params(cfg, params, mesh, pspecs)
        s1 = sh.distribute_tree(init_opt_state(params, cfg.optimizer, cfg.opt_state_dtype),
                                sh.opt_state_pspecs(cfg, mesh, pspecs, params, cfg.optimizer),
                                mesh)
        specs = sh.batch_pspecs(mesh, batches[0])
        micro = {k: sh.to_named(mesh, s) for k, s in
                 sh.batch_pspecs(mesh, {"tokens": batches[0]["tokens"][:2]}).items()}
        plain = make_train_step(cfg, **kw)
        meshed = make_train_step(cfg, **kw, micro_shardings=micro,
                                 grad_shardings={n: sh.to_named(mesh, s)
                                                 for n, s in pspecs.items()})
        for i, batch in enumerate(batches):
            ref, s0, m0 = plain(ref, s0, batch, i)
            params, s1, m1 = meshed(params, s1, sh.distribute_tree(batch, specs, mesh), i)
            assert float(full(m1["loss"])) == float(m0["loss"]), i
            assert float(full(m1["grad_norm"])) == float(m0["grad_norm"]), i
            for (n, a), (_, b) in zip(ref.named_parameters(), params.named_parameters()):
                assert torch.equal(full(b.detach()), a.detach()), (i, n)
            for n in s0.mu:
                assert torch.equal(full(s1.mu[n]), s0.mu[n]), (i, n)
                assert torch.equal(full(s1.nu[n]), s0.nu[n]), (i, n)
    finally:
        dist.destroy_process_group()
