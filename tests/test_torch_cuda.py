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

from repro_torch.core import forest as TF
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
    assert kops.morton_key(anchor[:0], stype[:0]).shape == (0,)
    assert kops.launch_counts == {k: 1 for k in KERNELS + ["eval_route"]}
    assert not any(kref.call_counts.values())
    with pytest.raises(ValueError):
        kops.morton_key(anchor, stype.cpu())


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
