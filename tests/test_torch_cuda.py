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

KERNELS = ["morton_key", "decode", "parent", "children"]


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
    assert kops.morton_key(anchor[:0], stype[:0]).shape == (0,)
    assert kops.launch_counts == {k: 1 for k in KERNELS}
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
