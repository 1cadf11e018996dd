"""The LM side of the port's Partition rule (`repro_torch.core.placement`)
against the JAX package's `repro.core.placement`, on the CPU.

Inputs are made from numpy seeds and handed to both packages.  A float32
cumulative sum adds in another order in jnp and in torch, so the rule for
`target_ranks` is: the integer targets are equal wherever the exact (float64)
midpoint prefix sum puts cum * P / total more than 1e-5 from an integer;
everywhere else they may differ by at most one rank, and stay monotone.
`page_order` and `partition_offsets` on uniform weights are exact;
`imbalance` agrees within 1e-6 relative on the same targets.  Then the port's
versions of the six properties of `tests/core/test_placement.py`, and the
`sfc_expert_placement` twin's printed lines against the JAX example's, run
live in this process on the same draws (and against its recorded lines
under the numpy they were recorded with).
"""

import contextlib
import io
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline box: bounded random sampling shim (tests/_pbt.py)
    from _pbt import given, settings, strategies as st

from _torch_example_lines import EXAMPLE_LINES, RECORDED_NUMPY
from repro.core import placement as J
from repro_torch.core import placement as T

CPU = "cpu"
FAR = 1e-5
IMB_RTOL = 1e-6
RANKS = [2, 7, 16, 32, 256, 1000]


def _weights(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "lognormal":          # sfc_expert_placement's documents
        return rng.lognormal(6.2, 1.1, size=4096).astype(np.float32)
    if kind == "zipf":               # sfc_expert_placement's expert loads
        return (rng.zipf(1.3, size=256) % 4000 + 50).astype(np.float32)
    if kind == "zero_runs":          # runs of zero weight between items
        w = rng.exponential(1.0, size=2048).astype(np.float32)
        w[rng.random(2048) < 0.4] = 0.0
        return w
    return rng.exponential(1.0, size=4096).astype(np.float32)


def _assert_targets_follow_the_rule(got: np.ndarray, want: np.ndarray, w: np.ndarray, P: int):
    assert got.dtype == np.int32 and want.dtype == np.int32
    w64 = w.astype(np.float64)
    x = (np.cumsum(w64) - w64 / 2) * P / max(w64.sum(), 1e-30)
    far = np.abs(x - np.round(x)) > FAR
    np.testing.assert_array_equal(got[far], want[far])
    assert np.abs(got.astype(np.int64) - want).max(initial=0) <= 1
    assert (np.diff(got) >= 0).all() and got.min(initial=0) >= 0 and got.max(initial=0) < P


@pytest.mark.parametrize("kind", ["lognormal", "zipf", "exponential", "zero_runs"])
@pytest.mark.parametrize("P", RANKS)
def test_target_ranks_follow_the_reference(kind, P):
    w = _weights(kind, seed=P)
    want = np.asarray(J.target_ranks(jnp.asarray(w), P))
    got = T.target_ranks(torch.from_numpy(w), P)
    assert got.device.type == CPU
    _assert_targets_follow_the_rule(got.numpy(), want, w, P)


@pytest.mark.parametrize("n,P", [(128, 8), (1000, 7), (4096, 32), (5, 8)])
def test_partition_offsets_on_uniform_weights_equal_the_reference(n, P):
    w = np.ones(n, np.float32)
    got = T.partition_offsets(torch.from_numpy(w), P)
    want = np.asarray(J.partition_offsets(jnp.asarray(w), P))
    assert got.dtype == torch.int32 and got.shape == (P + 1,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["lognormal", "zipf", "zero_runs"])
@pytest.mark.parametrize("P", [16, 32])
def test_partition_offsets_follow_the_targets(kind, P):
    w = _weights(kind, seed=P + 1)
    t = T.target_ranks(torch.from_numpy(w), P)
    off = T.partition_offsets(torch.from_numpy(w), P).numpy()
    assert off[0] == 0 and off[-1] == len(w)
    np.testing.assert_array_equal(np.searchsorted(t.numpy(), np.arange(P + 1)), off)


@pytest.mark.parametrize("kind", ["lognormal", "zipf", "exponential"])
@pytest.mark.parametrize("P", [16, 32])
def test_imbalance_matches_the_reference_on_the_same_targets(kind, P):
    w = _weights(kind, seed=3 * P)
    t = np.asarray(J.target_ranks(jnp.asarray(w), P))
    want = float(J.imbalance(jnp.asarray(w), jnp.asarray(t), P))
    got = T.imbalance(torch.from_numpy(w), torch.from_numpy(t.copy()), P)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= IMB_RTOL * want


@pytest.mark.parametrize("fn", ["expert_placement", "document_partition"])
@pytest.mark.parametrize("kind,P", [("zipf", 16), ("lognormal", 32), ("exponential", 7)])
def test_placements_follow_the_reference(fn, kind, P):
    w = _weights(kind, seed=P)
    want_t, want_imb = getattr(J, fn)(jnp.asarray(w), P)
    got_t, got_imb = getattr(T, fn)(torch.from_numpy(w), P)
    _assert_targets_follow_the_rule(got_t.numpy(), np.asarray(want_t), w, P)
    on_ours = float(J.imbalance(jnp.asarray(w), jnp.asarray(got_t.numpy()), P))
    assert abs(float(got_imb) - on_ours) <= IMB_RTOL * on_ours
    if np.array_equal(got_t.numpy(), np.asarray(want_t)):
        assert abs(float(got_imb) - float(want_imb)) <= IMB_RTOL * float(want_imb)


@pytest.mark.parametrize("pages,reqs", [(10, 4), (16, 8), (1, 1), (3, 5), (33, 2), (7, 64)])
def test_page_order_equals_the_reference(pages, reqs):
    got = T.page_order(pages, reqs, device=CPU)
    want = np.asarray(J.page_order(pages, reqs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("x,y,bits", [(5, 9, 4), (1023, 0, 10), (0, 1023, 10)])
def test_interleave_bits_equal_the_reference(x, y, bits):
    rng = np.random.default_rng(bits)
    xs = rng.integers(0, x + 1, 64).astype(np.int32)
    ys = rng.integers(0, y + 1, 64).astype(np.int32)
    got = T._interleave_bits_2d(torch.from_numpy(xs), torch.from_numpy(ys), bits)
    want = np.asarray(J._interleave_bits_2d(jnp.asarray(xs), jnp.asarray(ys), bits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_exports_the_reference_names_and_host_data_goes_to_the_card():
    """`__all__` is the reference's seven names; host data with no device
    is placed on the card (and raises without one), tensors keep theirs."""
    assert T.__all__ == J.__all__ and len(T.__all__) == 7
    assert all(callable(getattr(T, name)) for name in T.__all__)
    w = np.ones(8, np.float32)
    assert T.target_ranks(w, 2, device=CPU).device.type == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.target_ranks(w, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.page_order(4, 2)


def test_empty_weights():
    w = torch.zeros(0)
    assert T.target_ranks(w, 4).shape == (0,)
    np.testing.assert_array_equal(T.partition_offsets(w, 4).numpy(), np.zeros(5, np.int32))


# ----------------------------------- the properties of tests/core/test_placement.py
@given(st.lists(st.floats(0.0, 100.0), min_size=8, max_size=256), st.integers(2, 16))
@settings(max_examples=50, deadline=None)
def test_target_ranks_contiguous_monotone(ws, nr):
    t = T.target_ranks(torch.tensor(ws, dtype=torch.float32), nr).numpy()
    assert (np.diff(t) >= 0).all()
    assert t.min() >= 0 and t.max() <= nr - 1


def test_uniform_weights_perfectly_balanced():
    w = torch.ones(128)
    t = T.target_ranks(w, 8).numpy()
    assert (np.bincount(t, minlength=8) == 16).all()
    np.testing.assert_array_equal(T.partition_offsets(w, 8).numpy(), np.arange(9) * 16)


def test_weighted_imbalance_bounded():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.exponential(1.0, size=4096).astype(np.float32))
    t = T.target_ranks(w, 16)
    # SFC partition guarantees load <= mean + max_item; here items are small
    assert float(T.imbalance(w, t, 16)) < 1.10


def test_expert_placement_vs_naive():
    """Skewed expert loads: SFC-weighted placement beats uniform blocking."""
    rng = np.random.default_rng(1)
    loads = torch.from_numpy((rng.zipf(1.5, size=256) % 1000 + 1).astype(np.float32))
    dev, imb = T.expert_placement(loads, 16)
    naive = torch.arange(16).repeat_interleave(256 // 16)
    assert float(imb) <= float(T.imbalance(loads, naive, 16)) + 1e-6
    assert (np.diff(dev.numpy()) >= 0).all()       # contiguity


def test_document_partition_token_balance():
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(100, 4096, size=2048).astype(np.float32))
    _rank, imb = T.document_partition(toks, 32)
    assert float(imb) < 1.05


def test_page_order_is_permutation_and_local():
    order = T.page_order(16, 8, device=CPU).numpy()
    assert sorted(order.reshape(-1).tolist()) == list(range(16 * 8))
    # consecutive pages of one request are on average closer in the physical
    # order than under row-major layout across requests
    d_sfc = np.abs(np.diff(order, axis=1)).mean()
    rowmajor = np.arange(16 * 8).reshape(8, 16).T.reshape(8, 16)
    assert d_sfc < np.abs(np.diff(rowmajor, axis=1)).mean()


# ------------------------------------------------------------------ the twin
def test_sfc_expert_placement_twin_prints_the_examples_lines():
    from repro_torch.examples import sfc_expert_placement

    jax_example = runpy.run_path(
        str(Path(__file__).resolve().parents[1] / "examples" / "sfc_expert_placement.py"))
    want, buf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        jax_example["main"]()
    with contextlib.redirect_stdout(buf):
        r = sfc_expert_placement.main(device=CPU)
    assert buf.getvalue().splitlines() == want.getvalue().splitlines()
    if np.__version__ == RECORDED_NUMPY:
        assert buf.getvalue().splitlines() == EXAMPLE_LINES["sfc_expert_placement"]
    rng = np.random.default_rng(0)
    load = (rng.zipf(1.3, size=256) % 4000 + 50).astype(np.float32)
    want_dev, _ = J.expert_placement(jnp.asarray(load), 16)
    _assert_targets_follow_the_rule(r["device_of_expert"].numpy(), np.asarray(want_dev),
                                    load, 16)
