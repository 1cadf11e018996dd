"""The port's Mamba-2 block and the ssm family (`repro_torch.models.ssm`,
mamba2-130m reduced) against the JAX package's, on the CPU.

Functions on seeded numpy inputs: `causal_conv` with and without the decode
state, and `ssd_chunked` (three chunks, with and without an initial state
h0) against `repro.models.ssm`, in fp32 within 2e-5 (rtol and atol: the
same fp32 products summed in another order) and in bf16 within 2e-2 of the
reference's max |value| (inputs and output rounded to bf16).  The model
(`tests/_torch_family.py`): the forward over 64 tokens (two chunks of 32),
a prefill of 64 into the cache (conv and state compared) and 3 decode
steps (the O(1) update), in fp32 and bf16; the parameters' round trip
through `convert`; `loss_fn` and a train step on the reduced config.

The SSD's gradient at a chunk of 256 with dt of mamba2-130m's scale:
finite in the port, equal to a float64 sequential recurrence's, where the
reference's `jax.grad` is NaN (ROADMAP.md §3, item 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

from _torch_family import Case, check_model, check_round_trip, check_training_runs

ARCH = "mamba2-130m"
FN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FN_TOL[dtype], atol=FN_TOL[dtype])
    else:
        assert np.abs(got - want).max() <= FN_TOL[dtype] * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _ssd_inputs(B=2, S=96, H=3, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"xh": rng.standard_normal((B, S, H, P), dtype=np.float32),
            "dt": np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32))),
            "A": -np.exp(0.5 * rng.standard_normal(H).astype(np.float32)),
            "Bm": rng.standard_normal((B, S, N), dtype=np.float32),
            "Cm": rng.standard_normal((B, S, N), dtype=np.float32),
            "h0": rng.standard_normal((B, H, P, N), dtype=np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 12), dtype=np.float32)
    w = 0.5 * rng.standard_normal((4, 12), dtype=np.float32)
    st = rng.standard_normal((2, 3, 12), dtype=np.float32) if with_state else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, wstate = jssm._causal_conv(jnp.asarray(x, jd), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st, jd))
    got, gstate = ssm.causal_conv(torch.from_numpy(x).to(td), torch.from_numpy(w),
                                  None if st is None else torch.from_numpy(st).to(td))
    assert got.dtype == td and gstate.dtype == td
    _close(got, want, dtype)
    np.testing.assert_array_equal(gstate.float().numpy(), np.asarray(wstate, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(dtype, with_h0):
    a = _ssd_inputs()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, want_h = jssm.ssd_chunked(
        jnp.asarray(a["xh"], jd), jnp.asarray(a["dt"]), jnp.asarray(a["A"]),
        jnp.asarray(a["Bm"], jd), jnp.asarray(a["Cm"], jd), 32,
        h0=jnp.asarray(a["h0"]) if with_h0 else None)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got_y, got_h = ssm.ssd_chunked(t["xh"].to(td), t["dt"], t["A"], t["Bm"].to(td),
                                   t["Cm"].to(td), 32, h0=t["h0"] if with_h0 else None)
    assert got_y.dtype == td and got_h.dtype == torch.float32
    _close(got_y, want_y, dtype)
    _close(got_h, want_h, "float32" if dtype == "float32" else dtype)


def test_ssd_chunked_refuses_a_ragged_sequence():
    """S > chunk and S % chunk != 0: the reference asserts; the port raises
    and pads nothing."""
    t = {k: torch.from_numpy(v) for k, v in _ssd_inputs(S=40).items()}
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(t["xh"], t["dt"], t["A"], t["Bm"], t["Cm"], 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_prefill_and_decode_match_reference(dtype):
    check_model(Case(ARCH, dtype, n_fwd=64, n_pre=64, n_dec=3, cache_len=72))


def test_convert_round_trips_the_reference_tree():
    check_round_trip(ARCH)


def test_training_runs_on_the_cpu():
    check_training_runs(ARCH)


def _sequential_ssd(xh, dt, A, Bm, Cm):
    """h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t, y_t = C_t . h_t, one step
    at a time from h = 0: (B, S, H, P)."""
    B, S, H, P = xh.shape
    h = torch.zeros(B, H, P, Bm.shape[-1], dtype=xh.dtype)
    ys = []
    for t in range(S):
        decay = torch.exp(A * dt[:, t])[..., None, None]
        h = decay * h + (dt[:, t, :, None] * xh[:, t])[..., None] * Bm[:, t, None, None, :]
        ys.append((h * Cm[:, t, None, None, :]).sum(-1))
    return torch.stack(ys, 1)


def test_ssd_gradient_is_finite_at_a_chunk_of_256():
    """B 1, S 512 (two chunks of 256), H 2, P 4, N 8, dt = softplus(N(0, 1))
    (mamba2-130m's scale: its dt_bias starts at 0), A = -1: above the
    diagonal a chunk's cumulative log-decay differences pass 88, where
    fp32's exp overflows.  The port's gradients of a weighted sum of y are
    finite and within 1e-5 (relative L2) of a float64 sequential
    recurrence's, for xh, dt, Bm and Cm; the reference's `jax.grad` with
    respect to dt is NaN there (ROADMAP.md §3, item 3)."""
    rng = np.random.default_rng(0)
    B, S, H, P, N, chunk = 1, 512, 2, 4, 8, 256
    a = {"xh": rng.standard_normal((B, S, H, P), dtype=np.float32),
         "dt": np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32))),
         "Bm": rng.standard_normal((B, S, N), dtype=np.float32),
         "Cm": rng.standard_normal((B, S, N), dtype=np.float32)}
    A = -np.ones(H, np.float32)
    w = rng.standard_normal((B, S, H, P), dtype=np.float32)
    cums = np.cumsum(a["dt"].reshape(B, 2, chunk, H) * A, axis=2)
    assert (cums[:, :, 0] - cums[:, :, -1]).max() > 88        # exp overflows above the diagonal
    got = {k: torch.tensor(v, requires_grad=True) for k, v in a.items()}
    y, _ = ssm.ssd_chunked(got["xh"], got["dt"], torch.from_numpy(A), got["Bm"], got["Cm"],
                           chunk)
    (y * torch.from_numpy(w)).sum().backward()
    want = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in a.items()}
    y64 = _sequential_ssd(want["xh"], want["dt"], torch.from_numpy(A).double(), want["Bm"],
                          want["Cm"])
    (y64 * torch.from_numpy(w).double()).sum().backward()
    for k in a:
        g, r = got[k].grad, want[k].grad
        assert torch.isfinite(g).all(), k
        assert float((g.double() - r).norm() / r.norm()) <= 1e-5, k
    jgrad = jax.grad(lambda dt: (jssm.ssd_chunked(
        jnp.asarray(a["xh"]), dt, jnp.asarray(A), jnp.asarray(a["Bm"]), jnp.asarray(a["Cm"]),
        chunk)[0] * w).sum())(jnp.asarray(a["dt"]))
    assert np.isnan(np.asarray(jgrad)).any()
