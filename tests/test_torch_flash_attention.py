"""The port's attention kernel wrapper against the JAX package, on the CPU.

On CPU tensors `repro_torch.kernels.ops.flash_attention` runs its plain
version (`kernels.ref.flash_attention`); it is held against the JAX
package's Pallas `flash_attention` in interpret mode and against its
`_plain_attention` oracle at the JAX package's own tolerances: 2e-5 in
fp32 (the same function, the sums in another order) and 2e-2 in bf16 (the
output rounded to bf16, whose spacing is 2^-7 relative).  The Pallas kernel
asserts S % 128 == 0, so S = 1, 129 and 200 go against `_plain_attention`
only.  Every case is causal but two against the Pallas kernel, with and
without a window (the kernel's `causal=False` branch); hd 256 at S 128,
causal and windowed.  Inputs come from
numpy with a fixed seed; each JAX result is computed once.  The kernel itself is held against the same plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase 2a).
"""

import ctypes
import functools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as jly
from repro_torch.kernels import build, ops as kops, ref as kref
from repro_torch.models import layers as ly

# (B, S, H, KV, hd, dtype, window, causal)
PALLAS_CASES = [
    (1, 256, 2, 1, 32, "float32", None, True),
    (2, 256, 4, 2, 64, "float32", None, True),
    (1, 256, 4, 2, 32, "float32", 100, True),
    (1, 256, 4, 4, 32, "bfloat16", None, True),
    (1, 256, 4, 2, 32, "float32", None, False),
    (1, 256, 4, 2, 64, "float32", 100, False),
    # hd 256 (recurrentgemma's local attention, MQA), causal and windowed
    (1, 128, 2, 1, 256, "float32", None, True),
    (1, 128, 2, 1, 256, "float32", 50, True),
    (1, 128, 2, 1, 256, "bfloat16", 50, True),
]
RAGGED_CASES = [
    (1, 1, 4, 2, 32, "float32", None),
    (2, 129, 4, 1, 32, "float32", None),
    (1, 200, 4, 2, 64, "float32", 17),
    (1, 129, 4, 2, 32, "bfloat16", None),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def _inputs(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed + S + H + hd)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32))


def _jax(arrs, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


@functools.lru_cache(maxsize=None)
def _jax_plain(B, S, H, KV, hd, dtype, window, causal=True):
    q, k, v = _jax(_inputs(B, S, H, KV, hd), dtype)
    out = jly._plain_attention(q, k, v, causal=causal, window=window, q_offset=0,
                               scale=1 / math.sqrt(hd))
    return np.asarray(out, np.float32)


def _close(got: torch.Tensor, want: np.ndarray, dtype: str):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_plain_version_matches_pallas_kernel_and_oracle(case):
    B, S, H, KV, hd, dtype, window, causal = case
    q, k, v = _jax(_inputs(B, S, H, KV, hd), dtype)
    want = np.asarray(pallas_flash(q, k, v, causal=causal, window=window, interpret=True),
                      np.float32)
    got = kops.flash_attention(*_torch(_inputs(B, S, H, KV, hd), dtype), causal=causal,
                               window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, hd)
    _close(got, want, dtype)
    _close(got, _jax_plain(*case), dtype)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_plain_version_matches_oracle_at_ragged_lengths(case):
    B, S, H, KV, hd, dtype, window = case
    got = kops.flash_attention(*_torch(_inputs(B, S, H, KV, hd), dtype), window=window)
    _close(got, _jax_plain(*case), dtype)


@pytest.mark.parametrize("window", [None, 100])
def test_attention_core_matches_blocked_causal_attention(window):
    """The port's attention_core (Sq == Sk: the kernel's function) against
    the JAX package's blocked jnp path, which the kernel replaces."""
    B, S, H, KV, hd = 2, 512, 4, 2, 32
    arrs = _inputs(B, S, H, KV, hd)
    want = jly._blocked_causal_attention(*_jax(arrs, "float32"), window=window,
                                         scale=1 / math.sqrt(hd), chunk=128)
    kref.reset_call_counts()
    got = ly.attention_core(*_torch(arrs, "float32"), causal=True, window=window)
    assert kref.call_counts["flash_attention"] == 1
    _close(got, np.asarray(want), "float32")


@pytest.mark.parametrize("window", [None, 20])
def test_attention_core_sends_non_causal_self_attention_to_the_kernel(window):
    """Non-causal attention with Sq == Sk from position 0 (an encoder's
    self-attention) takes the kernel's path, one `flash_attention` call,
    against the JAX package's `_plain_attention`; cross attention (Sq !=
    Sk) stays plain."""
    B, S, H, KV, hd = 2, 40, 4, 2, 64
    arrs = _inputs(B, S, H, KV, hd)
    want = _jax_plain(B, S, H, KV, hd, "float32", window, False)
    kref.reset_call_counts()
    got = ly.attention_core(*_torch(arrs, "float32"), causal=False, window=window)
    assert kref.call_counts["flash_attention"] == 1
    _close(got, want, "float32")
    q, k, v = _torch(arrs, "float32")
    ly.attention_core(q[:, :7], k, v, causal=False)
    assert kref.call_counts["flash_attention"] == 1


def test_wrapper_takes_the_plain_version_on_the_cpu():
    kops.reset_launch_counts()
    kref.reset_call_counts()
    q, k, v = _torch(_inputs(1, 8, 4, 2, 32), "float32")
    kops.flash_attention(q, k, v)
    kops.flash_attention(q, k, v, causal=False, window=3)
    assert kref.call_counts["flash_attention"] == 2
    assert not any(kops.launch_counts.values())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(_inputs(1, 8, 4, 2, 32), "float32")
    with pytest.raises(ValueError, match="head dim"):
        kops.flash_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                             v[..., :16].contiguous())
    with pytest.raises(TypeError):
        kops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        kops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        kops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        kops.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 32).contiguous(), v)  # 4 % 3
    with pytest.raises(ValueError):
        kops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):
        kops.flash_attention(q[0], k[0], v[0])


def test_c_entry_point_takes_the_wrappers_argument_count():
    """`fa_flash_attention` in `csrc/flash_attention.cu` has as many
    parameters as `kernels.ops` declares, pointers and the stream as
    c_void_p and the strides as c_int64."""
    src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    m = re.search(r'extern "C" int (fa_\w+)\((.*?)\)\s*\{', src, re.S)
    params = [p.strip() for p in m.group(2).split(",")]
    types = kops._ARGTYPES[m.group(1)]
    assert len(params) == len(types) == 19
    for p, t in zip(params, types):
        want = (ctypes.c_void_p if "void*" in p else
                ctypes.c_int64 if p.startswith("int64_t") else ctypes.c_int)
        assert t is want, (p, t)
