"""Deterministic, seekable data pipeline (counterpart of the JAX package's
`repro.data.pipeline`).

The batch for (seed, step, dp_rank) is a pure function: restarting from a
checkpoint at step k reproduces the exact token stream with no loader
state to save, and on a change of the data-parallel size each rank
re-derives its slice of the same global batch.

The JAX package draws with `jax.random` (threefry-2x32 in counter mode,
partitionable: the counter of element i of a shape is i split into high
and low 32-bit words, and the 32 random bits are the two output words
xor-ed).  The port cannot import JAX, so it implements the same generator
in numpy, bit for bit: `prng_key(seed)`, `fold_in`, `random_bits` and
`uniform` are the JAX functions of those names for threefry keys, and
`normal_bf16` is `jax.random.normal` in bfloat16.  The tokens follow from
`uniform` through the same float32 zipf-like map, drawn on the host and
copied to the batch's device, so the card and the CPU see the same tokens.
The encdec family's frames and the vlm family's patches (the JAX package
draws them from the tokens' own key) are drawn on the batch's device: the
same hash on int64 tensors, and a lookup in a table of the 128 values a
bf16 normal can take, exact on either device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..core.types import resolve_device
from ..models.config import ModelConfig, ShapeConfig

__all__ = ["prng_key", "fold_in", "threefry2x32", "random_bits", "uniform", "normal_bf16",
           "synthetic_batch", "DataPipeline"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_WORD = 0xFFFFFFFF
CPU_CHUNK = 1 << 18


def threefry2x32(key: np.ndarray, x0, x1):
    """The threefry-2x32 hash (20 rounds) of the counter words x0, x1 under
    `key` (2,) uint32: x0, x1 uint32 numpy arrays of one shape, or int64
    tensors of one shape holding 32-bit words (every sum and shift is cut
    to 32 bits, so either wraps alike); two arrays of their type."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [(x0 + ks[0]) & _WORD, (x1 + ks[1]) & _WORD]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _WORD
            x[1] = (((x[1] << r) & _WORD) | (x[1] >> (32 - r))) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _WORD
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _WORD
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: (0, seed) as uint32."""
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in`: the hash of the counter (0, data) under `key`."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], dtype=np.uint32)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32 random bits an element, the partitionable way: element i's counter
    is (i >> 32, i & 0xFFFFFFFF) and its bits the xor of the hash words."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(_WORD)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).astype(np.uint32).reshape(shape)


def _exact(x: np.float32) -> tuple[int, int]:
    """(n, e) with x = n 2^e, n an integer of at most 24 bits."""
    m, e = np.frexp(np.float64(x))
    return int(m * (1 << 24)), int(e) - 24


def uniform(key: np.ndarray, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform` in float32: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1 (f = m 2^-23 exactly), then f (maxval - minval)
    + minval rounded once, as XLA's fused multiply-add does on the CPU (two
    float32 roundings differ from it in about a third of the values), no
    lower than minval.  The fused result is computed exactly in integers
    and rounded to float32 once."""
    lo, hi = np.float32(minval), np.float32(maxval)
    s_int, s_exp = _exact(hi - lo)
    l_int, l_exp = _exact(lo)
    p_exp = s_exp - 23                       # f (hi - lo) = m s_int 2^p_exp
    e = min(p_exp, l_exp)
    if 47 + p_exp - e > 52 or 24 + l_exp - e > 52:
        raise ValueError(f"uniform over [{minval}, {maxval}): scales too far apart")
    m = (random_bits(key, shape) >> np.uint32(9)).astype(np.int64)
    total = (m * s_int << (p_exp - e)) + (l_int << (l_exp - e))     # below 2^53
    out = np.ldexp(total.astype(np.float64), e).astype(np.float32)
    return np.maximum(lo, out)


@functools.lru_cache(maxsize=None)
def _normal_table(scale: float) -> torch.Tensor:
    """The 128 values of `jax.random.normal(key, shape, bfloat16) * scale`,
    indexed by 7 random bits k: JAX's bf16 uniform over [nextafter(-1, 0),
    1) is (k + 1.0 - 1) (1 - nextafter(-1, 0)) + nextafter(-1, 0) in bf16,
    that is (4k - 255) / 256 exactly (the span rounds to 2.0); then erf_inv
    (in fp32, rounded to bf16), times sqrt(2) rounded to bf16 (1.4140625)
    and times `scale` rounded to bf16, each product rounded to bf16.
    Computed on the host (erfinv in fp64), a CPU bf16 tensor."""
    k = torch.arange(128, dtype=torch.float64)
    bf = torch.bfloat16
    r = torch.special.erfinv((4 * k - 255) / 256).float().to(bf)
    return r * torch.tensor(1.4140625, dtype=bf) * torch.tensor(scale, dtype=bf)


def normal_bf16(key: np.ndarray, shape: tuple, scale: float = 1.0, device=None) -> torch.Tensor:
    """`jax.random.normal(key, shape, jnp.bfloat16) * scale` bit for bit, on
    `device` (the card unless given): each element's 32 random bits as
    `random_bits` makes them (the hash run on the device, on int64), of
    which JAX's 8-bit draw keeps the low byte and its bf16 uniform the top
    7 bits of that, looked up in `_normal_table`.  On the CPU the hash
    runs CPU_CHUNK elements at a time, which stay in cache (about 10 times
    faster than one pass over 12 M elements)."""
    dev = resolve_device(device)
    n = math.prod(shape)
    table = _normal_table(scale).to(dev)
    out = torch.empty(n, dtype=torch.bfloat16, device=dev)
    step = CPU_CHUNK if dev.type == "cpu" else max(n, 1)
    for c0 in range(0, n, step):
        i = torch.arange(c0, min(n, c0 + step), dtype=torch.int64, device=dev)
        b0, b1 = threefry2x32(key, i >> 32, i & _WORD)
        out[c0:c0 + step] = table[((b0 ^ b1) & 0xFF) >> 1]
    return out.reshape(shape)


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, *, seed: int, step: int,
                    dp_rank: int = 0, dp_size: int = 1, seq_len: int | None = None,
                    device=None) -> dict:
    """The dp_rank-th slice of the global batch for `step`, a pure function,
    on `device` (the card unless given), the JAX package's batch:
    {"tokens": (B, S) int32} with B = global_batch / dp_size and a
    zipf-like marginal over the vocabulary; for the encdec family also
    "frames" (B, encoder_seq, d_model) bf16, for the vlm family "patches"
    (B, P, d_model) bf16 with P = min(num_patches, S / 2) and the tokens
    cut to their first S - P, each 0.1 times a bf16 normal drawn from the
    tokens' own key (`normal_bf16`), as the JAX package draws them."""
    S = seq_len or shape.seq_len
    B = shape.global_batch // dp_size
    dev = resolve_device(device)
    key = fold_in(fold_in(prng_key(seed), step), dp_rank)
    u = uniform(key, (B, S), minval=1e-6, maxval=1.0)
    z = np.exp(-np.log(u) * np.float32(0.35)) - np.float32(1.0)
    toks = np.minimum(z.astype(np.int32), np.int32(cfg.vocab_size - 1))
    P = min(cfg.num_patches, S // 2) if cfg.family == "vlm" else 0
    batch = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :S - P])).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = normal_bf16(key, (B, cfg.encoder_seq, cfg.d_model), 0.1, dev)
    if P:
        batch["patches"] = normal_bf16(key, (B, P, cfg.d_model), 0.1, dev)
    return batch


@dataclasses.dataclass
class DataPipeline:
    """The stream of `synthetic_batch`es for one data-parallel rank, on
    `device` (the card unless given)."""
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1
    seq_len: int | None = None
    device: str | torch.device | None = None

    def batch(self, step: int) -> dict:
        return synthetic_batch(self.cfg, self.shape, seed=self.seed, step=step,
                               dp_rank=self.dp_rank, dp_size=self.dp_size,
                               seq_len=self.seq_len, device=self.device)

    def reshard(self, dp_rank: int, dp_size: int) -> "DataPipeline":
        """Elastic re-scale: the same stream, a new slice geometry."""
        if self.shape.global_batch % dp_size:
            raise ValueError(f"global batch {self.shape.global_batch} does not split into "
                             f"{dp_size} ranks")
        return dataclasses.replace(self, dp_rank=dp_rank, dp_size=dp_size)
