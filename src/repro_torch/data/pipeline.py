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
`uniform` are the JAX functions of those names for threefry keys.  The
tokens follow from `uniform` through the same float32 zipf-like map, drawn
on the host and copied to the batch's device, so the card and the CPU see
the same tokens.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import resolve_device
from ..models.config import ModelConfig, ShapeConfig

__all__ = ["prng_key", "fold_in", "threefry2x32", "random_bits", "uniform", "synthetic_batch",
           "DataPipeline"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry-2x32 hash (20 rounds) of the counter words x0, x1
    (uint32 arrays of one shape) under `key` (2,) uint32: two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
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
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


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


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, *, seed: int, step: int,
                    dp_rank: int = 0, dp_size: int = 1, seq_len: int | None = None,
                    device=None) -> dict:
    """The dp_rank-th slice of the global batch for `step`, a pure function:
    {"tokens": (global_batch / dp_size, S) int32} on `device` (the card
    unless given), with a zipf-like marginal over the vocabulary, the JAX
    package's tokens."""
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family's frames and patches "
                                  "are not ported yet (ROADMAP.md §1, slice 7c)")
    S = seq_len or shape.seq_len
    B = shape.global_batch // dp_size
    key = fold_in(fold_in(prng_key(seed), step), dp_rank)
    u = uniform(key, (B, S), minval=1e-6, maxval=1.0)
    z = np.exp(-np.log(u) * np.float32(0.35)) - np.float32(1.0)
    toks = np.minimum(z.astype(np.int32), np.int32(cfg.vocab_size - 1))
    return {"tokens": torch.from_numpy(toks).to(resolve_device(device))}


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
