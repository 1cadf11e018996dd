"""Int8 gradient compression with per-block scales and error feedback
(counterpart of the JAX package's `repro.optim.compression`).

At multi-pod scale the data-parallel reduction over the slow pod axis
dominates: quantizing its payload to int8 (per-block scales) cuts those
bytes 4x against bf16.  `compressed_psum` is that mean over a process
group (a mesh dimension's, e.g. 'pod'), and returns the quantization
residual to feed back into the next step."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["BLOCK", "compress_int8", "decompress_int8", "compressed_psum"]

BLOCK = 256


def compress_int8(x: torch.Tensor, block: int = BLOCK):
    """x (any float dtype) -> (int8 payload (n_blocks, block), fp32 per-block
    scales (n_blocks, 1), pad): each block scaled by its max |value| / 127
    and rounded half to even, as the JAX package does."""
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % block
    blocks = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)), -127, 127)
    return q.to(torch.int8), scale, pad


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, pad: int, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    out = (q.float() * scale).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(dtype)


def _group(axis):
    """The process group of `axis`: a ProcessGroup, or a (DeviceMesh, mesh
    dimension name) pair."""
    if isinstance(axis, tuple):
        mesh, name = axis
        return mesh.get_group(name)
    return axis


def compressed_psum(x: torch.Tensor, axis, *, residual: torch.Tensor | None = None,
                    block: int = BLOCK):
    """Quantized mean of `x` over the ranks of `axis` (a ProcessGroup, or a
    (DeviceMesh, dimension name) pair), with error feedback, as the JAX
    package computes it under `jax.lax` collectives: (1) an all-reduce MAX
    of each block's max |value| fixes a shared scale per block (/ 127, at
    least 1e-12); (2) the int8 payload is summed as int32 (127 times the
    group size stays far below 2^31) by an all-reduce SUM, scaled back and
    divided by the group size.  `residual` (the last step's) is added to x
    first.  Returns (the mean in x's dtype, the new residual x - deq(q))."""
    group = _group(axis)
    if residual is not None:
        x = x + residual.to(x.dtype)
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = F.pad(flat, (0, pad)).reshape(-1, block)
    amax = flat.abs().amax(dim=1, keepdim=True)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    new_residual = (flat - q.float() * scale).reshape(-1)
    if pad:
        new_residual = new_residual[:-pad]
    new_residual = new_residual.reshape(x.shape).to(x.dtype)
    n = float(dist.get_world_size(group))
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    out = (summed.float() * scale).reshape(-1)
    if pad:
        out = out[:-pad]
    return (out.reshape(x.shape) / n).to(x.dtype), new_residual
