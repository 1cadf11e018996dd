"""Int8 gradient compression with per-block scales (counterpart of the JAX
package's `repro.optim.compression`).  The quantized cross-pod mean,
`compressed_psum`, is a collective over a mesh axis and waits for the
port's DeviceMesh."""

from __future__ import annotations

import torch
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


def compressed_psum(*_args, **_kwargs):
    """The JAX package's quantized mean over a mesh axis with error
    feedback: not ported yet (it needs the DeviceMesh of the launch
    tooling)."""
    raise NotImplementedError("compressed_psum is a collective over a mesh axis, not ported "
                              "yet (ROADMAP.md §1, item 6: the launch tooling's DeviceMesh)")
