"""Hand-written CUDA kernels for Hopper (`csrc/`), their nvcc build
(`build`), device-dispatching wrappers (`ops`) and plain PyTorch versions
(`ref`)."""

# `ops` first, whichever of these modules is asked for: it imports `core`,
# whose `batch` imports `ops` back, and then `ref` and `build`, which need
# `core` whole.  Reaching `core` from `build` first would hand `core.batch`
# a `build` without `library`.
from . import ops, ref, build

__all__ = ["build", "ops", "ref"]
