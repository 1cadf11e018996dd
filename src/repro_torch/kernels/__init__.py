"""Hand-written CUDA kernels for Hopper (`csrc/`), their nvcc build
(`build`), device-dispatching wrappers (`ops`) and plain PyTorch versions
(`ref`)."""
