"""The port's decode wrapper on the CPU against the JAX package's Pallas
kernel in interpret mode, exactly, at n in {7, 250} and d in {2, 3}, as
`tests/kernels/test_sfc_kernels.py` runs it.  A file of its own because
interpret-mode compiles of this kernel are slow."""

import pytest

from test_torch_kernels import check_against_pallas


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [7, 250])
def test_plain_kernel_matches_pallas_kernel(d, n):
    check_against_pallas("decode", d, n)
