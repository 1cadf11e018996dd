"""`new_uniform(method="successor")` of the port — the coarsest subtrees
inside each rank's range decoded and expanded child by child, the ragged
head and tail decoded — against the JAX package's `"successor"` and
`"decode"` methods, exactly, on every rank."""

import numpy as np
import pytest
import torch

from repro.core import forest as JF
from repro_torch.core import forest as TF


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("P", [1, 7])
def test_new_uniform_successor_matches_reference(d, P):
    """`new_uniform(method="successor")` (subtrees expanded child by child)
    equals the JAX package's `"successor"` and `"decode"` methods on every
    rank, with ranks cutting trees at unaligned ids."""
    level = 2
    for p in range(P):
        got = TF.new_uniform_rank(d, 3, level, p, P, method="successor", device="cpu")
        want = JF.new_uniform_rank(d, 3, level, p, P, method="successor")
        dec = JF.new_uniform_rank(d, 3, level, p, P, method="decode")
        for name in ("anchor", "level", "stype", "tree"):
            g = getattr(got, name).numpy()
            np.testing.assert_array_equal(g, np.asarray(getattr(want, name)), err_msg=name)
            np.testing.assert_array_equal(g, np.asarray(getattr(dec, name)), err_msg=name)
        assert got.num_local == want.num_local > 0


def test_new_uniform_successor_levels_zero_and_one():
    """More ranks than elements (empty ranks), and a range of one element."""
    for d, level, P in ((3, 0, 4), (2, 1, 7), (3, 1, 9)):
        for p in range(P):
            got = TF.new_uniform_rank(d, 2, level, p, P, method="successor", device="cpu")
            want = TF.new_uniform_rank(d, 2, level, p, P, method="decode", device="cpu")
            for name in ("anchor", "level", "stype", "tree"):
                assert torch.equal(getattr(got, name), getattr(want, name))
    with pytest.raises(ValueError):
        TF.new_uniform_rank(3, 1, 1, 0, 1, method="bogus", device="cpu")
