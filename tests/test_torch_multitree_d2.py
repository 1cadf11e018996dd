"""The d = 2 fixtures of `test_torch_multitree.py`: the port's forest over
the 2-tree unit square, a periodic 2 x 2 brick (whose wrap translations
reach 2^31 in the tree transform) and the rotated pair (sigma = -1),
against the JAX package on the CPU — Balance, Ghost and validate, every
forest and ghost field, payload and byte equal.  Kept in a file of their
own so each file's JAX programs compile for one dimension."""

import pytest

from test_torch_multitree import FIXTURES, check_disconnected, check_pipeline, check_sweep_layer

D2 = [k for k, v in FIXTURES.items() if v[1] == 2]


@pytest.mark.parametrize("name", D2)
def test_balance_ghost_validate_match_reference_d2(name):
    check_pipeline(name)


@pytest.mark.parametrize("name", ["periodic_brick_d2", "rotated_pair"])
def test_face_sweep_layer_matches_reference_d2(name):
    check_sweep_layer(name)


def test_disconnected_cmesh_equals_no_cmesh_d2():
    check_disconnected(2)
