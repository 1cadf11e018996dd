"""The d = 2 cases of `test_torch_hex_forest.py`: the port's pure-hex
forest over a brick of two quad trees and over a periodic 2 x 2 brick,
against the JAX package on the CPU — New -> Adapt -> Partition -> weighted
repartition -> Balance -> Ghost -> validate, every forest and ghost field,
counter and payload digest equal, and the forests carried between the
packages by `convert`.  Kept in a file of their own so each file's JAX
programs compile for one dimension."""

import pytest

from test_torch_hex_forest import check_crossing, check_pipeline


@pytest.mark.parametrize("name", ["brick_d2", "periodic_d2"])
def test_hex_pipeline_matches_reference_d2(name):
    check_pipeline(name)


def test_hex_forests_cross_between_the_packages_d2():
    check_crossing("periodic_d2")
