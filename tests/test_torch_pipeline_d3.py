"""The port's New -> Adapt -> Partition -> weighted repartition at d = 3
against the JAX package, element for element and byte for byte, on
SimComm(P) for P in {1, 3, 4} (see `check_pipeline_against_reference` in
`test_torch_forest.py`)."""

import pytest

from test_torch_forest import check_pipeline_against_reference


@pytest.mark.parametrize("P", [1, 3, 4])
def test_new_adapt_partition_matches_reference(P):
    check_pipeline_against_reference(3, P)
