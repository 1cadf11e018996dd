"""The d = 3 cases of `test_torch_hybrid.py`: the port's forest over the
hybrid pair of a hexahedron beside a Kuhn cube of six tetrahedra, against
the JAX package on the CPU — every forest and ghost field, counter and
payload digest equal — and the per-class functions' face sweeps and routing
evals, the sum of the class groups' own.  Kept in a file of its own so
each file's JAX programs compile for one dimension."""

from test_torch_hybrid import check_dispatch_is_per_class_sum, check_pipeline


def test_hybrid_pipeline_matches_reference_d3():
    check_pipeline(3)


def test_mixed_class_dispatch_is_per_class_sum_d3():
    check_dispatch_is_per_class_sum(3)
