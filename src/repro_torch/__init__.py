"""PyTorch/CUDA port of the tetrahedral space-filling curve and its forest
AMR (New -> Adapt -> Partition), beside the JAX package `repro`.

Subpackages mirror the JAX package: `core` (tables, element types and ops,
batched ops, comm, placement, forest), `checkpoint` (the gathered checkpoint
store and forest checkpoints) and `kernels` (the CUDA kernels, their build,
wrappers and plain versions).  `convert` carries forest state between the
two packages.  Nothing here imports JAX or `repro`.
"""
