"""PyTorch/CUDA port of the tetrahedral space-filling curve and its forest
AMR (New -> Adapt -> Partition -> Balance -> Ghost -> Iterate), and of the
LM family's serving path, beside the JAX package `repro`.

Subpackages mirror the JAX package: `core` (tables, element types and ops,
batched ops, comm and its fault-tolerant runtime, the Partition rule for the
forest and for LM workloads, the forest), `checkpoint` (the gathered
checkpoint store and forest checkpoints), `kernels` (the CUDA kernels, their
build, wrappers and plain versions), `configs`, `models` and `launch` (the
dense LM, its serving steps and the multi-process launcher), and `examples`
(twins of the JAX package's examples, `python -m
repro_torch.examples.<name>`).  `convert` carries forest and LM state
between the two packages.  Nothing here imports JAX or `repro`.
"""
