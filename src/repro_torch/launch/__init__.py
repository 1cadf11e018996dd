"""Entry points: the LM family's serving steps (`serve`) and train step
(`train`), the launcher of rank processes for `DistComm` runs and gloo or
NCCL fleets (`multiproc`), and the launch tooling on a torch DeviceMesh:
the production meshes (`mesh`), the sharding rules as DTensor placements
(`sharding`), the per-device cost of a traced step (`op_cost`), the H100
roofline (`roofline`), the dry run of every cell on fake 256- and
512-rank meshes (`dryrun`) and its tables (`report`)."""
