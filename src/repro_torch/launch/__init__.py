"""Entry points: the LM family's serving steps (`serve`), and the launcher
of rank processes for `DistComm` runs (`multiproc`)."""
