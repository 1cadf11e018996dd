"""Core of the port: SFC tables, element types and ops, the batched-ops seam,
the in-process comm layer, the partition rule, and the forest."""
