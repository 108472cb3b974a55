"""Operators of the port: batched linearization and the fused IPM sweeps."""
