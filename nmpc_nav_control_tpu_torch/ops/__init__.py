"""Operators of the port: the batched linearization, the eight kernels (the
fused IPM sweeps and the Riccati kernels, each a ``torch.library`` op
beside its plain version) and the plain Riccati recursion and small linear
algebra they are held against."""
