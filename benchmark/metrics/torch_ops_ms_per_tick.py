"""Device ms a tick of every op the program launches that is not one of the
port's kernels: the plain torch ops of the graphed tick (layer: graphed tick)."""


def read(ctx, suffix):
    ops = [op for op in ctx.program_ops() if ctx.kernel_of(op) is None]
    if not ops or not ctx.ticks:
        return None
    return 1e3 * sum(op.end - op.start for op in ops) / ctx.ticks
