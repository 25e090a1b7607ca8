"""Kernels launched a step in the traced window (host dispatch: every
kernel the step's host code enqueued, copies and fills left out)."""


def read(ctx):
    if ctx.kind != "w2v" or ctx.trace is None or not ctx.steps:
        return None
    return ctx.trace.n_kernels / ctx.steps
