"""The share of the traced window in which no kernel, copy or fill ran
on the card: one minus the union of their intervals over the window."""


def read(ctx):
    if ctx.kind != "w2v" or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
