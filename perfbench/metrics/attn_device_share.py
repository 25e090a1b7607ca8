"""The device time of every kernel launched under the port's attention
ops, as a share of the device's busy time in the traced window."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    spent = ctx.trace.attention_s
    if spent <= 0:
        return None
    return 100.0 * spent / ctx.trace.busy_s
