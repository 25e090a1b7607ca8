"""The whole training step's share of the card's bf16 peak: the model's
FLOPs of the traced steps (6 · matmul parameters + 6 · L · d · T a
token, ``common.train_flops_per_token``) over the traced window."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.peaks \
            or not ctx.flops_per_step:
        return None
    rate = ctx.flops_per_step * ctx.steps / ctx.trace.window_s
    return 100.0 * rate / ctx.peaks["bf16_flops"]
