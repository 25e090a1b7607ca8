"""The attention kernels' share of their roofline: the sum over the
traced steps' launches of max(flops / bf16 peak, bytes / HBM peak), from
``common.flash_work`` at each call's shape (forward, dq and dk/dv), over
the device time of every kernel launched under the port's attention ops
(the prepared operands, Δ and the three kernels)."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.peaks \
            or not ctx.attention_work:
        return None
    spent = ctx.trace.attention_s
    if spent <= 0:
        return None
    p = ctx.peaks
    least = sum(per_step * ctx.steps * max(flops / p["bf16_flops"],
                                           nbytes / p["hbm_bytes_per_s"])
                for _, per_step, flops, nbytes in ctx.attention_work)
    return 100.0 * least / spent
