"""The word2vec step's share of the card's HBM peak: the least bytes a
step must move (each table's distinct rows of the batch read and written
once, and the ids; ``common.w2v_least_bytes``, counted from the batches
themselves) over the traced window."""


def read(ctx):
    if ctx.kind != "w2v" or ctx.trace is None or not ctx.peaks \
            or not ctx.least_bytes_per_step:
        return None
    rate = ctx.least_bytes_per_step * ctx.steps / ctx.trace.window_s
    return 100.0 * rate / ctx.peaks["hbm_bytes_per_s"]
