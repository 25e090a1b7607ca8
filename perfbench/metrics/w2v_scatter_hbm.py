"""The row scatters' share of the card's HBM peak: the least bytes they
move (each table's distinct rows of the batch, 300 float32 wide, read
and written once; counted by the benchmark from the batches,
``spans.scatter_bytes``) over the device time under
``SkipGram::scatter``."""

from perfbench.spans import phase_seconds


def read(ctx):
    spent = phase_seconds(ctx, "w2v", "SkipGram::scatter")
    if spent is None or not ctx.peaks or not ctx.scatter_bytes_per_step:
        return None
    rate = ctx.scatter_bytes_per_step * ctx.steps / spent
    return 100.0 * rate / ctx.peaks["hbm_bytes_per_s"]
