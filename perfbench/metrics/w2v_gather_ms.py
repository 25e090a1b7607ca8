"""Device ms a step of every kernel, copy and fill launched inside the
fused word2vec step's ``SkipGram::gather`` spans: both tables' row
gathers and the ids' concatenation (``perfbench/spans.py``)."""

from perfbench.spans import phase_seconds


def read(ctx):
    spent = phase_seconds(ctx, "w2v", "SkipGram::gather")
    return None if spent is None else 1e3 * spent / ctx.steps
