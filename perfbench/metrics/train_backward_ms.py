"""Device ms a step of every kernel, copy and fill launched inside the
trainer's ``Transformer::backward`` spans, from any thread (autograd's
device thread launches them; ``perfbench/spans.py``)."""

from perfbench.spans import phase_seconds


def read(ctx):
    spent = phase_seconds(ctx, "train", "Transformer::backward")
    return None if spent is None else 1e3 * spent / ctx.steps
