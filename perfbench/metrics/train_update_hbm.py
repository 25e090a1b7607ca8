"""The dense update's share of the card's HBM peak: the program's
``trainer.update_bytes`` counter's increase over the traced steps (each
leaf's w and g read and w written, each updater state tensor read and
written once) over the device time under ``Transformer::update``."""

from perfbench.spans import phase_seconds


def read(ctx):
    spent = phase_seconds(ctx, "train", "Transformer::update")
    if spent is None or not ctx.peaks or not ctx.update_bytes:
        return None
    return 100.0 * ctx.update_bytes / spent / ctx.peaks["hbm_bytes_per_s"]
