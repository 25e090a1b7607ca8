"""1-bit gradient quantization with error feedback.

Reference: the DMTK lineage's ``util/quantization.h`` 1-bit SGD
experiment (SURVEY.md §5 "no compression (a util/quantization.h 1-bit
experiment may exist)") — the technique from Seide et al. 2014: transmit
only the SIGN of each delta element plus two per-message scales (the
mean magnitude of the positive and negative buckets), and carry the
quantization error forward into the next delta ("error feedback"), which
keeps SGD convergent despite the 32x lossy wire format.

TPU-native placement: the COMPUTE path never needs this (deltas move as
XLA collectives over ICI), but the eager host parity path and the
multi-host eager-add allgather move float32 over wire/DCN — exactly the
reference's bottleneck.  ``Table.add(..., compress="1bit")`` rides these
helpers: 1/32 the bytes per add at the cost of quantization noise that
error feedback re-injects on the next add.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["quantize_1bit", "dequantize_1bit", "OneBitCompressor"]


def quantize_1bit(delta: np.ndarray,
                  residual: Optional[np.ndarray] = None,
                  ) -> Tuple[np.ndarray, float, float, np.ndarray]:
    """Quantize ``delta`` (+ carried ``residual``) to sign bits + scales.

    Returns ``(packed uint8 [ceil(n/8)], pos_scale, neg_scale,
    new_residual)``.  Reconstruction maps set bits to ``pos_scale`` (the
    mean of non-negative elements) and clear bits to ``neg_scale`` (the
    mean of negative ones); ``new_residual`` is what reconstruction lost
    and MUST ride into the next call — without it 1-bit SGD diverges.
    """
    d = np.asarray(delta, np.float32).ravel()
    if residual is not None:
        d = d + residual.ravel()
    # Sanitize non-finite inputs (matches the native codec,
    # native/src/codec.cc): a NaN/Inf element is treated as 0 for this
    # message AND gets a zeroed residual — otherwise one bad element
    # poisons both scales (NaN mean) or rides the feedback loop forever.
    finite = np.isfinite(d)
    if not finite.all():
        d = np.where(finite, d, np.float32(0.0))
    pos = d >= 0
    pos_scale = float(d[pos].mean()) if pos.any() else 0.0
    neg_scale = float(d[~pos].mean()) if (~pos).any() else 0.0
    packed = np.packbits(pos)
    recon = np.where(pos, np.float32(pos_scale), np.float32(neg_scale))
    new_residual = (d - recon).astype(np.float32)
    if not finite.all():
        new_residual[~finite] = 0.0
    return packed, pos_scale, neg_scale, new_residual


def dequantize_1bit(packed: np.ndarray, pos_scale: float, neg_scale: float,
                    n: int) -> np.ndarray:
    """Inverse of :func:`quantize_1bit` (flat [n] float32)."""
    bits = np.unpackbits(np.asarray(packed, np.uint8), count=n).astype(bool)
    return np.where(bits, np.float32(pos_scale),
                    np.float32(neg_scale)).astype(np.float32)


class OneBitCompressor:
    """Per-stream stateful wrapper: owns the error-feedback residual.

    One instance per (table, direction) — the residual is part of the
    sender's training state (the reference keeps it worker-side), so it
    is NOT shared between tables or ranks.
    """

    def __init__(self) -> None:
        self._residual: Optional[np.ndarray] = None

    def compress(self, delta: np.ndarray
                 ) -> Tuple[np.ndarray, float, float]:
        packed, p, m, self._residual = quantize_1bit(delta, self._residual)
        return packed, p, m

    def decompress(self, packed: np.ndarray, pos_scale: float,
                   neg_scale: float, shape) -> np.ndarray:
        n = int(np.prod(shape))
        return dequantize_1bit(packed, pos_scale, neg_scale, n).reshape(shape)

    def reset(self) -> None:
        """Drop the carried residual (e.g. after a checkpoint restore —
        the error belongs to the abandoned timeline)."""
        self._residual = None
