"""Cross-cutting utilities (reference ``include/multiverso/util/``).

The port has the 1-bit quantizer (``quantization.py``, a copy of the
JAX package's) that the tables' ``compress="1bit"`` add rides.  The
other utilities (``AsyncBuffer``, ``Timer``, the net helpers and
``prefetch_to_device``) come with later slices (ROADMAP.md Queue 1).
"""

from .quantization import OneBitCompressor, dequantize_1bit, quantize_1bit

__all__ = ["OneBitCompressor", "dequantize_1bit", "quantize_1bit"]
