"""Cross-cutting utilities (reference ``include/multiverso/util/``).

The port has the 1-bit quantizer (``quantization.py``) and
``AsyncBuffer`` (``async_buffer.py``), both copies of the JAX package's,
``prefetch_to_device`` (pinned memory and a side CUDA stream) and the
tree walker ``tree_map`` the checkpoints use.  ``Timer`` and the net
helpers come with later slices (ROADMAP.md Queue 1).
"""

from .async_buffer import AsyncBuffer
from .prefetch import prefetch_to_device
from .quantization import OneBitCompressor, dequantize_1bit, quantize_1bit
from .tree import tree_map, tree_map_with_path

__all__ = ["AsyncBuffer", "OneBitCompressor", "dequantize_1bit",
           "prefetch_to_device", "quantize_1bit", "tree_map",
           "tree_map_with_path"]
