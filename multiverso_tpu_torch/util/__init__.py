"""Cross-cutting utilities (reference ``include/multiverso/util/``).

The port has the 1-bit quantizer (``quantization.py``), ``AsyncBuffer``
(``async_buffer.py``), ``Timer`` (``timer.py``) and the machine-file
helpers (``net_util.py``), all copies of the JAX package's,
``prefetch_to_device`` (pinned memory and a side CUDA stream) and the
tree walker ``tree_map`` the checkpoints and ``ext.shared`` use.
"""

from .async_buffer import AsyncBuffer
from .net_util import get_host_name, get_local_ips, match_machine_file
from .prefetch import prefetch_to_device
from .quantization import OneBitCompressor, dequantize_1bit, quantize_1bit
from .timer import Timer
from .tree import tree_map, tree_map_with_path

__all__ = ["AsyncBuffer", "OneBitCompressor", "Timer", "dequantize_1bit",
           "get_host_name", "get_local_ips", "match_machine_file",
           "prefetch_to_device", "quantize_1bit", "tree_map",
           "tree_map_with_path"]
