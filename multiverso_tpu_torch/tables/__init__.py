"""Tables of the PyTorch port: the dense ``ArrayTable`` so far.

``MatrixTable``, ``SparseMatrixTable``, ``KVTable`` and ``create_table``
come with the row path (ROADMAP.md Queue 1 item 6).
"""

from .base import (Table, bucket_size, host_fetch, host_put,
                   is_multiprocess, multihost_allgather_list, multihost_sum)
from .array_table import ArrayTable

__all__ = [
    "Table",
    "ArrayTable",
    "bucket_size",
    "host_fetch",
    "host_put",
    "is_multiprocess",
    "multihost_allgather_list",
    "multihost_sum",
]
