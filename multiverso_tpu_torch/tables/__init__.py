"""Tables of the PyTorch port: the dense ``ArrayTable``, the row tables
``MatrixTable`` and ``SparseMatrixTable``, the host-resident ``KVTable``
and the ``create_table`` factory."""

from .base import (Table, bucket_size, host_fetch, host_put,
                   is_multiprocess, multihost_allgather_list, multihost_sum)
from .array_table import ArrayTable
from .matrix_table import MatrixTable
from .sparse_matrix_table import SparseMatrixTable
from .kv_table import KVTable
from .factory import create_table

__all__ = [
    "Table",
    "ArrayTable",
    "MatrixTable",
    "SparseMatrixTable",
    "KVTable",
    "create_table",
    "bucket_size",
    "host_fetch",
    "host_put",
    "is_multiprocess",
    "multihost_allgather_list",
    "multihost_sum",
]
