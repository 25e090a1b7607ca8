"""Table factory — reference ``table_factory.h`` (SURVEY.md §2.15).

The reference creates a matching worker+server table pair on every node from
a typed option struct; here one call builds the sharded table on the mesh.
"""

from __future__ import annotations

from typing import Any

from .array_table import ArrayTable
from .kv_table import KVTable
from .matrix_table import MatrixTable
from .sparse_matrix_table import SparseMatrixTable

__all__ = ["create_table"]

_KINDS = {
    "array": ArrayTable,
    "matrix": MatrixTable,
    "sparse_matrix": SparseMatrixTable,
    "kv": KVTable,
}


def create_table(kind: str, *args, **kwargs) -> Any:
    try:
        cls = _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown table kind '{kind}'; known: {sorted(_KINDS)}")
    return cls(*args, **kwargs)
