"""pw.utils of the port (counterpart of ``pathway_tpu/stdlib/utils``;
reference: python/pathway/stdlib/utils/)."""

from . import col, pandas_transformer  # the module: pandas loads only when a transformer runs
from .async_transformer import AsyncTransformer
from .col import apply_all_rows, flatten_column, multiapply_all_rows, unpack_col

__all__ = [
    "col",
    "unpack_col",
    "apply_all_rows",
    "multiapply_all_rows",
    "flatten_column",
    "AsyncTransformer",
]
