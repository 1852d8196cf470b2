"""pw.io.s3_csv — CSV-from-S3 convenience wrapper (counterpart of
``pathway_tpu/io/s3_csv``; reference: python/pathway/io/s3_csv/__init__.py — delegates to the s3
reader with format="csv"; kept as its own module for API parity)."""

from __future__ import annotations

from typing import Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from ..s3 import AwsS3Settings, read as s3_read

__all__ = ["read", "AwsS3Settings"]


def read(
    path: str,
    *,
    aws_s3_settings: Optional[AwsS3Settings] = None,
    schema: Optional[Type[Schema]] = None,
    csv_settings=None,
    mode: str = "streaming",
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    """Read CSV objects under an S3 path prefix (reference signature)."""
    return s3_read(
        path,
        aws_s3_settings=aws_s3_settings,
        format="csv",
        schema=schema,
        csv_settings=csv_settings,
        mode=mode,
        persistent_id=persistent_id,
        name="s3_csv",
        **kwargs,
    )
