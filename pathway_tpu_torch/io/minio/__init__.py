"""pw.io.minio — MinIO connector (S3-compatible; counterpart of
``pathway_tpu/io/minio``; reference:
python/pathway/io/minio/__init__.py — thin wrapper over the s3 reader with a
custom endpoint)."""

from __future__ import annotations

from typing import Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from ..s3 import AwsS3Settings
from ..s3 import read as _s3_read

__all__ = ["read", "MinIOSettings"]


class MinIOSettings:
    def __init__(
        self,
        endpoint: str,
        bucket_name: str,
        access_key: str,
        secret_access_key: str,
        *,
        with_path_style: bool = True,
        region: Optional[str] = None,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region

    def create_aws_settings(self) -> AwsS3Settings:
        endpoint = self.endpoint
        if not endpoint.startswith("http"):
            endpoint = f"https://{endpoint}"
        return AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            region=self.region,
            endpoint=endpoint,
            with_path_style=self.with_path_style,
        )


def read(
    path: str,
    minio_settings: MinIOSettings,
    *,
    format: str = "csv",
    schema: Optional[Type[Schema]] = None,
    **kwargs,
) -> Table:
    return _s3_read(
        path,
        aws_s3_settings=minio_settings.create_aws_settings(),
        format=format,
        schema=schema,
        **kwargs,
    )
