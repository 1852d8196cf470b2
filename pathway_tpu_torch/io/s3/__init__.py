"""pw.io.s3 / s3_csv / minio — object-store connectors (counterpart of
``pathway_tpu/io/s3``; reference: python/pathway/io/s3/__init__.py over the S3 scanner,
src/connectors/scanner/s3.rs — posix-like listing + object reads).
Gated on boto3; parsing reuses the fs format stack.  Keyword arguments
the reference takes and never reads raise.
"""

from __future__ import annotations

import hashlib
import os
import zlib
import tempfile
import time
from typing import Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from .._connector import SessionWriter, refuse_dropped, register_source
from .._gated import require

__all__ = ["read", "AwsS3Settings"]


class AwsS3Settings:
    """(reference AwsS3Settings: bucket, region, access keys, endpoint)"""

    def __init__(
        self,
        bucket_name: Optional[str] = None,
        access_key: Optional[str] = None,
        secret_access_key: Optional[str] = None,
        region: Optional[str] = None,
        endpoint: Optional[str] = None,
        with_path_style: bool = False,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.region = region
        self.endpoint = endpoint
        self.with_path_style = with_path_style

    def create_client(self):
        boto3 = require("boto3", "s3")
        kwargs = {}
        if self.access_key:
            kwargs["aws_access_key_id"] = self.access_key
        if self.secret_access_key:
            kwargs["aws_secret_access_key"] = self.secret_access_key
        if self.region:
            kwargs["region_name"] = self.region
        if self.endpoint:
            kwargs["endpoint_url"] = self.endpoint
        return boto3.client("s3", **kwargs)


def read(
    path: str,
    *,
    aws_s3_settings: Optional[AwsS3Settings] = None,
    format: str = "csv",
    schema: Optional[Type[Schema]] = None,
    mode: str = "streaming",
    poll_interval_s: float = 5.0,
    name: str = "s3",
    persistent_id: Optional[str] = None,
    csv_settings=None,
    **kwargs,
) -> Table:
    """Read objects under ``s3://bucket/prefix`` (or ``path`` as prefix with
    settings.bucket_name), parsing like pw.io.fs."""
    refuse_dropped("pw.io.s3.read", kwargs)
    settings = aws_s3_settings or AwsS3Settings()
    bucket, prefix = _split_path(path, settings)
    client = settings.create_client()
    # objects are downloaded (etag-versioned) into a temp dir, then parsed by
    # the shared fs format stack
    tmpdir = tempfile.mkdtemp(prefix="pw_s3_")

    def runner(writer: SessionWriter):
        pers = writer.persistence
        seen = dict((pers.offsets() or {}) if pers else {})
        from ..fs import _parse_into  # shared single-file parser

        from ...parallel.distributed import topology_from_env

        nproc, rank, _addr = topology_from_env()
        while True:
            paginator = client.get_paginator("list_objects_v2")
            for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
                for obj in page.get("Contents", []):
                    key, etag = obj["Key"], obj.get("ETag", "")
                    if nproc > 1 and (
                        zlib.crc32(key.encode()) % nproc != rank
                    ):
                        continue  # another rank owns this object (parallel readers)
                    if seen.get(key) == etag:
                        continue
                    # hash-suffixed cache name: '/'-flattening alone is not
                    # injective ('a/b' vs 'a__b')
                    digest = hashlib.sha1(key.encode()).hexdigest()[:12]
                    local = os.path.join(
                        tmpdir, f"{os.path.basename(key)}.{digest}"
                    )
                    client.download_file(bucket, key, local)
                    _parse_into(
                        local, writer, format, schema, csv_settings=csv_settings
                    )
                    seen[key] = etag
                    if pers is not None:
                        pers.save_offsets(dict(seen))
            if mode == "static":
                return
            time.sleep(poll_interval_s)

    return register_source(
        schema,
        runner,
        mode=mode,
        name=name,
        persistent_id=persistent_id,
        dist_mode="partitioned",
    )


def _split_path(path: str, settings: AwsS3Settings):
    if path.startswith("s3://"):
        rest = path[5:]
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix
    if settings.bucket_name is None:
        raise ValueError("bucket not given (use s3://bucket/prefix or settings)")
    return settings.bucket_name, path.lstrip("/")
