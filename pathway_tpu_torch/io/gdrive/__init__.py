"""pw.io.gdrive — Google Drive input connector (counterpart of
``pathway_tpu/io/gdrive``; reference: python/pathway/io/gdrive/__init__.py, 401 LoC — lists a folder
via the Drive v3 API, downloads new/changed objects, emits file bytes).
Gated on google-api-python-client.  ``with_metadata=True`` (the rows carry
no metadata) and keyword arguments the reference takes and never reads
raise."""

from __future__ import annotations

import time
from typing import Optional

from ...internals.schema import schema_from_types
from ...internals.table import Table
from .._connector import SessionWriter, refuse_dropped, register_source
from .._gated import require

__all__ = ["read"]


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    refresh_interval: int = 30,
    service_user_credentials_file: str,
    with_metadata: bool = False,
    name: str = "gdrive",
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    refuse_dropped("pw.io.gdrive.read", kwargs)
    if with_metadata:
        raise ValueError("pw.io.gdrive.read: with_metadata is not supported (the reference accepts it and its rows "
                         "carry no metadata)")
    require("googleapiclient", "gdrive", "pip package google-api-python-client")
    schema = schema_from_types(data=bytes)

    def runner(writer: SessionWriter):
        from google.oauth2.service_account import Credentials  # type: ignore
        from googleapiclient.discovery import build  # type: ignore

        creds = Credentials.from_service_account_file(
            service_user_credentials_file,
            scopes=["https://www.googleapis.com/auth/drive.readonly"],
        )
        service = build("drive", "v3", credentials=creds)
        pers = writer.persistence
        seen = dict((pers.offsets() or {}) if pers else {})
        while True:
            resp = (
                service.files()
                .list(
                    q=f"'{object_id}' in parents and trashed = false",
                    fields="files(id, name, modifiedTime)",
                )
                .execute()
            )
            for f in resp.get("files", []):
                fid, mtime = f["id"], f.get("modifiedTime", "")
                if seen.get(fid) == mtime:
                    continue
                data = service.files().get_media(fileId=fid).execute()
                writer.insert({"data": data})
                seen[fid] = mtime
                if pers is not None:
                    pers.save_offsets(dict(seen))
            if mode == "static":
                return
            time.sleep(refresh_interval)

    return register_source(
        schema, runner, mode=mode, name=name, persistent_id=persistent_id
    )
