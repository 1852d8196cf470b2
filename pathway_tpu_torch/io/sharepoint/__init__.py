"""pw.io.sharepoint — SharePoint document-library input connector
(counterpart of ``pathway_tpu/io/sharepoint``; reference: the licensed xpack connector,
python/pathway/xpacks/connectors/sharepoint/, 376 LoC — lists a library
path, downloads new/changed files, emits bytes + metadata).  Gated on
Office365-REST-Python-Client.  Keyword arguments the reference takes and never reads raise."""

from __future__ import annotations

import time
from typing import Optional

from ...internals import dtype as dt
from ...internals.schema import ColumnSchema, _make_schema, schema_from_types
from ...internals.table import Table
from .._connector import SessionWriter, refuse_dropped, register_source
from .._gated import require

__all__ = ["read"]


def read(
    url: str,
    *,
    root_path: str,
    client_id: str,
    client_secret: Optional[str] = None,
    cert_path: Optional[str] = None,
    thumbprint: Optional[str] = None,
    tenant: Optional[str] = None,
    mode: str = "streaming",
    refresh_interval: int = 30,
    with_metadata: bool = False,
    recursive: bool = True,
    name: str = "sharepoint",
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    """Stream files of a SharePoint document library folder.

    ``url`` is the site url (https://<org>.sharepoint.com/sites/<site>),
    ``root_path`` the server-relative folder ("Shared Documents/data").
    Auth: client credentials (client_id + client_secret) or certificate
    (client_id + cert_path + thumbprint + tenant)."""
    refuse_dropped("pw.io.sharepoint.read", kwargs)
    require(
        "office365",
        "sharepoint",
        "pip package Office365-REST-Python-Client",
    )
    if client_secret is None and not (cert_path and thumbprint and tenant):
        # validate HERE: in streaming mode the runner dies in a daemon
        # thread, which would leave an empty source and a buried traceback
        raise ValueError(
            "sharepoint auth needs client_secret or "
            "cert_path+thumbprint+tenant"
        )
    schema = schema_from_types(data=bytes)
    if with_metadata:
        cols = dict(schema.columns())
        cols["_metadata"] = ColumnSchema(name="_metadata", dtype=dt.JSON)
        schema = _make_schema("SharePointSchema", cols)

    def connect():
        from office365.runtime.auth.client_credential import (  # type: ignore
            ClientCredential,
        )
        from office365.sharepoint.client_context import ClientContext  # type: ignore

        ctx = ClientContext(url)
        if client_secret is not None:
            return ctx.with_credentials(
                ClientCredential(client_id, client_secret)
            )
        return ctx.with_client_certificate(
            tenant, client_id, thumbprint, cert_path
        )

    def list_files(ctx, folder_path):
        folder = ctx.web.get_folder_by_server_relative_url(folder_path)
        files = folder.files
        ctx.load(files)
        ctx.execute_query()
        out = [(f, folder_path) for f in files]
        if recursive:
            subs = folder.folders
            ctx.load(subs)
            ctx.execute_query()
            for sub in subs:
                out.extend(
                    list_files(ctx, f"{folder_path}/{sub.properties['Name']}")
                )
        return out

    def runner(writer: SessionWriter):
        ctx = connect()
        pers = writer.persistence
        seen = dict((pers.offsets() or {}) if pers else {})
        while True:
            for f, folder_path in list_files(ctx, root_path):
                props = f.properties
                rel = props.get("ServerRelativeUrl") or (
                    f"{folder_path}/{props['Name']}"
                )
                mtime = str(props.get("TimeLastModified", ""))
                if seen.get(rel) == mtime:
                    continue
                import io as _io

                buf = _io.BytesIO()
                f.download(buf).execute_query()
                values = {"data": buf.getvalue()}
                if with_metadata:
                    values["_metadata"] = {
                        "path": rel,
                        "name": props.get("Name"),
                        "modified_at": mtime,
                        "size": props.get("Length"),
                    }
                writer.insert(values)
                seen[rel] = mtime
                writer.commit_offsets(seen)
            if mode == "static":
                return
            time.sleep(refresh_interval)

    return register_source(
        schema, runner, mode=mode, name=name, persistent_id=persistent_id
    )
