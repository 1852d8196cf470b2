"""The port's file connectors (``io/fs`` with ``io/csv``,
``io/jsonlines`` and ``io/plaintext``) against the reference's, on the
same files under ``tmp_path``: the same rows under the same keys in
every format, static and streaming, with and without metadata, and the
same written files.  ``seen_at`` in the metadata is the clock at read
time, so it is compared for presence only, as is ``created_at`` (the
change time) of files written for each package apart; every other field
(path, size, modified_at) is equal.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

_MTIME = 1_700_000_000


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()


def _pw(side):
    return pathway_tpu if side == "ref" else pathway_tpu_torch


def _write(path, data, mtime=_MTIME):
    """Write, set the mtime, then move into place: a streaming reader sees
    the file once, with its final mtime."""
    mode = "wb" if isinstance(data, bytes) else "w"
    tmp = path.parent.parent / f"{path.parent.name}-{path.name}.part"  # outside the watched directory
    with open(tmp, mode, **({} if mode == "wb" else {"newline": ""})) as f:
        f.write(data)
    os.utime(tmp, (mtime, mtime))
    os.replace(tmp, path)


_CSV_A = 'id,name,score\n1,alpha,0.5\n2,"beta, with comma",1.25\n3,"say ""hi""",2\n\n4,naïve,\n'
_CSV_B = "id,score,name,extra\r\n5,3.5,eps,x\r\n6,,zeta,y\r\n7\r\n"
_DSV = "# comment\nid;name;score\n8;eta;1\n9;\"th;eta\";2\n"
_JSON = '{"id": 1, "name": "a", "score": 0.5}\n\n{"id": 2, "name": "b"}\n{"name": "c", "id": 3, "score": 7}\n'
_TEXT_A = "first line\nsecond line\n\nfourth, after a blank\n"
_TEXT_B = "one line without a newline"
_BIN = bytes(range(256)) + b"\x00tail"


def _files(root):
    d = root / "data"
    (d / "csv").mkdir(parents=True)
    (d / "dsv").mkdir()
    (d / "json").mkdir()
    (d / "text" / "sub").mkdir(parents=True)
    (d / "bin").mkdir()
    _write(d / "csv" / "a.csv", _CSV_A)
    _write(d / "csv" / "b.csv", _CSV_B, _MTIME + 5)
    _write(d / "dsv" / "c.csv", _DSV)
    _write(d / "json" / "a.jsonl", _JSON)
    _write(d / "text" / "a.txt", _TEXT_A)
    _write(d / "text" / "sub" / "b.txt", _TEXT_B, _MTIME + 9)
    _write(d / "bin" / "blob.bin", _BIN)
    return d


def _schema(pw):
    class S(pw.Schema):
        id: str
        name: str
        score: str

    return S


def _read(side, root, fmt, with_metadata):
    pw = _pw(side)
    d = root / "data"
    kw = dict(mode="static", with_metadata=with_metadata)
    if fmt == "csv":
        t = pw.io.fs.read(str(d / "csv"), format="csv", schema=_schema(pw), **kw)
    elif fmt == "csv_module":
        t = pw.io.csv.read(str(d / "csv" / "*.csv"), schema=_schema(pw), **kw)
    elif fmt == "dsv":
        settings = pw.io.csv.CsvParserSettings(delimiter=";", comment_character="#")
        t = pw.io.fs.read(str(d / "dsv"), format="csv", schema=_schema(pw), csv_settings=settings, **kw)
    elif fmt == "json":
        t = pw.io.fs.read(str(d / "json"), format="json", schema=_schema(pw), **kw)
    elif fmt == "jsonlines":
        t = pw.io.jsonlines.read(str(d / "json" / "a.jsonl"), schema=_schema(pw), **kw)
    elif fmt == "plaintext":
        t = pw.io.plaintext.read(str(d / "text"), **kw)
    elif fmt == "plaintext_by_file":
        t = pw.io.fs.read(str(d / "text"), format="plaintext_by_file", **kw)
    else:
        t = pw.io.fs.read(str(d / "bin"), format="binary", **kw)
    pw.run(monitoring_level=None)
    keys, cols = t._materialize()
    rows = {}
    for i, k in enumerate(keys):
        row = {c: cols[c][i] for c in cols}
        if "_metadata" in row:
            meta = dict(row["_metadata"])
            assert isinstance(meta.pop("seen_at"), (int, float))
            row["_metadata"] = meta
        rows[int(k)] = row
    return rows


_FORMATS = ["csv", "csv_module", "dsv", "json", "jsonlines", "plaintext", "plaintext_by_file", "binary"]


@pytest.mark.parametrize("with_metadata", [False, True], ids=["plain", "metadata"])
@pytest.mark.parametrize("fmt", _FORMATS)
def test_static_read_equals_reference(tmp_path, fmt, with_metadata):
    _files(tmp_path)
    want = _read("ref", tmp_path, fmt, with_metadata)
    pathway_tpu.reset()
    got = _read("port", tmp_path, fmt, with_metadata)
    assert got == want
    assert got  # the format produced rows
    if with_metadata:
        assert all(r["_metadata"]["modified_at"] in (_MTIME, _MTIME + 5, _MTIME + 9) for r in got.values())


def test_csv_cells_are_parsed_as_the_reference_parses_them(tmp_path):
    _files(tmp_path)
    got = _read("port", tmp_path, "csv", False)
    names = sorted(r["name"] for r in got.values() if r["name"] is not None)
    assert 'say "hi"' in names and "beta, with comma" in names and "naïve" in names
    assert sorted(r["id"] for r in got.values()) == ["1", "2", "3", "4", "5", "6", "7"]


def _stream(side, root):
    """A streaming read of a directory while files are added and one is
    rewritten; the subscriber's (key, row, diff) events by phase."""
    pw = _pw(side)
    d = root / side
    d.mkdir()
    _write(d / "a.csv", "id,name,score\n1,a,1\n2,b,2\n")
    t = pw.io.fs.read(str(d), format="csv", schema=_schema(pw), mode="streaming", with_metadata=True,
                      poll_interval_s=0.02)
    events = []
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        meta = dict(row["_metadata"])
        meta.pop("seen_at")
        # each package's files are written at their own moment: the change
        # time differs, mtimes are set
        assert meta.pop("created_at") > 0
        meta["path"] = os.path.relpath(meta["path"], d)
        with lock:
            events.append((int(key), row["id"], row["name"], row["score"], tuple(sorted(meta.items())),
                           1 if is_addition else -1))

    pw.io.subscribe(t, on_change=on_change)
    thread = threading.Thread(target=lambda: pw.run(monitoring_level=None, commit_duration_ms=10), daemon=True)
    thread.start()

    def wait_for(n):
        deadline = time.time() + 30
        while time.time() < deadline:
            with lock:
                if len(events) >= n:
                    return
            time.sleep(0.02)
        raise AssertionError(f"{side}: {len(events)} events, expected {n}")

    try:
        wait_for(2)
        _write(d / "b.csv", "id,name,score\n3,c,3\n", _MTIME + 1)
        wait_for(3)
        _write(d / "a.csv", "id,name,score\n1,a,1\n2,b,2\n4,d,4\n", _MTIME + 2)
        wait_for(6)
        time.sleep(0.2)  # nothing more arrives: unchanged files are not read again
    finally:
        if side == "ref":
            from pathway_tpu.internals.run import terminate
        else:
            from pathway_tpu_torch.internals.run import terminate
        terminate()
        thread.join(timeout=30)
    with lock:
        return list(events)


def test_streaming_read_equals_reference(tmp_path):
    want = _stream("ref", tmp_path)
    pathway_tpu.reset()
    got = _stream("port", tmp_path)
    assert len(got) == len(want) == 6
    assert sorted(got) == sorted(want)
    # a rewritten file is read again, after the new file
    assert [e[1] for e in got[:2]] == ["1", "2"] and got[2][1] == "3"


def _write_run(side, root, fmt):
    pw = _pw(side)
    out = root / f"{side}.{fmt}"
    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=int, s=str, f=float),
        [(1, "plain", 0.5), (2, "with, comma", 1.0), (3, 'quote "q"', -2.25), (4, "naïve", 3.0)],
    )
    out_t = t.filter(pw.this.k > 1).select(pw.this.s, g=pw.this.f * 2, k=pw.this.k)
    if fmt == "csv":
        pw.io.csv.write(out_t, str(out))
    elif fmt == "jsonlines":
        pw.io.jsonlines.write(out_t, str(out))
    else:
        pw.io.fs.write(out_t, str(out), format=fmt)
    t0 = int(time.time() * 1000)
    pw.run(monitoring_level=None)
    return _untimed(out.read_bytes(), fmt, t0)


def _untimed(data, fmt, t0):
    """The written file with its ``time`` values (the engine's commit
    clock, wall milliseconds rounded to its tick) replaced by ``T``; all
    rows of the run share one time, taken during the run."""
    times = set()
    if fmt == "csv":
        lines = data.decode().splitlines()
        assert lines[0].endswith(",time,diff")
        out = [lines[0]]
        for line in lines[1:]:
            head, t, diff = line.rsplit(",", 2)
            times.add(int(t))
            out.append(f"{head},T,{diff}")
    else:
        out = []
        for line in data.decode().splitlines():
            obj = json.loads(line)
            times.add(obj["time"])
            obj["time"] = "T"
            out.append(json.dumps(obj))
    assert len(times) == 1 and t0 - 1000 <= times.pop() <= int(time.time() * 1000) + 1000
    return "\n".join(out).encode()


@pytest.mark.parametrize("fmt", ["csv", "jsonlines", "json"])
def test_write_equals_reference(tmp_path, fmt):
    want = _write_run("ref", tmp_path, fmt)
    pathway_tpu.reset()
    got = _write_run("port", tmp_path, fmt)
    assert got == want
    if fmt != "csv":
        rows = [json.loads(line) for line in got.decode().splitlines()]
        assert sorted(r["k"] for r in rows) == [2, 3, 4] and all(r["diff"] == 1 for r in rows)


def test_csv_round_trip_through_write_and_read(tmp_path):
    pw = pathway_tpu_torch
    t = pw.debug.table_from_rows(pw.schema_from_types(id=str, name=str, score=str),
                                 [("1", "x, y", "0.5"), ("2", 'q "z"', "1")])
    pw.io.csv.write(t, str(tmp_path / "out.csv"))
    pw.run(monitoring_level=None)
    pw.reset()
    back = pw.io.csv.read(str(tmp_path / "out.csv"), schema=_schema(pw), mode="static")
    pw.run(monitoring_level=None)
    _keys, cols = back._materialize()
    assert sorted(zip(cols["id"], cols["name"], cols["score"])) == [("1", "x, y", "0.5"), ("2", 'q "z"', "1")]


def test_read_refuses_a_persistence_config(tmp_path, monkeypatch):
    _files(tmp_path)
    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", str(tmp_path / "state"))
    with pytest.raises(NotImplementedError, match="framework slice 2"):
        pathway_tpu_torch.io.fs.read(str(tmp_path / "data" / "text"), format="plaintext", mode="static")


def test_read_needs_a_schema_for_csv_and_json(tmp_path):
    for fmt in ("csv", "json"):
        for pw in (pathway_tpu, pathway_tpu_torch):
            with pytest.raises(ValueError, match="schema is required"):
                pw.io.fs.read(str(tmp_path), format=fmt, mode="static")


def test_offsets_are_committed_as_the_reference_commits_them(tmp_path):
    """The connector monitor's antichain holds {path: mtime} of every file
    read, as the reference's does."""
    _files(tmp_path)
    mons = {}
    for side in ("ref", "port"):
        pw = _pw(side)
        t = pw.io.fs.read(str(tmp_path / "data" / "text"), format="plaintext", mode="static", name=f"offsets-{side}")
        pw.run(monitoring_level=None)
        assert len(t._materialize()[0]) == 5
        mod = ref_connector if side == "ref" else port_connector
        del mod
        if side == "ref":
            from pathway_tpu.io._offsets import connector_monitors
        else:
            from pathway_tpu_torch.io._offsets import connector_monitors
        mons[side] = [m.offsets.as_dict() for m in connector_monitors() if m.name == f"offsets-{side}"]
    assert mons["port"] == mons["ref"] and mons["port"]
    assert set(mons["port"][0].values()) == {float(_MTIME), float(_MTIME + 9)}
    assert np.all([os.path.isabs(p) or p.startswith(str(tmp_path)) for p in mons["port"][0]])
