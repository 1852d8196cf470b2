"""The port's native host runtime (``pathway_tpu_torch/native``, over
``csrc/host/native_io.cc``) against the reference's (``pathway_tpu/native``
over ``native/``), on the CPU: the port's library ("native") and its
plain versions ("plain", the ``native.disable`` knob set) give the
reference library's answers on the same inputs.

Two differences are pinned by tests of their own:

- a blank line ending in a bare ``\\r`` is skipped by the port (as by
  Python's ``csv`` module) and read as a row of one empty cell by the
  reference; every other CSV comparison holds the port against the
  reference's answer with such rows taken out;
- the reference's plain ``parse_*`` (``int()`` / ``float()``) accept
  ``_`` separators and refuse hexadecimal floats; its library, and both
  versions of the port, do the opposite.
"""

from __future__ import annotations

import contextlib
import csv
import io
import os
import pickle
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu import native as ref
from pathway_tpu.native import fallback as ref_plain
from pathway_tpu_torch import native as port
from pathway_tpu_torch.internals import keys as port_keys
from pathway_tpu_torch.kernels import build as port_build
from pathway_tpu_torch.kernels import host as port_host

from .test_native import CSV_CASES

MODES = ("native", "plain")
_KNOB = "PATHWAY_TPU_DISABLE_NATIVE"


@pytest.fixture(scope="module", autouse=True)
def _reference_library():
    """The reference reads its knob once, at its first call: load its
    library before any test sets the knob, so it answers natively."""
    saved = os.environ.pop(_KNOB, None)
    try:
        assert ref.lib() is not None, "the reference's native library should build here"
        yield
    finally:
        if saved is not None:
            os.environ[_KNOB] = saved


@contextlib.contextmanager
def _mode(mode: str):
    """The port's native versions, or (``"plain"``) its plain ones."""
    saved = os.environ.pop(_KNOB, None)
    if mode == "plain":
        os.environ[_KNOB] = "1"
    try:
        yield
    finally:
        os.environ.pop(_KNOB, None)
        if saved is not None:
            os.environ[_KNOB] = saved


def _bare_cr_rows(data: bytes, rcs, off, ln, quoted) -> set:
    """Rows of a reference scan that are blank lines ending in a bare
    ``\r``: one unquoted empty cell, at a ``\r``."""
    return {r for r in range(len(rcs) - 1) if rcs[r + 1] - rcs[r] == 1 and ln[rcs[r]] == 0 and not quoted[rcs[r]]
            and data[off[rcs[r]] : off[rcs[r]] + 1] == b"\r"}


def _reference_as_the_port_reads(data: bytes):
    """The reference's ``(csv_scan, csv_rows)`` of ``data`` with each
    bare-``\r`` blank line skipped: a zero-cell row in the scan, no row
    in the rows."""
    rcs, off, ln, quoted = ref.csv_scan(data)
    rows = ref.csv_rows(data)
    bare = _bare_cr_rows(data, rcs, off, ln, quoted)
    nonempty = [r for r in range(len(rcs) - 1) if rcs[r + 1] > rcs[r]]
    assert len(nonempty) == len(rows)
    keep = np.ones(len(off), dtype=bool)
    keep[[rcs[r] for r in bare]] = False
    per_row = np.diff(rcs) - np.isin(np.arange(len(rcs) - 1), list(bare))
    scan = (np.concatenate([[0], np.cumsum(per_row)]).astype(np.int64), off[keep], ln[keep], quoted[keep])
    return scan, [row for r, row in zip(nonempty, rows) if r not in bare]


def _without_bare_cr_blank_lines(data: bytes) -> bytes:
    """``data`` with its bare-``\r`` blank lines taken out (the ``\r``
    after them is no ``\n``, so no other line ending changes)."""
    bare = _bare_cr_rows(data, *ref.csv_scan(data))
    rcs, off, _ln, _q = ref.csv_scan(data)
    cut = {int(off[rcs[r]]) for r in bare}
    return bytes(b for i, b in enumerate(data) if i not in cut)


def _same_scan(got, want) -> None:
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


_MORE_CSV = [
    b"a,b\r\r1,2\r",  # a bare-\r blank line
    b"\r",
    b"\r\r\n\r",
    b"a\rb\r\nc\n",  # bare \r ends a row
    b'"unterminated',
    b'"a"\r"b"\r',
    b'x,"y\r\nz",w\r\n',
    b'caf\xc3\xa9,"\xe2\x82\xac ""q"""\n',
    b"\xff,\xc3\n\x80",
    b'"\xc3"\xa9,1\n',  # a lone closing quote between the bytes of one character
    b",,\n,",
]
_CSV = CSV_CASES + _MORE_CSV


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("data", _CSV)
def test_csv_scan_and_rows_equal_the_reference(data, mode):
    want_scan, want_rows = _reference_as_the_port_reads(data)
    with _mode(mode):
        _same_scan(port.csv_scan(data), want_scan)
        assert port.csv_rows(data) == want_rows


_TOKENS = [b"a", b"bc", b",", b'"', b'""', b"\n", b"\r", b"\r\n", b" ", b"\xc3\xa9", b"\xe2\x82\xac", b"\xff", b"\xc3",
           b"\x80"]


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.sampled_from(_TOKENS), max_size=40).map(b"".join))
def test_csv_buffers_equal_the_reference(data):
    want_scan, want_rows = _reference_as_the_port_reads(data)
    for mode in MODES:
        with _mode(mode):
            _same_scan(port.csv_scan(data), want_scan)
            assert port.csv_rows(data) == want_rows


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.sampled_from([t for t in _TOKENS if t not in (b"\xff", b"\xc3", b"\x80")]), max_size=40)
       .map(b"".join))
def test_csv_rows_of_valid_utf8_equal_the_csv_module(data):
    """On UTF-8 text whose quotes are closed, the port's rows are what
    ``csv.reader`` gives, the reader the port used before."""
    try:
        want = [row for row in csv.reader(io.StringIO(data.decode(), newline="")) if row]
    except csv.Error:  # the module refuses a quote still open at the end
        return
    for mode in MODES:
        with _mode(mode):
            assert port.csv_rows(data) == want


def test_bare_cr_blank_line_is_skipped_where_the_reference_reads_an_empty_cell():
    data = b"a,b\r\r1,2\r"
    assert ref.csv_rows(data) == [["a", "b"], [""], ["1", "2"]]
    want = [row for row in csv.reader(io.StringIO(data.decode(), newline="")) if row]
    assert want == [["a", "b"], ["1", "2"]]
    for mode in MODES:
        with _mode(mode):
            assert port.csv_rows(data) == want
            rcs, off, ln, quoted = port.csv_scan(data)
            assert rcs.tolist() == [0, 2, 2, 4] and ln.tolist() == [1, 1, 1, 1]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cell", [b'a""b""', b"plain", b'Smith" Jr.', b'q"tail"more"', b"", b'"', b'""', b'"""',
                                  b'x"', b'\xc3""\xa9'])
def test_csv_unescape_equals_the_reference(cell, mode):
    with _mode(mode):
        assert port.csv_unescape(cell) == ref.csv_unescape(cell)


# ---------------------------------------------------------------- typed parse

_INT_CELLS = [b"123", b"-45", b"  7 ", b"\t8\t", b"9x", b"", b"   ", b"+12", b"-", b"+", b"- 1", b"99999999999999999999",
              b"9223372036854775807", b"9223372036854775808", b"-9223372036854775808", b"-9223372036854775809", b"-0",
              b"007", b"1_000", b"0x10", b"1.0", b"1e3", b"\n5", b"5\n", b"\xd9\xa3", b"12 34"]
_FLOAT_CELLS = [b"1.5", b"-2e3", b"nan", b"NaN", b"-nan", b"nan(123)", b"nan()", b"nan(", b"inf", b"-Infinity",
                b"INFINITY", b"infinit", b"abc", b"", b" 7 ", b"\t-0.0", b"1_000.5", b"0x1.8p1", b"-0X.8P-1", b"0x1p",
                b"0x", b"0x1.fffffffffffffp1023", b"0x1p99999", b"1e999", b"-1e999", b"1e-999", b"4.9e-324",
                b"2.4703282292062327e-324", b"1.", b".5", b".", b"1e", b"1e+", b"+.5e-3", b"\n2.5", b"2.5\n",
                b"\x0b3", b"1,5", b"0.1", b"123456789012345678901234567890", b"1" * 511, b"1" * 510,
                b"\xd9\xa3.5", b"\x005"]


def _extents(cells):
    data = b"".join(cells)
    ln = np.array([len(c) for c in cells], dtype=np.int64)
    off = np.cumsum(ln) - ln
    return data, off, ln


def _same_parse(got, want) -> None:
    (gv, gok), (wv, wok) = got, want
    np.testing.assert_array_equal(gok, wok)
    assert gv.dtype == wv.dtype
    # bit for bit, a NaN against a NaN
    g = np.where(np.isnan(gv), np.nan, gv) if gv.dtype == np.float64 else gv
    w = np.where(np.isnan(wv), np.nan, wv) if wv.dtype == np.float64 else wv
    np.testing.assert_array_equal(g.view(np.int64), w.view(np.int64))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fn, cells", [("parse_int64", _INT_CELLS), ("parse_float64", _FLOAT_CELLS)])
def test_parse_equals_the_reference_library(fn, cells, mode):
    data, off, ln = _extents(cells)
    want = getattr(ref, fn)(data, off, ln)
    with _mode(mode):
        _same_parse(getattr(port, fn)(data, off, ln), want)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.text("0123456789+-.eExXpPaAfFnNiItTyY_() \t\n", max_size=12).map(str.encode), max_size=12))
def test_parse_of_random_cells_equals_the_reference_library(cells):
    data, off, ln = _extents(cells)
    for fn in ("parse_int64", "parse_float64"):
        want = getattr(ref, fn)(data, off, ln)
        for mode in MODES:
            with _mode(mode):
                _same_parse(getattr(port, fn)(data, off, ln), want)


def test_reference_fallback_disagrees_on_separators_and_hex_floats():
    """The reference's plain parsers accept ``1_000`` and refuse
    ``0x1.8p1``, where its library (and the port) do the opposite."""
    data, off, ln = _extents([b"1_000", b"0x1.8p1"])
    assert ref_plain.parse_int64(data, off, ln)[1].tolist() == [1, 0]
    assert ref_plain.parse_float64(data, off, ln)[1].tolist() == [1, 0]
    assert ref.parse_int64(data, off, ln)[1].tolist() == [0, 0]
    values, ok = ref.parse_float64(data, off, ln)
    assert ok.tolist() == [0, 1] and values[1] == 3.0
    for mode in MODES:
        with _mode(mode):
            assert port.parse_int64(data, off, ln)[1].tolist() == [0, 0]
            values, ok = port.parse_float64(data, off, ln)
            assert ok.tolist() == [0, 1] and values[1] == 3.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("delim, quote", [(",", "é"), ("ab", '"'), ("", '"'), (",", "\u20ac")])
def test_csv_refuses_a_delimiter_or_quote_that_is_not_one_ascii_byte(delim, quote, mode):
    with _mode(mode), pytest.raises(ValueError, match="one ASCII character"):
        port.csv_rows(b"a,b\n", delim, quote)


@pytest.mark.parametrize("fn", ["parse_int64", "parse_float64"])
def test_parse_refuses_extents_outside_the_buffer(fn):
    with pytest.raises(ValueError):
        getattr(port, fn)(b"12", np.array([1], np.int64), np.array([5], np.int64))


# ---------------------------------------------------------------- CRC / frames / shards


@pytest.mark.parametrize("mode", MODES)
def test_crc32_is_zlibs(mode):
    rng = np.random.default_rng(0)
    with _mode(mode):
        for n in list(range(0, 200)) + [255, 256, 1023, 4096, 65_537, 1 << 20]:
            data = rng.bytes(n)
            for value in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
                assert port.crc32(data, value) == zlib.crc32(data, value) == ref.crc32(data, value)
        view = memoryview(rng.bytes(1000))[3:900]
        assert port.crc32(view) == zlib.crc32(view)


def _frames():
    from pathway_tpu.persistence.framing import frame

    records = [b"one", b"", b"three" * 100, pickle.dumps({"k": 1}), bytes(range(256)) * 300]
    blob = b"".join(frame(r) for r in records)
    bad = bytearray(blob)
    bad[len(frame(records[0])) + len(frame(records[1])) + 8 + 2] ^= 0xFF
    # past the library's parallel threshold: its CRCs run on several threads
    chunks = [np.random.default_rng(i).bytes((1 << 20) + 7 * i) for i in range(12)]
    large = b"".join(frame(c) for c in chunks)
    large_bad = bytearray(large)
    large_bad[sum(len(c) + 8 for c in chunks[:7]) + 8 + 12345] ^= 0x01
    return records, {"intact": blob, "torn": blob[:-3], "corrupt": bytes(bad), "empty": b"", "header_only": blob[:5],
                     "large": large, "large_torn": large[:-100], "large_corrupt": bytes(large_bad)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["intact", "torn", "corrupt", "empty", "header_only", "large", "large_torn",
                                  "large_corrupt"])
def test_frame_scan_equals_the_reference(case, mode):
    from pathway_tpu.persistence.framing import scan as ref_scan
    from pathway_tpu_torch.persistence.framing import scan as port_scan

    _records, blobs = _frames()
    data = blobs[case]
    want = ref.frame_scan(data)
    with _mode(mode):
        got = port.frame_scan(data)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert port_scan(data) == ref_scan(data)


def test_frame_scan_spans_many_library_calls(monkeypatch):
    """More frames than one call returns: the scan goes on where the
    call stopped."""
    from pathway_tpu_torch.persistence.framing import frame

    monkeypatch.setattr(port, "_FRAMES_PER_CALL", 3)
    payloads = [bytes([i]) * i for i in range(10)]
    blob = b"".join(frame(p) for p in payloads) + b"\x01\x02"
    offs, lens, consumed = port.frame_scan(blob)
    assert [blob[o : o + n] for o, n in zip(offs, lens)] == payloads
    assert consumed == len(blob) - 2


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_shards", [1, 2, 7, 16])
def test_shard_rows_equals_the_reference(n_shards, mode):
    keys = np.random.default_rng(0).integers(0, 2**64, size=1000, dtype=np.uint64)
    want = ref.shard_rows(keys, n_shards, port_keys.SHARD_MASK)
    with _mode(mode):
        counts, order = port.shard_rows(keys, n_shards, port_keys.SHARD_MASK)
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(order, want[1])


# ---------------------------------------------------------------- serialize / hash / tokenize


def test_public_names_are_the_references():
    public = {name for name in vars(ref) if not name.startswith("_")
              and (getattr(getattr(ref, name), "__module__", None) == ref.__name__ or name.startswith("COL_"))}
    assert public <= set(vars(port)), public - set(vars(port))
    assert set(ref.__all__) <= set(port.__all__)
    assert {name: getattr(port, name) for name in public if name.startswith("COL_")} == \
        {name: getattr(ref, name) for name in public if name.startswith("COL_")}
    assert port_keys.COL_STR is port.COL_STR


@pytest.mark.parametrize("mode", MODES)
def test_serialize_rows_hash_rows_and_tokenize_hash_equal_the_reference(mode):
    from pathway_tpu.internals import keys as ref_keys

    cols = [[1, 2, None], ["a", None, "ccc"], [1.5, float("nan"), -0.0], [True, False, None],
            [ref_keys.Pointer(11), ref_keys.Pointer(12), ref_keys.Pointer(13)], [b"x", b"", b"yz"]]
    specs = [ref_keys._native_col_spec(c, 3) for c in cols]
    args = (3, [s[0] for s in specs], [s[1] for s in specs], [s[2] for s in specs])
    want_buf, want_offs = ref.serialize_rows(*args)
    texts = [b"Hello, world!", b"", b"it's a test-case 42"]
    blob = b"".join(texts)
    offsets = np.concatenate([[0], np.cumsum([len(t) for t in texts])]).astype(np.int64)
    with _mode(mode):
        buf, offs = port.serialize_rows(*args)
        assert buf == want_buf
        np.testing.assert_array_equal(offs, want_offs)
        assert port.serialize_rows(3, args[1], args[2], None)[0] == ref.serialize_rows(3, args[1], args[2], None)[0]
        hashed, tokens = port.hash_rows(buf, offs), port.tokenize_hash(blob, offsets, 32768, 8)
    if mode == "plain":
        assert hashed is None and tokens is None
        return
    np.testing.assert_array_equal(hashed, ref.hash_rows(want_buf, want_offs))
    want_ids, want_tok = ref.tokenize_hash(blob, offsets, 32768, 8)
    np.testing.assert_array_equal(tokens[0], want_ids)
    np.testing.assert_array_equal(tokens[1], want_tok)


# ---------------------------------------------------------------- the knob and the build


def test_disable_knob_answers_with_the_plain_versions(monkeypatch):
    def refuse():
        raise AssertionError("the library was loaded under native.disable")

    monkeypatch.setattr(port, "native_io_lib", refuse)
    data, off, ln = _extents([b"1", b"x"])
    with _mode("plain"):
        assert port.lib() is None and not port.available()
        assert port.csv_rows(b'a,"b""c"\n') == [["a", 'b"c']]
        assert port.parse_int64(data, off, ln)[1].tolist() == [1, 0]
        assert port.crc32(b"abc") == zlib.crc32(b"abc")
        assert port.frame_scan(b"")[2] == 0
        assert port.shard_rows(np.arange(4, dtype=np.uint64), 2, 0xFFFF)[0].tolist() == [2, 2]
    with pytest.raises(AssertionError, match="native.disable"):
        port.csv_rows(b"a\n")


def test_failed_build_raises_instead_of_answering_plainly(monkeypatch, tmp_path):
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_build, "_libs", {})
    monkeypatch.setattr(port_host, "_io_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with _mode("native"):
        with pytest.raises(port.BuildError, match="no-such-compiler"):
            port.csv_rows(b"a,b\n")
        with pytest.raises(port.BuildError):
            port.available()
        with pytest.raises(port.BuildError):
            port.build()
    with _mode("plain"):
        assert port.csv_rows(b"a,b\n") == [["a", "b"]]
    assert not (tmp_path / "_build").exists() or not list((tmp_path / "_build").glob("*.so"))


def test_build_force_rebuilds_the_library():
    target = port_build.build_host("native_io")
    before = target.stat().st_mtime_ns
    assert port.build(force=True) is True
    assert target.exists() and target.stat().st_mtime_ns >= before


# ---------------------------------------------------------------- pw.io.fs and persistence


_FS_FILES = {
    "a.csv": b'id,text,score\n1,"quoted\nnewline",0.5\n2,"say ""hi""",1\n\n',
    "b.csv": b"id,text,score\r\n3,crlf,2.5\r\n4,\"x,y\",\r\n",
    "c.csv": b"id,text,score,\n5,trailing,3,\n6,delim,4,",
    "d.csv": b"id,text,score\r7,bare cr,1\r\r8,after the blank line,2\r",
}


def _fs_rows(pw, folder):
    class S(pw.Schema):
        id: str
        text: str
        score: str

    t = pw.io.fs.read(str(folder), format="csv", schema=S, mode="static")
    pw.run(monitoring_level=None)
    _keys, cols = t._materialize()
    return sorted(zip(cols["id"], cols["text"], cols["score"]), key=repr)


def test_fs_read_of_csv_files_equals_the_reference(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    for name, data in _FS_FILES.items():
        (tmp_path / "port" / name).write_bytes(data)
        (tmp_path / "ref" / name).write_bytes(_without_bare_cr_blank_lines(data))
    pathway_tpu.reset()
    want = _fs_rows(pathway_tpu, tmp_path / "ref")
    pathway_tpu_torch.reset()
    got = _fs_rows(pathway_tpu_torch, tmp_path / "port")
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    assert got == want
    assert ("8", "after the blank line", "2") in got and len(got) == 8
    # the port's reader (the csv module) and its native scanner agree on the files
    for name, data in _FS_FILES.items():
        assert port.csv_rows(data) == [row for row in csv.reader(io.StringIO(data.decode(), newline="")) if row]
    # on the files as written, the reference reads the bare-\r line of
    # d.csv as a row with an empty id and no other cells (coerced to "None")
    assert not any(row[0] == "" for row in got)
    pathway_tpu.reset()
    assert ("", "None", "None") in _fs_rows(pathway_tpu, tmp_path / "port")
    pathway_tpu.reset()


@pytest.mark.parametrize("mode", MODES)
def test_persistence_chunks_survive_torn_write(mode):
    """A chunk with a torn tail replays its intact prefix (the reference's
    ``tests/test_native.py`` case, on the port)."""
    from pathway_tpu_torch.persistence.backends import MemoryBackend
    from pathway_tpu_torch.persistence.engine_state import SourcePersistence

    with _mode(mode):
        backend = MemoryBackend()
        sp = SourcePersistence(backend, "src1")
        events = [(1, i, (f"row{i}",)) for i in range(10)]
        for e in events:
            sp.record(e)
        sp.flush(frontier=100)
        key = "sources/src1/chunk-00000000"
        blob = backend.get(key)
        backend.put(key, blob[: len(blob) - 5])
        assert SourcePersistence(backend, "src1").replay_events() == events[:-1]


def test_chip_smoke_phase_27_at_a_small_size_on_the_cpu():
    """Phase 27 of ``chip_smoke.py`` on the CPU at 4,096 documents: its
    host turns (each native result equal to the plain one) and its CSV-fed
    index (the engine's rows == the ``csv`` module's, every answer == an
    exact search) with a small f32 embedder."""
    import importlib.util

    import torch

    from .utils import REPO_ROOT

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    pathway_tpu_torch.reset()
    try:
        launches, shape, secs = chip_smoke.native_phase("[cpu]", dev=torch.device("cpu"),
                                                        docs=chip_smoke.corpus(4096), frame_bytes=8 << 20,
                                                        n_events=4096, commits=2)
    finally:
        pathway_tpu_torch.reset()
    assert launches == 0 and shape is None  # no card: the rescore's plain version, nothing timed on a device
    assert set(secs) == {"csv_rows", "parse_int64", "parse_float64", "crc32", "frame_scan", "frame_chunks",
                         "frame_events", "scan_events"}
    assert all(len(t["native"]) == len(t["plain"]) == 2 for t in secs.values())
