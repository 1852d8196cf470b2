"""Row keys of the port against the reference, bit for bit.

``pathway_tpu_torch.internals.keys`` hashes with the port's host library
(``csrc/host/tokenize_hash.cc``, built with ``g++`` at first use); the
reference hashes with ``xxhash`` and its own native serializer.  Every
table's row ids derive from these keys, so they must be equal.
"""

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals import keys as ref_keys
from pathway_tpu_torch.internals import keys as port_keys
from pathway_tpu_torch.kernels.host import native_xxh3_64
from pathway_tpu_torch.models._xxh3 import xxh3_64


@pytest.fixture(autouse=True)
def _fresh_graphs():
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()


def _as_port(value):
    """The same value for the port: a reference Pointer becomes the port's."""
    if isinstance(value, ref_keys.Pointer):
        return port_keys.Pointer(int(value))
    if isinstance(value, tuple):
        return tuple(_as_port(v) for v in value)
    return value


_SCALARS = [
    0,
    1,
    -1,
    2**62,
    -(2**63),
    2**63 - 1,
    2**63,
    2**64 - 1,
    2**70,
    -(2**70),
    np.int32(-4),
    np.int64(7),
    np.uint8(200),
    np.uint64(2**63 + 5),
    0.0,
    -0.0,
    1.5,
    float("inf"),
    float("nan"),
    np.float32(0.1),
    "",
    "hello",
    "héllo wörld ✓",
    "x" * 300,
    b"",
    b"\x00\xffbytes",
    True,
    False,
    np.bool_(True),
    None,
    (),
    (1, "a", (2.0, None)),
    [3, b"z"],
    np.arange(6, dtype=np.float32).reshape(2, 3),
    np.array([1, 2, 3], dtype=np.int64),
    ref_keys.Pointer(12345),
    ref_keys.Pointer(2**64 - 1),
]


@pytest.mark.parametrize("value", _SCALARS, ids=[f"{i}-{type(v).__name__}" for i, v in enumerate(_SCALARS)])
def test_ref_scalar_equals_reference(value):
    ref = ref_keys.ref_scalar(value)
    port = port_keys.ref_scalar(_as_port(value))
    assert isinstance(port, port_keys.Pointer)
    assert int(port) == int(ref)
    assert repr(port) == repr(ref)


def test_ref_scalar_of_several_values_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        vals = (int(rng.integers(-(2**40), 2**40)), float(rng.random()), f"s{int(rng.integers(1000))}", None)
        assert int(port_keys.ref_scalar(*vals)) == int(ref_keys.ref_scalar(*vals))


def test_ref_scalar_optional_rejects_none_like_reference():
    with pytest.raises(ValueError):
        ref_keys.ref_scalar(1, None, optional=True)
    with pytest.raises(ValueError):
        port_keys.ref_scalar(1, None, optional=True)


def _columns(kind: str, n: int, rng):
    if kind == "int64":
        return [rng.integers(-(2**62), 2**62, n)]
    if kind == "int32":
        return [rng.integers(-1000, 1000, n).astype(np.int32)]
    if kind == "float":
        return [rng.standard_normal(n)]
    if kind == "bool":
        return [rng.random(n) > 0.5]
    if kind == "pointer":
        return [rng.integers(0, 2**63, n).astype(np.uint64) * np.uint64(2)]
    if kind == "str_ascii":
        return [np.array([f"doc-{i}" for i in rng.integers(0, 10**6, n)], dtype=object)]
    if kind == "str_unicode":
        return [np.array([f"dø{i}✓" for i in range(n)], dtype=object)]
    if kind == "bytes":
        return [np.array([bytes(rng.integers(0, 256, i % 7, dtype=np.uint8)) for i in range(n)], dtype=object)]
    if kind == "str_with_none":
        return [np.array([None if i % 3 == 0 else f"v{i}" for i in range(n)], dtype=object)]
    if kind == "int_with_none":
        return [np.array([None if i % 4 == 1 else i * 7 for i in range(n)], dtype=object)]
    if kind == "float_objects":
        return [np.array([float(x) for x in rng.random(n)], dtype=object)]
    if kind == "all_none":
        return [np.array([None] * n, dtype=object)]
    if kind == "wide_int":
        return [np.array([2**64 + i for i in range(n)], dtype=object)]
    if kind == "mixed":
        return [np.array([[1, "a", None, (1, 2), 2.5][i % 5] for i in range(n)], dtype=object)]
    if kind == "tuples":
        return [_object([(i, f"t{i}") for i in range(n)])]
    if kind == "ndarrays":
        return [_object([np.full(3, i, dtype=np.float64) for i in range(n)])]
    if kind == "pointers_obj":
        return [_object([ref_keys.Pointer(i * 31) for i in range(n)])]
    if kind == "multi":
        return [
            rng.integers(0, 100, n),
            np.array([f"k{i % 13}" for i in range(n)], dtype=object),
            rng.random(n),
            rng.random(n) > 0.3,
        ]
    if kind == "list_columns":
        return [[int(x) for x in rng.integers(0, 50, n)], [f"l{i}" for i in range(n)]]
    raise AssertionError(kind)


def _object(values):
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _port_columns(columns):
    out = []
    for col in columns:
        if isinstance(col, np.ndarray) and col.dtype == object:
            col = _object([_as_port(v) for v in col])
        out.append(col)
    return out


_BATCH_KINDS = [
    "int64",
    "int32",
    "float",
    "bool",
    "pointer",
    "str_ascii",
    "str_unicode",
    "bytes",
    "str_with_none",
    "int_with_none",
    "float_objects",
    "all_none",
    "wide_int",
    "mixed",
    "tuples",
    "ndarrays",
    "pointers_obj",
    "multi",
    "list_columns",
]


@pytest.mark.parametrize("kind", _BATCH_KINDS)
def test_ref_scalars_batch_equals_reference(kind):
    rng = np.random.default_rng(7)
    cols = _columns(kind, 257, rng)
    ref = ref_keys.ref_scalars_batch(cols)
    port = port_keys.ref_scalars_batch(_port_columns(cols))
    assert port.dtype == np.uint64
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("kind", ["int64", "str_ascii", "multi", "mixed"])
def test_ref_scalars_batch_equals_ref_scalar_per_row(kind):
    rng = np.random.default_rng(3)
    cols = _port_columns(_columns(kind, 40, rng))
    batch = port_keys.ref_scalars_batch(cols)
    for i in range(40):
        assert int(batch[i]) == int(port_keys.ref_scalar(*(c[i] for c in cols)))


def test_serialize_rows_is_byte_identical_to_serialize_value():
    rng = np.random.default_rng(11)
    n = 64
    cols = [
        rng.integers(-5, 5, n),
        np.array([None if i % 5 == 0 else f"s{i}é" for i in range(n)], dtype=object),
        rng.random(n),
        rng.random(n) > 0.5,
        rng.integers(0, 2**63, n).astype(np.uint64),
    ]
    specs = [port_keys._native_col_spec(c, n) for c in cols]
    assert all(s is not None for s in specs)
    buf, offs = port_keys.serialize_rows(n, [s[0] for s in specs], [s[1] for s in specs], [s[2] for s in specs])
    for i in range(n):
        row = bytearray()
        for c in cols:
            port_keys._serialize_value(c[i], row)
        assert buf[offs[i] : offs[i + 1]] == bytes(row)


@pytest.mark.parametrize("length", [0, 1, 3, 4, 8, 9, 16, 17, 128, 129, 240, 241, 1024, 1025, 5000])
def test_host_hash_equals_pure_python_xxh3(length):
    data = bytes(np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8))
    offs = np.array([0, length], dtype=np.int64)
    assert int(port_keys.hash_rows(data, offs)[0]) == xxh3_64(data)
    assert native_xxh3_64(data) == xxh3_64(data)


@pytest.mark.parametrize("salt", [0, 1, 17, 2**40])
def test_sequential_keys_equal_reference(salt):
    np.testing.assert_array_equal(
        port_keys.sequential_keys(5, 1000, salt=salt), ref_keys.sequential_keys(5, 1000, salt=salt)
    )


def test_shard_of_equals_reference():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**63, 500).astype(np.uint64) * np.uint64(2) + np.uint64(1)
    for n_shards in (1, 2, 3, 8, 16):
        np.testing.assert_array_equal(port_keys.shards_of(keys, n_shards), ref_keys.shards_of(keys, n_shards))
        for k in keys[:50]:
            assert port_keys.shard_of(int(k), n_shards) == ref_keys.shard_of(int(k), n_shards)


def test_table_row_ids_equal_reference():
    """Primary-key tables and join results carry the reference's ids."""
    rows = [(i, f"name{i}") for i in range(20)]

    def ids(pw):
        class S(pw.Schema):
            k: int = pw.column_definition(primary_key=True)
            name: str

        t = pw.debug.table_from_rows(S, rows)
        u = pw.debug.table_from_rows(pw.schema_from_types(k=int, x=float), [(i, i * 0.5) for i in range(0, 20, 2)])
        j = t.join(u, pw.left.k == pw.right.k).select(pw.left.name, pw.right.x)
        keys_t, _ = t._materialize()
        keys_j, _ = j._materialize()
        return sorted(int(k) for k in keys_t), sorted(int(k) for k in keys_j)

    assert ids(pathway_tpu_torch) == ids(pathway_tpu)


@pytest.mark.parametrize("offsets", [[], [0, 9], [-1, 2], [3, 1]])
def test_hash_rows_rejects_offsets_outside_the_buffer(offsets):
    with pytest.raises(ValueError):
        port_keys.hash_rows(b"abcd", np.asarray(offsets, dtype=np.int64))
