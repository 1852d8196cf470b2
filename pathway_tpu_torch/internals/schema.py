"""Class-based table schemas.

Mirrors the reference's schema surface (python/pathway/internals/schema.py:
class-based schemas with annotated columns, ``column_definition`` for primary
keys/defaults, ``schema_from_types``/``schema_from_dict`` builders) but the
dtype vocabulary is our own (dtype.py) and schemas additionally expose the
dense/device storage layout of each column.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Type

from . import dtype as dt

__all__ = [
    "Schema",
    "ColumnDefinition",
    "SchemaProperties",
    "column_definition",
    "schema_from_types",
    "schema_from_dict",
    "schema_from_csv",
    "schema_builder",
]

_NO_DEFAULT = object()


@dataclass(frozen=True)
class SchemaProperties:
    """Whole-schema properties (reference internals/schema.py:263)."""

    append_only: Optional[bool] = None


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = _NO_DEFAULT

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not _NO_DEFAULT


@dataclass
class ColumnDefinition:
    primary_key: bool = False
    default_value: Any = _NO_DEFAULT
    dtype: Optional[Any] = None
    name: Optional[str] = None


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _NO_DEFAULT,
    dtype: Any = None,
    name: str | None = None,
) -> Any:
    """Declare column properties inside a Schema class
    (reference: python/pathway/internals/schema.py `column_definition`)."""
    return ColumnDefinition(
        primary_key=primary_key, default_value=default_value, dtype=dtype, name=name
    )


class SchemaMetaclass(type):
    __columns__: Dict[str, ColumnSchema]

    def __init__(cls, name, bases, namespace, append_only: bool = False, **kwargs):
        super().__init__(name, bases, namespace)
        columns: Dict[str, ColumnSchema] = {}
        for base in reversed(bases):
            columns.update(getattr(base, "__columns__", {}))
        annotations = namespace.get("__annotations__", {})
        if any(isinstance(a, str) for a in annotations.values()):
            # `from __future__ import annotations` in the user's module turns
            # annotations into strings — resolve them PER KEY against the
            # defining module's globals, so one TYPE_CHECKING-only name can't
            # degrade every other column to ANY
            import sys

            module = sys.modules.get(namespace.get("__module__", ""), None)
            module_globals = getattr(module, "__dict__", {})
            resolved = {}
            for key, annotation in annotations.items():
                if isinstance(annotation, str):
                    try:
                        annotation = eval(  # noqa: S307 - annotation eval
                            annotation, module_globals, dict(namespace)
                        )
                    except Exception:
                        pass  # unresolvable name keeps its raw form (ANY)
                resolved[key] = annotation
            annotations = resolved
        for col_name, annotation in annotations.items():
            if col_name.startswith("__"):
                continue
            definition = namespace.get(col_name, None)
            if isinstance(definition, ColumnDefinition):
                dtype = dt.wrap(definition.dtype) if definition.dtype is not None else dt.wrap(annotation)
                columns[definition.name or col_name] = ColumnSchema(
                    name=definition.name or col_name,
                    dtype=dtype,
                    primary_key=definition.primary_key,
                    default_value=definition.default_value,
                )
            else:
                columns[col_name] = ColumnSchema(name=col_name, dtype=dt.wrap(annotation))
        cls.__columns__ = columns
        cls.__append_only__ = append_only or getattr(cls, "__append_only__", False)

    def column_names(cls):
        return list(cls.__columns__.keys())

    def columns(cls) -> Mapping[str, ColumnSchema]:
        return dict(cls.__columns__)

    def typehints(cls) -> Dict[str, dt.DType]:
        return {name: c.dtype for name, c in cls.__columns__.items()}

    def primary_key_columns(cls):
        pks = [name for name, c in cls.__columns__.items() if c.primary_key]
        return pks or None

    def default_values(cls) -> Dict[str, Any]:
        return {
            name: c.default_value
            for name, c in cls.__columns__.items()
            if c.has_default_value
        }

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        columns = {**cls.__columns__, **other.__columns__}
        return _make_schema(f"{cls.__name__}|{other.__name__}", columns)

    def with_types(cls, **kwargs) -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, t in kwargs.items():
            if name not in columns:
                raise ValueError(f"unknown column {name!r}")
            columns[name] = ColumnSchema(
                name=name,
                dtype=dt.wrap(t),
                primary_key=columns[name].primary_key,
                default_value=columns[name].default_value,
            )
        return _make_schema(cls.__name__, columns)

    def without(cls, *names: str) -> "SchemaMetaclass":
        columns = {k: v for k, v in cls.__columns__.items() if k not in names}
        return _make_schema(cls.__name__, columns)

    def update_types(cls, **kwargs) -> "SchemaMetaclass":
        return cls.with_types(**kwargs)

    def __repr__(cls):
        cols = ", ".join(f"{n}: {c.dtype}" for n, c in cls.__columns__.items())
        return f"<Schema {cls.__name__}({cols})>"


class Schema(metaclass=SchemaMetaclass):
    """Base class for user-defined schemas::

        class InputSchema(Schema):
            doc: str
            rank: int = column_definition(primary_key=True)
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__()


def _make_schema(name: str, columns: Dict[str, ColumnSchema]) -> SchemaMetaclass:
    schema = SchemaMetaclass(name, (Schema,), {})
    schema.__columns__ = columns
    return schema


def schema_from_types(_name: str = "Schema", **types: Any) -> Type[Schema]:
    columns = {k: ColumnSchema(name=k, dtype=dt.wrap(t)) for k, t in types.items()}
    return _make_schema(_name, columns)


def schema_from_dict(
    columns: Mapping[str, Any], *, name: str = "Schema"
) -> Type[Schema]:
    out: Dict[str, ColumnSchema] = {}
    for k, v in columns.items():
        if isinstance(v, ColumnDefinition):
            out[k] = ColumnSchema(
                name=k,
                dtype=dt.wrap(v.dtype) if v.dtype is not None else dt.ANY,
                primary_key=v.primary_key,
                default_value=v.default_value,
            )
        else:
            out[k] = ColumnSchema(name=k, dtype=dt.wrap(v))
    return _make_schema(name, out)


class _SchemaBuilder:
    def __init__(self):
        self._columns: Dict[str, ColumnSchema] = {}

    def add(self, name: str, dtype: Any = dt.ANY, **kwargs) -> "_SchemaBuilder":
        cd = column_definition(dtype=dtype, **kwargs)
        self._columns[name] = ColumnSchema(
            name=name,
            dtype=dt.wrap(dtype),
            primary_key=cd.primary_key,
            default_value=cd.default_value,
        )
        return self

    def build(self, name: str = "Schema") -> Type[Schema]:
        return _make_schema(name, dict(self._columns))


def schema_from_csv(
    path: str,
    *,
    name: str = "Schema",
    properties: SchemaProperties = SchemaProperties(),
    delimiter: str = ",",
    quote: str = '"',
    comment_character: Optional[str] = None,
    escape: Optional[str] = None,
    double_quote_escapes: bool = True,
    num_parsed_rows: Optional[int] = None,
) -> Type[Schema]:
    """Infer a schema from a CSV file's header + values: a column is int if
    every value parses as int, else float if every value parses as float,
    else str (reference internals/schema.py:832 ``schema_from_csv``).
    With no sampled values (``num_parsed_rows=0`` or a header-only file) a
    column types as ANY — same as the reference's ``choose_type([])``."""
    import csv
    import itertools

    def lines_without_comments(f):
        for line in f:
            if comment_character is None or not line.lstrip().startswith(
                comment_character
            ):
                yield line

    with open(path, newline="") as f:
        reader = csv.DictReader(
            lines_without_comments(f),
            delimiter=delimiter,
            quotechar=quote,
            escapechar=escape,
            doublequote=double_quote_escapes,
        )
        if reader.fieldnames is None:
            raise ValueError("can't generate Schema based on an empty CSV file")
        column_names = list(reader.fieldnames)
        rows = list(
            reader if num_parsed_rows is None else itertools.islice(reader, num_parsed_rows)
        )

    def parses(s: str, fn) -> bool:
        try:
            fn(s)
            return True
        except (TypeError, ValueError):
            return False

    def choose_type(values):
        if not values:
            return dt.ANY
        if all(parses(v, int) for v in values):
            return dt.INT
        if all(parses(v, float) for v in values):
            return dt.FLOAT
        return dt.STR

    columns = {
        col: ColumnSchema(name=col, dtype=choose_type([r[col] for r in rows]))
        for col in column_names
    }
    schema = _make_schema(name, columns)
    if properties.append_only is not None:
        schema.__append_only__ = properties.append_only
    return schema


def schema_builder(
    columns: Mapping[str, ColumnDefinition] | None = None, *, name: str = "Schema"
) -> Type[Schema]:
    """Build a schema from a dict of column definitions
    (reference: python/pathway/internals/schema.py `schema_builder`)."""
    columns = columns or {}
    out: Dict[str, ColumnSchema] = {}
    for k, v in columns.items():
        dtype = dt.wrap(v.dtype) if v.dtype is not None else dt.ANY
        out[k] = ColumnSchema(
            name=k, dtype=dtype, primary_key=v.primary_key, default_value=v.default_value
        )
    return _make_schema(name, out)
