"""Row transformers of the port (counterpart of
``pathway_tpu/internals/row_transformer.py``) — the legacy recursive
"transformer classes" API
(reference: python/pathway/internals/row_transformer.py:26-294 +
graph_runner/row_transformer_operator_handler.py:306, engine side
complex_columns src/engine/dataflow/complex_columns.rs:489).

A transformer declares one ``ClassArg`` per table; output attributes are
python functions over the row (``self``) that may chase pointers into any
argument table via ``self.transformer.<arg>[pointer]`` — including
recursively (linked lists, skip lists).  The reference compiles these to
engine "complex columns" with demand-driven evaluation; here a multi-output
host operator re-evaluates the attribute graph at each tick end with
per-(row, attribute) memoization and emits diffs, which preserves the
recursive semantics on the micro-batch engine (cheap for the control-plane
scale this legacy API serves).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..engine.delta import Delta, rows_equal
from ..engine.graph import EngineOperator
from . import dtype as dt
from .parse_graph import G
from .universe import Universe

__all__ = [
    "ClassArg",
    "input_attribute",
    "input_method",
    "attribute",
    "output_attribute",
    "method",
    "transformer",
]


class _InputAttribute:
    def __init__(self):
        self.name: str = ""


class _InputMethod(_InputAttribute):
    pass


class _ComputedAttribute:
    is_output = False
    is_method = False

    def __init__(self, fn: Callable):
        self.fn = fn
        self.name = fn.__name__


class _Attribute(_ComputedAttribute):
    """Internal computed attribute (not materialised in the output)."""


class _OutputAttribute(_ComputedAttribute):
    is_output = True


class _Method(_ComputedAttribute):
    is_output = True
    is_method = True


def input_attribute(type: Any = None) -> Any:
    return _InputAttribute()


def input_method(type: Any = None) -> Any:
    return _InputMethod()


def attribute(fn: Callable) -> Any:
    return _Attribute(fn)


def output_attribute(fn: Callable) -> Any:
    return _OutputAttribute(fn)


def method(fn: Callable) -> Any:
    return _Method(fn)


class _ClassArgMeta(type):
    def __new__(mcs, name, bases, ns, input=None, output=None, **kwargs):
        cls = super().__new__(mcs, name, bases, ns)
        cls._input_schema = input
        cls._output_schema = output
        cls._inputs = {
            k: v for k, v in ns.items() if isinstance(v, _InputAttribute)
        }
        cls._computed = {
            k: v for k, v in ns.items() if isinstance(v, _ComputedAttribute)
        }
        for k, v in {**cls._inputs, **cls._computed}.items():
            v.name = k
        return cls

    def __init__(cls, name, bases, ns, **kwargs):
        super().__init__(name, bases, ns)


class ClassArg(metaclass=_ClassArgMeta):
    """Base class for transformer table arguments (reference ClassArg)."""


class _RowView:
    """``self`` inside attribute functions: gives input attrs, computed
    attrs (memoized, possibly recursing into other rows) and ``.id``."""

    __slots__ = ("_eval", "_arg_name", "_key", "id", "transformer", "pointer_from")

    def __init__(self, evaluator: "_Evaluator", arg_name: str, key: int):
        self._eval = evaluator
        self._arg_name = arg_name
        self._key = key
        self.id = key
        self.transformer = evaluator.namespace

    def __getattr__(self, name: str):
        return self._eval.attr(self._arg_name, self._key, name)


class _ArgProxy:
    """``self.transformer.<arg>`` — indexable by pointer."""

    def __init__(self, evaluator: "_Evaluator", arg_name: str):
        self._eval = evaluator
        self._arg_name = arg_name

    def __getitem__(self, pointer) -> _RowView:
        return _RowView(self._eval, self._arg_name, int(pointer))


class _Namespace:
    pass


class _Evaluator:
    """One tick-end evaluation pass over all transformer rows."""

    def __init__(self, spec: "_BoundTransformer"):
        self.spec = spec
        self.memo: Dict[Tuple[str, int, str], Any] = {}
        self.in_progress: set = set()
        self.namespace = _Namespace()
        for arg_name in spec.args:
            setattr(self.namespace, arg_name, _ArgProxy(self, arg_name))

    def attr(self, arg_name: str, key: int, name: str):
        arg_cls, table = self.spec.args[arg_name]
        if name in arg_cls._inputs:
            row = table._engine_table.store.get(key)
            if row is None:
                raise KeyError(
                    f"transformer {arg_name}[{key:#x}]: row not found"
                )
            engine_col = table._column_mapping[name]
            idx = table._engine_table.column_names.index(engine_col)
            return row[idx]
        comp = arg_cls._computed.get(name)
        if comp is None:
            raise AttributeError(
                f"transformer arg {arg_name!r} has no attribute {name!r}"
            )
        if comp.is_method:
            return _BoundMethod(self.spec, arg_name, key, name, comp.fn)
        view = _RowView(self, arg_name, key)
        memo_key = (arg_name, key, name)
        if memo_key in self.memo:
            return self.memo[memo_key]
        if memo_key in self.in_progress:
            raise RecursionError(
                f"cyclic attribute dependency at {arg_name}.{name}[{key:#x}]"
            )
        self.in_progress.add(memo_key)
        try:
            value = comp.fn(view)
        finally:
            self.in_progress.discard(memo_key)
        self.memo[memo_key] = value
        return value


class _BoundTransformer:
    def __init__(self, args: Dict[str, Tuple[type, Any]]):
        self.args = args


class _BoundMethod:
    """A materialised ``@pw.method`` cell: identity-comparable (so unchanged
    rows don't re-emit every tick) and evaluated lazily against the CURRENT
    table state when called."""

    __slots__ = ("_spec", "_arg", "_key", "_name", "_fn")

    def __init__(self, spec, arg, key, name, fn):
        self._spec = spec
        self._arg = arg
        self._key = key
        self._name = name
        self._fn = fn

    def __call__(self, *args, **kwargs):
        evaluator = _Evaluator(self._spec)
        view = _RowView(evaluator, self._arg, self._key)
        return self._fn(view, *args, **kwargs)

    def __eq__(self, other):
        return (
            isinstance(other, _BoundMethod)
            and self._arg == other._arg
            and self._key == other._key
            and self._name == other._name
        )

    def __hash__(self):
        return hash((self._arg, self._key, self._name))

    def __repr__(self):  # pragma: no cover
        return f"<method {self._arg}.{self._name}[{self._key:#x}]>"


class _RowTransformerOperator(EngineOperator):
    """Multi-output: recomputes every output attribute at tick end and emits
    diffs vs the previous outputs (conservative but exact — any upstream
    change may affect any row through pointer chains)."""

    def __init__(self, bound: _BoundTransformer, outputs: Dict[str, Any]):
        inputs = [t._engine_table for _, t in bound.args.values()]
        super().__init__(inputs, None, "row_transformer")
        self.bound = bound
        self.outputs = outputs  # arg name -> output EngineTable
        self._dirty = False

    def process(self, port: int, delta: Delta, ts: int):
        if delta.n:
            self._dirty = True
        return None

    def on_tick_end(self, ts: int) -> Optional[list]:
        if not self._dirty:
            return None
        self._dirty = False
        evaluator = _Evaluator(self.bound)
        emissions = []
        for arg_name, (arg_cls, table) in self.bound.args.items():
            out_et = self.outputs.get(arg_name)
            if out_et is None:
                continue
            out_cols = out_et.column_names
            target: Dict[int, tuple] = {}
            for key in list(table._engine_table.store._rows.keys()):
                values = []
                for col in out_cols:
                    values.append(evaluator.attr(arg_name, key, col))
                target[key] = tuple(values)
            current = {k: tuple(r) for k, r in out_et.store.items()}
            rows: List[Tuple[int, int, tuple]] = []
            for key, row in current.items():
                if key not in target or not rows_equal(target[key], row):
                    rows.append((key, -1, row))
            for key, row in target.items():
                old = current.get(key)
                if old is None or not rows_equal(old, row):
                    rows.append((key, 1, row))
            if rows:
                emissions.append((out_et, Delta.from_rows(out_cols, rows)))
        return emissions or None


class RowTransformer:
    def __init__(self, cls: type):
        self.cls = cls
        self.arg_classes = {
            name: value
            for name, value in vars(cls).items()
            if isinstance(value, type) and issubclass(value, ClassArg)
        }
        functools.update_wrapper(self, cls, updated=())

    def __call__(self, *tables, **named_tables):
        from .table import Table

        names = list(self.arg_classes.keys())
        binding: Dict[str, Tuple[type, Any]] = {}
        for i, t in enumerate(tables):
            binding[names[i]] = (self.arg_classes[names[i]], t)
        for name, t in named_tables.items():
            binding[name] = (self.arg_classes[name], t)
        bound = _BoundTransformer(binding)

        result = _Namespace()
        outputs = {}
        for arg_name, (arg_cls, table) in binding.items():
            out_attrs = [
                a.name
                for a in arg_cls._computed.values()
                if a.is_output and not a.is_method
            ]
            method_attrs = [
                a.name for a in arg_cls._computed.values() if a.is_method
            ]
            cols = out_attrs + method_attrs
            if not cols:
                continue
            et = G.engine_graph.add_table(cols, f"transform_{arg_name}")
            outputs[arg_name] = et
            dtypes = {c: dt.ANY for c in cols}
            if arg_cls._output_schema is not None:
                hints = arg_cls._output_schema.typehints()
                for c in cols:
                    if c in hints:
                        dtypes[c] = dt.wrap(hints[c])
            setattr(
                result,
                arg_name,
                Table(et, dtypes, Universe(), short_name=f"transform_{arg_name}"),
            )
        G.engine_graph.add_operator(_RowTransformerOperator(bound, outputs))
        return result


def transformer(cls: type) -> RowTransformer:
    """Class decorator (reference pw.transformer)."""
    return RowTransformer(cls)
