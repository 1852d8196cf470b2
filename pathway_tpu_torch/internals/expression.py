"""Lazy column expressions.

The user-facing expression tree (reference:
python/pathway/internals/expression.py) — built by operating on
``table.col`` / ``pw.this.col`` references — evaluated here *columnar-vectorized*
over micro-batches instead of the reference's per-row interpreter
(src/engine/expression.rs:26-325).  Dense numeric columns evaluate as numpy array
ops; object columns fall back to a per-row loop.  A batched UDF may
return a ``torch.Tensor`` (a CUDA one included); it comes to host here.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtype as dt

__all__ = [
    "ColumnExpression",
    "ColumnReference",
    "ColumnConstExpression",
    "ColumnBinaryOpExpression",
    "ColumnUnaryOpExpression",
    "ApplyExpression",
    "AsyncApplyExpression",
    "IfElseExpression",
    "IsNoneExpression",
    "IsNotNoneExpression",
    "CastExpression",
    "ConvertExpression",
    "CoalesceExpression",
    "RequireExpression",
    "PointerExpression",
    "ReducerExpression",
    "MakeTupleExpression",
    "GetExpression",
    "MethodCallExpression",
    "IdExpression",
    "smart_coerce",
]


class ColumnExpression:
    """Base of the expression tree."""

    _deps: Tuple["ColumnExpression", ...] = ()

    # -- operator overloads ------------------------------------------------
    def _bin(self, other, op, symbol, reflected=False):
        other = smart_coerce(other)
        if reflected:
            return ColumnBinaryOpExpression(other, self, op, symbol)
        return ColumnBinaryOpExpression(self, other, op, symbol)

    def __add__(self, other):
        return self._bin(other, operator.add, "+")

    def __radd__(self, other):
        return self._bin(other, operator.add, "+", True)

    def __sub__(self, other):
        return self._bin(other, operator.sub, "-")

    def __rsub__(self, other):
        return self._bin(other, operator.sub, "-", True)

    def __mul__(self, other):
        return self._bin(other, operator.mul, "*")

    def __rmul__(self, other):
        return self._bin(other, operator.mul, "*", True)

    def __truediv__(self, other):
        return self._bin(other, operator.truediv, "/")

    def __rtruediv__(self, other):
        return self._bin(other, operator.truediv, "/", True)

    def __floordiv__(self, other):
        return self._bin(other, operator.floordiv, "//")

    def __rfloordiv__(self, other):
        return self._bin(other, operator.floordiv, "//", True)

    def __mod__(self, other):
        return self._bin(other, operator.mod, "%")

    def __rmod__(self, other):
        return self._bin(other, operator.mod, "%", True)

    def __pow__(self, other):
        return self._bin(other, operator.pow, "**")

    def __rpow__(self, other):
        return self._bin(other, operator.pow, "**", True)

    def __matmul__(self, other):
        return self._bin(other, operator.matmul, "@")

    def __rmatmul__(self, other):
        return self._bin(other, operator.matmul, "@", True)

    def __and__(self, other):
        return self._bin(other, operator.and_, "&")

    def __rand__(self, other):
        return self._bin(other, operator.and_, "&", True)

    def __or__(self, other):
        return self._bin(other, operator.or_, "|")

    def __ror__(self, other):
        return self._bin(other, operator.or_, "|", True)

    def __xor__(self, other):
        return self._bin(other, operator.xor, "^")

    def __rxor__(self, other):
        return self._bin(other, operator.xor, "^", True)

    def __eq__(self, other):  # type: ignore[override]
        return self._bin(other, operator.eq, "==")

    def __ne__(self, other):  # type: ignore[override]
        return self._bin(other, operator.ne, "!=")

    def __lt__(self, other):
        return self._bin(other, operator.lt, "<")

    def __le__(self, other):
        return self._bin(other, operator.le, "<=")

    def __gt__(self, other):
        return self._bin(other, operator.gt, ">")

    def __ge__(self, other):
        return self._bin(other, operator.ge, ">=")

    def __neg__(self):
        return ColumnUnaryOpExpression(self, operator.neg, "-")

    def __invert__(self):
        return ColumnUnaryOpExpression(self, operator.not_, "~")

    def __abs__(self):
        return ColumnUnaryOpExpression(self, operator.abs, "abs")

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise TypeError(
            "ColumnExpression is lazy and cannot be used as a bool; "
            "use &, |, ~ instead of and/or/not"
        )

    # -- convenience methods ----------------------------------------------
    def is_none(self) -> "IsNoneExpression":
        return IsNoneExpression(self)

    def is_not_none(self) -> "IsNotNoneExpression":
        return IsNotNoneExpression(self)

    def get(self, index, default=None) -> "GetExpression":
        return GetExpression(self, smart_coerce(index), smart_coerce(default), check=True)

    def __getitem__(self, index) -> "GetExpression":
        return GetExpression(self, smart_coerce(index), None, check=False)

    def to_string(self) -> "MethodCallExpression":
        return MethodCallExpression(
            "to_string", (self,), lambda v: "" if v is None else str(v), dt.STR
        )

    def as_int(self):
        return ConvertExpression(self, dt.INT)

    def as_float(self):
        return ConvertExpression(self, dt.FLOAT)

    def as_str(self):
        return ConvertExpression(self, dt.STR)

    def as_bool(self):
        return ConvertExpression(self, dt.BOOL)

    # namespaces (populated in expressions/ modules)
    @property
    def dt(self):
        from .expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from .expressions.string import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from .expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    # -- evaluation --------------------------------------------------------
    def _eval(self, ctx: "EvalContext") -> np.ndarray:
        raise NotImplementedError

    @property
    def _dependencies(self) -> Iterable["ColumnExpression"]:
        return self._deps

    def _column_refs(self) -> Iterable["ColumnReference"]:
        """All ColumnReferences in the tree."""
        if isinstance(self, ColumnReference):
            yield self
        for dep in self._deps:
            if dep is not None:
                yield from dep._column_refs()


class EvalContext:
    """Columns of the current micro-batch being evaluated.

    ``columns`` maps (table_id, column_name) → np array of row values;
    ``keys`` is the row-key vector; ``n`` the number of rows."""

    def __init__(self, columns: Mapping[Tuple[int, str], np.ndarray], keys: np.ndarray):
        self.columns = columns
        self.keys = keys
        self.n = len(keys)

    def lookup(self, table_id: int, name: str) -> np.ndarray:
        return self.columns[(table_id, name)]


def smart_coerce(value: Any) -> Any:
    if isinstance(value, ColumnExpression) or value is None:
        return value
    return ColumnConstExpression(value)


def _is_object(arr: np.ndarray) -> bool:
    return arr.dtype == object


def _rowwise(fn, *arrays, n: int, trace=None) -> np.ndarray:
    """Per-row loop with reference error semantics: a failing row yields an
    Error cell instead of aborting the batch (Value::Error,
    /root/reference/src/engine/value.rs:225).  ``trace`` (the expression's
    build-site user frame) flows into the Error message and the error log."""
    from .error_value import ERROR, Error, is_error

    out = np.empty(n, dtype=object)
    for i in range(n):
        args = tuple(a[i] for a in arrays)
        if any(is_error(a) for a in args):
            out[i] = ERROR
            continue
        try:
            out[i] = fn(*args)
        except Exception as e:
            from .error_log import log_error

            message = f"{type(e).__name__}: {e}"
            if trace is not None:
                message = f"{message} (expression built at {trace})"
            log_error(message, operator="expression", trace=trace)
            out[i] = Error(message)
    return out


class ColumnReference(ColumnExpression):
    """Reference to ``table.column_name``."""

    def __init__(self, table, name: str):
        self._table = table
        self._name = name

    @property
    def table(self):
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"<{getattr(self._table, '_short_name', 'table')}.{self._name}>"

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        return ctx.lookup(id(self._table), self._name)


class IdExpression(ColumnExpression):
    """``table.id`` — the key column.  In contexts that carry per-side row
    ids under the ``__id__`` pseudo-column (join selects: the joined output
    has its own keys, but ``left.id``/``right.id`` must mean the *side's*
    row ids), the bound table's entry wins over the ambient keys."""

    def __init__(self, table):
        self._table = table

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        side = ctx.columns.get((id(self._table), "__id__"))
        if side is not None:
            return side
        return ctx.keys


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value

    def __repr__(self):
        return f"const({self._value!r})"

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        v = self._value
        npdt = dt.numpy_dtype_for(dt.dtype_of_value(v))
        if npdt is not None:
            return np.full(ctx.n, v, dtype=npdt)
        out = np.empty(ctx.n, dtype=object)
        out[:] = [v] * ctx.n
        return out


_FLOAT_DIV_OPS = {operator.truediv}


class ColumnBinaryOpExpression(ColumnExpression):
    def __init__(self, left, right, op, symbol: str):
        from .trace import trace_user_frame

        self._left = smart_coerce(left)
        self._right = smart_coerce(right)
        self._op = op
        self._symbol = symbol
        self._deps = (self._left, self._right)
        self._trace = trace_user_frame()

    def __repr__(self):
        return f"({self._left!r} {self._symbol} {self._right!r})"

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        l = self._left._eval(ctx)
        r = self._right._eval(ctx)
        op = self._op
        if _is_object(l) or _is_object(r):
            if op in (operator.and_, operator.or_):
                # python bools use and/or semantics on object columns
                pyop = (lambda a, b: a and b) if op is operator.and_ else (lambda a, b: a or b)
                return _rowwise(pyop, l, r, n=ctx.n, trace=self._trace)
            return _rowwise(op, l, r, n=ctx.n, trace=self._trace)
        try:
            if op is operator.floordiv and np.issubdtype(l.dtype, np.integer):
                if np.any(r == 0):
                    raise ZeroDivisionError("integer division by zero")
            if op is operator.mod and np.issubdtype(l.dtype, np.integer) and np.any(r == 0):
                raise ZeroDivisionError("integer modulo by zero")
            return op(l, r)
        except TypeError:
            return _rowwise(op, l, r, n=ctx.n, trace=self._trace)


class ColumnUnaryOpExpression(ColumnExpression):
    def __init__(self, expr, op, symbol: str):
        from .trace import trace_user_frame

        self._expr = smart_coerce(expr)
        self._op = op
        self._symbol = symbol
        self._deps = (self._expr,)
        self._trace = trace_user_frame()

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        v = self._expr._eval(ctx)
        if self._op is operator.not_:
            if _is_object(v):
                return _rowwise(lambda x: not x, v, n=ctx.n, trace=self._trace)
            return ~v.astype(bool)
        if _is_object(v):
            return _rowwise(self._op, v, n=ctx.n, trace=self._trace)
        return self._op(v)


class ApplyExpression(ColumnExpression):
    """Per-row python function application (``pw.apply`` / sync UDF).

    ``batched=True`` functions receive whole column arrays at once — the
    idiomatic form for on-device ML UDFs."""

    def __init__(
        self,
        fun: Callable,
        return_type: Any,
        args: Sequence[Any] = (),
        kwargs: Mapping[str, Any] | None = None,
        batched: bool = False,
        propagate_none: bool = False,
    ):
        self._fun = fun
        self._return_type = dt.wrap(return_type) if return_type is not None else dt.ANY
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = {k: smart_coerce(v) for k, v in (kwargs or {}).items()}
        self._batched = batched
        self._propagate_none = propagate_none
        self._deps = self._args + tuple(self._kwargs.values())
        # user frame of the apply/udf call site — failing rows name this line
        # (reference: trace.py frames attached per expression)
        from .trace import trace_user_frame

        self._trace = trace_user_frame()

    def _row_error(self, exc: Exception, op_id: int | None = None):
        from .error_log import log_error
        from .error_value import Error

        fn_name = getattr(self._fun, "__name__", "<udf>")
        loc = f" (udf {fn_name} applied at {self._trace})" if self._trace else ""
        message = f"{type(exc).__name__}: {exc}{loc}"
        log_error(message, operator="apply", trace=self._trace, op_id=op_id)
        return Error(message)

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        arg_arrays = [a._eval(ctx) for a in self._args]
        kwarg_arrays = {k: v._eval(ctx) for k, v in self._kwargs.items()}
        if self._batched:
            result = self._fun(*arg_arrays, **kwarg_arrays)
            if isinstance(result, torch.Tensor):
                # a CUDA tensor comes to host explicitly: np.asarray of one fails
                result = result.detach().cpu().numpy()
            if not isinstance(result, np.ndarray):
                result = np.asarray(result)
            if result.ndim > 1:
                # batched fn returned [B, ...]: column cells are row slices
                out = np.empty(result.shape[0], dtype=object)
                for i in range(result.shape[0]):
                    out[i] = result[i]
                return out
            return result
        from .error_value import ERROR, Error, is_error

        npdt = dt.numpy_dtype_for(self._return_type)
        out = np.empty(ctx.n, dtype=npdt if npdt is not None else object)
        errored = False
        for i in range(ctx.n):
            args_i = [a[i] for a in arg_arrays]
            kwargs_i = {k: v[i] for k, v in kwarg_arrays.items()}
            if self._propagate_none and (
                any(a is None for a in args_i) or any(v is None for v in kwargs_i.values())
            ):
                out[i] = None
            elif any(is_error(a) for a in args_i):
                errored = True
                if out.dtype == object:
                    out[i] = ERROR
            else:
                try:
                    out[i] = self._fun(*args_i, **kwargs_i)
                except Exception as e:
                    errored = True
                    if out.dtype == object:
                        out[i] = self._row_error(e)
                    else:
                        out[i] = 0
        if errored and out.dtype != object:
            # re-run into an object column so Error cells survive
            out2 = np.empty(ctx.n, dtype=object)
            for i in range(ctx.n):
                args_i = [a[i] for a in arg_arrays]
                kwargs_i = {k: v[i] for k, v in kwarg_arrays.items()}
                if any(is_error(a) for a in args_i):
                    out2[i] = ERROR
                    continue
                try:
                    out2[i] = self._fun(*args_i, **kwargs_i)
                except Exception as e:
                    out2[i] = self._row_error(e)
            return out2
        return out


class AsyncApplyExpression(ApplyExpression):
    """Marker subclass: ``fun`` is a coroutine function, executed on the host
    event loop off the device path (reference async_apply_table,
    src/python_api.rs:2476)."""

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        import asyncio

        from .error_value import ERROR, is_error

        arg_arrays = [a._eval(ctx) for a in self._args]
        kwarg_arrays = {k: v._eval(ctx) for k, v in self._kwargs.items()}
        out = np.empty(ctx.n, dtype=object)
        # mirror the sync path's input handling: Error inputs propagate as
        # ERROR without invoking the UDF; None propagates when requested
        run_rows = []
        for i in range(ctx.n):
            args_i = [a[i] for a in arg_arrays]
            kwargs_i = {k: v[i] for k, v in kwarg_arrays.items()}
            if any(is_error(a) for a in args_i) or any(
                is_error(v) for v in kwargs_i.values()
            ):
                out[i] = ERROR
            elif self._propagate_none and (
                any(a is None for a in args_i)
                or any(v is None for v in kwargs_i.values())
            ):
                out[i] = None
            else:
                run_rows.append((i, args_i, kwargs_i))

        async def run_all():
            coros = [
                self._fun(*args_i, **kwargs_i) for _, args_i, kwargs_i in run_rows
            ]
            return await asyncio.gather(*coros, return_exceptions=True)

        if run_rows:
            # operator identity captured BEFORE dispatch: completions may be
            # handled off the engine thread, where the thread-local is unset
            from .error_log import current_operator_id

            op_id = current_operator_id()
            results = asyncio.run(run_all())
            for (i, _, _), r in zip(run_rows, results):
                if isinstance(r, Exception):
                    out[i] = self._row_error(r, op_id=op_id)
                elif isinstance(r, BaseException):
                    raise r  # cancellation/system exit must not become data
                else:
                    out[i] = r
        return out


class IfElseExpression(ColumnExpression):
    def __init__(self, if_, then, else_):
        from .trace import trace_user_frame

        def branch(v):
            # None is a legitimate branch VALUE here (smart_coerce treats it
            # as "absent" elsewhere)
            return ColumnConstExpression(None) if v is None else smart_coerce(v)

        self._if = branch(if_)
        self._then = branch(then)
        self._else = branch(else_)
        self._deps = (self._if, self._then, self._else)
        self._trace = trace_user_frame()

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        c = self._if._eval(ctx)
        t = self._then._eval(ctx)
        e = self._else._eval(ctx)
        if _is_object(t) or _is_object(e) or _is_object(c):
            return _rowwise(
                lambda ci, ti, ei: ti if ci else ei,
                c, t, e, n=ctx.n, trace=self._trace,
            )
        return np.where(c.astype(bool), t, e)


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr):
        self._expr = smart_coerce(expr)
        self._deps = (self._expr,)

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        v = self._expr._eval(ctx)
        if _is_object(v):
            return np.array([x is None for x in v], dtype=bool)
        return np.zeros(ctx.n, dtype=bool)


class IsNotNoneExpression(IsNoneExpression):
    def _eval(self, ctx: EvalContext) -> np.ndarray:
        return ~super()._eval(ctx)


class CastExpression(ColumnExpression):
    def __init__(self, expr, target: Any):
        self._expr = smart_coerce(expr)
        self._target = dt.wrap(target)
        self._deps = (self._expr,)

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        v = self._expr._eval(ctx)
        npdt = dt.numpy_dtype_for(self._target)
        if npdt is not None and not _is_object(v):
            return v.astype(npdt)
        if npdt is not None:
            caster = {dt.INT: int, dt.FLOAT: float, dt.BOOL: bool}.get(
                dt.unoptionalize(self._target)
            )
            if caster is not None:
                return np.array([None if x is None else caster(x) for x in v], dtype=object)
        return v


class DeclareTypeExpression(CastExpression):
    """``pw.declare_type`` — retypes the column in the schema only; values
    pass through untouched (reference internals/common.py:215)."""

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        return self._expr._eval(ctx)


class FillErrorExpression(ColumnExpression):
    """``pw.fill_error(col, replacement)`` — Error cells replaced per row
    (reference internals/common.py:438; Value::Error, src/engine/value.rs:225)."""

    def __init__(self, expr, replacement):
        self._expr = smart_coerce(expr)
        self._replacement = smart_coerce(replacement)
        self._deps = (self._expr, self._replacement)

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        from .error_value import is_error

        v = self._expr._eval(ctx)
        if not _is_object(v):
            return v
        if not any(is_error(x) for x in v):
            return v
        r = self._replacement._eval(ctx)
        out = v.copy()
        for i in range(ctx.n):
            if is_error(out[i]):
                out[i] = r[i]
        return out


class ConvertExpression(CastExpression):
    """Value conversion (e.g. Json → typed), reference `.as_int()` etc."""

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        v = self._expr._eval(ctx)
        target = dt.unoptionalize(self._target)
        caster = {dt.INT: int, dt.FLOAT: float, dt.BOOL: bool, dt.STR: str}.get(target)
        if caster is None:
            return v
        if not _is_object(v):
            npdt = dt.numpy_dtype_for(target)
            return v.astype(npdt) if npdt is not None else v
        return np.array(
            [None if x is None else caster(x) for x in v], dtype=object
        )


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args):
        self._args = tuple(
            ColumnConstExpression(None) if a is None else smart_coerce(a) for a in args
        )
        self._deps = self._args

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        arrays = [a._eval(ctx) for a in self._args]
        out = np.empty(ctx.n, dtype=object)
        for i in range(ctx.n):
            val = None
            for a in arrays:
                if a[i] is not None:
                    val = a[i]
                    break
            out[i] = val
        if all(not _is_object(a) for a in arrays):
            return arrays[0]
        return out


class RequireExpression(ColumnExpression):
    def __init__(self, val, *args):
        self._val = smart_coerce(val)
        self._args = tuple(smart_coerce(a) for a in args)
        self._deps = (self._val,) + self._args

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        arrays = [a._eval(ctx) for a in self._args]
        v = self._val._eval(ctx)
        out = np.empty(ctx.n, dtype=object)
        for i in range(ctx.n):
            out[i] = None if any(a[i] is None for a in arrays) else v[i]
        return out


class PointerExpression(ColumnExpression):
    """``table.pointer_from(*cols)`` — key derivation expression."""

    def __init__(self, table, *args, instance=None, optional: bool = False):
        self._table = table
        self._args = tuple(smart_coerce(a) for a in args)
        self._instance = smart_coerce(instance) if instance is not None else None
        self._optional = optional
        self._deps = self._args + ((self._instance,) if self._instance is not None else ())

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        from . import keys as keymod

        arrays = [a._eval(ctx) for a in self._args]
        if self._instance is not None:
            arrays = [self._instance._eval(ctx)] + arrays
        return keymod.ref_scalars_batch(arrays) if arrays else keymod.sequential_keys(0, ctx.n)


class ReducerExpression(ColumnExpression):
    """A reducer applied inside groupby().reduce(...) — evaluated by the
    grouped operator, not row-wise (engine/operators/groupby.py)."""

    def __init__(self, reducer, *args, **kwargs):
        self._reducer = reducer
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = kwargs
        self._deps = self._args

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        raise RuntimeError(
            f"reducer {self._reducer} can only be used inside groupby(...).reduce(...)"
        )


def collect_reducers(expr) -> list:
    """All ReducerExpression nodes inside ``expr`` (not descending into
    them) — compound reduce outputs like ``sum(x) / count()`` contain several
    (reference: such expressions are legal reduce outputs,
    internals/groupbys.py)."""
    found: list = []

    def walk(e):
        if isinstance(e, ReducerExpression):
            found.append(e)
            return
        if isinstance(e, ColumnExpression):
            for d in e._deps:
                walk(d)

    walk(expr)
    return found


def expr_equal(a, b) -> bool:
    """Structural equality of expression trees (same node classes, same
    table/name for references, same constants, same children) — used to
    recognize a reduce output that RE-STATES a grouping expression
    (``groupby(t.a % 2).reduce(parity=t.a % 2)``)."""
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    if not isinstance(a, ColumnExpression):
        return a == b
    if isinstance(a, ColumnReference):
        return a._table is b._table and a._name == b._name
    if isinstance(a, ColumnConstExpression):
        return type(a._value) is type(b._value) and a._value == b._value
    if len(a._deps) != len(b._deps):
        return False
    for attr, val in vars(a).items():
        other = getattr(b, attr, None)
        if isinstance(val, ColumnExpression):
            if not expr_equal(val, other):
                return False
        elif isinstance(val, tuple):
            if not isinstance(other, tuple) or len(val) != len(other):
                return False
            for x, y in zip(val, other):
                if isinstance(x, ColumnExpression):
                    if not expr_equal(x, y):
                        return False
                elif x != y:
                    return False
        elif callable(val):
            if val is not other:
                return False
        elif isinstance(val, (str, int, float, bool, type(None))):
            if val != other:
                return False
    return True


def substitute(expr, mapping: dict):
    """Clone ``expr`` with nodes replaced per ``mapping`` (id(node) ->
    replacement expression).  Rewrites every expression-valued attribute
    (including the ``_deps`` mirror) on shallow copies, so arbitrary node
    classes survive without per-class cases."""
    import copy as _copy

    def walk(e):
        if not isinstance(e, ColumnExpression):
            return e
        if id(e) in mapping:
            return mapping[id(e)]
        if not e._deps:
            return e
        clone = _copy.copy(e)
        for attr, val in vars(e).items():
            if isinstance(val, ColumnExpression):
                setattr(clone, attr, walk(val))
            elif isinstance(val, tuple) and any(
                isinstance(v, ColumnExpression) for v in val
            ):
                setattr(
                    clone,
                    attr,
                    tuple(
                        walk(v) if isinstance(v, ColumnExpression) else v
                        for v in val
                    ),
                )
            elif isinstance(val, dict) and any(
                isinstance(v, ColumnExpression) for v in val.values()
            ):
                setattr(
                    clone,
                    attr,
                    {
                        k: walk(v) if isinstance(v, ColumnExpression) else v
                        for k, v in val.items()
                    },
                )
        return clone

    return walk(expr)


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args):
        self._args = tuple(smart_coerce(a) for a in args)
        self._deps = self._args

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        arrays = [a._eval(ctx) for a in self._args]
        out = np.empty(ctx.n, dtype=object)
        for i in range(ctx.n):
            out[i] = tuple(a[i] for a in arrays)
        return out


class GetExpression(ColumnExpression):
    def __init__(self, obj, index, default=None, check: bool = False):
        self._obj = smart_coerce(obj)
        self._index = smart_coerce(index)
        self._default = smart_coerce(default) if default is not None else None
        self._check = check
        self._deps = tuple(
            d for d in (self._obj, self._index, self._default) if d is not None
        )

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        obj = self._obj._eval(ctx)
        idx = self._index._eval(ctx)
        dfl = self._default._eval(ctx) if self._default is not None else None
        out = np.empty(ctx.n, dtype=object)
        for i in range(ctx.n):
            o, j = obj[i], idx[i]
            try:
                if isinstance(o, dict):
                    out[i] = o.get(j) if self._check else o[j]
                    if out[i] is None and self._check and dfl is not None:
                        out[i] = dfl[i] if j not in o else o[j]
                elif o is None:
                    if self._check:
                        out[i] = dfl[i] if dfl is not None else None
                    else:
                        raise TypeError("cannot index None")
                else:
                    out[i] = o[j]
            except (KeyError, IndexError, TypeError):
                if self._check:
                    out[i] = dfl[i] if dfl is not None else None
                else:
                    raise
        return out


class MethodCallExpression(ColumnExpression):
    """A namespaced method on an expression (``x.dt.hour()``, ``x.str.upper()``).

    ``fun`` receives scalar(s); ``vector_fun`` — if given — receives the whole
    array (vectorized path)."""

    def __init__(
        self,
        name: str,
        args: Sequence[Any],
        fun: Callable,
        return_type: Any = None,
        vector_fun: Optional[Callable] = None,
    ):
        from .trace import trace_user_frame

        self._method_name = name
        self._args = tuple(smart_coerce(a) for a in args)
        self._fun = fun
        self._vector_fun = vector_fun
        self._return_type = dt.wrap(return_type) if return_type is not None else dt.ANY
        self._deps = self._args
        self._trace = trace_user_frame()

    def _eval(self, ctx: EvalContext) -> np.ndarray:
        arrays = [a._eval(ctx) for a in self._args]
        if self._vector_fun is not None:
            try:
                return np.asarray(self._vector_fun(*arrays))
            except Exception:
                pass
        npdt = dt.numpy_dtype_for(self._return_type)
        try:
            out = np.empty(ctx.n, dtype=npdt if npdt is not None else object)
            for i in range(ctx.n):
                out[i] = self._fun(*(a[i] for a in arrays))
            return out
        except Exception:
            return _rowwise(self._fun, *arrays, n=ctx.n, trace=self._trace)
