"""Static dtype inference over expression trees
(reference: python/pathway/internals/type_interpreter.py — full bidirectional
typechecking; here a pragmatic forward pass used for output schemas)."""

from __future__ import annotations

import operator
from typing import Any, Dict, Mapping

from . import dtype as dt
from . import expression as expr_mod

__all__ = ["infer_dtype"]

_ARITH = {operator.add, operator.sub, operator.mul, operator.pow}
_COMPARE = {operator.eq, operator.ne, operator.lt, operator.le, operator.gt, operator.ge}
_BOOL = {operator.and_, operator.or_, operator.xor}


def infer_dtype(expr: Any, env: Mapping[int, Mapping[str, dt.DType]]) -> dt.DType:
    """env: id(table) -> {column: dtype}"""
    e = expr_mod
    if isinstance(expr, e.ColumnReference):
        table_types = env.get(id(expr.table))
        if table_types is not None and expr.name in table_types:
            return table_types[expr.name]
        return dt.ANY
    if isinstance(expr, e.IdExpression):
        return dt.POINTER
    if isinstance(expr, e.ColumnConstExpression):
        return dt.dtype_of_value(expr._value)
    if isinstance(expr, e.PointerExpression):
        return dt.POINTER
    if isinstance(expr, (e.CastExpression, e.ConvertExpression)):
        return expr._target
    if isinstance(expr, (e.IsNoneExpression, e.IsNotNoneExpression)):
        return dt.BOOL
    if isinstance(expr, e.FillErrorExpression):
        return dt.types_lca(
            infer_dtype(expr._expr, env), infer_dtype(expr._replacement, env)
        )
    if isinstance(expr, e.IfElseExpression):
        return dt.types_lca(
            infer_dtype(expr._then, env), infer_dtype(expr._else, env)
        )
    if isinstance(expr, e.CoalesceExpression):
        out = dt.NONE
        for a in expr._args:
            out = dt.types_lca(out, infer_dtype(a, env))
        return dt.unoptionalize(out)
    if isinstance(expr, e.ApplyExpression):
        return expr._return_type
    if isinstance(expr, e.MethodCallExpression):
        return expr._return_type
    if isinstance(expr, e.MakeTupleExpression):
        return dt.Tuple_(tuple(infer_dtype(a, env) for a in expr._args))
    if isinstance(expr, e.GetExpression):
        return dt.ANY
    if isinstance(expr, e.ColumnUnaryOpExpression):
        if expr._op is operator.not_:
            return dt.BOOL
        return infer_dtype(expr._expr, env)
    if isinstance(expr, e.ColumnBinaryOpExpression):
        op = expr._op
        if op in _COMPARE:
            return dt.BOOL
        lt = infer_dtype(expr._left, env)
        rt = infer_dtype(expr._right, env)
        if op in _BOOL:
            return dt.BOOL if lt is dt.BOOL and rt is dt.BOOL else dt.types_lca(lt, rt)
        if op is operator.truediv:
            return dt.FLOAT
        if op in (operator.floordiv, operator.mod):
            return dt.types_lca(lt, rt)
        if op is operator.matmul:
            return dt.types_lca(lt, rt)
        if op in _ARITH:
            if lt is dt.STR or rt is dt.STR:
                return dt.STR
            return dt.types_lca(lt, rt)
        return dt.ANY
    return dt.ANY
