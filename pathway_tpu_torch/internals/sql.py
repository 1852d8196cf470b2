"""``pw.sql`` of the port — SQL queries over tables (counterpart of
``pathway_tpu/internals/sql.py``;
reference: python/pathway/internals/sql.py:726, built on sqlglot; sqlglot is
not available here, so this is a self-contained recursive-descent parser).

Supported, mirroring the reference's documented subset (sql.py:640-668):
projections, WHERE, arithmetic/boolean expressions, GROUP BY, HAVING,
aliases, JOIN … ON, UNION [ALL], INTERSECT, EXCEPT, WITH (CTEs), subqueries
in FROM, and scalar aggregate subqueries in expressions; aggregates
SUM/COUNT/MIN/MAX/AVG.

Beyond the reference (which lists ORDER BY / LIMIT as unsupported,
sql.py:661): ORDER BY … [ASC|DESC] with LIMIT/OFFSET is supported here,
maintained incrementally as a global sorted reduce + flatten (top-k under
streaming updates — rows enter and leave the LIMIT window as the data
changes)."""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from . import api_reducers as reducers
from .expression import ColumnExpression, ColumnReference, IfElseExpression, smart_coerce
from .table import JoinMode, Table

__all__ = ["sql"]

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>\d+\.\d+|\d+)"
    r"|(?P<str>'(?:[^']|'')*')"
    r"|(?P<id>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><>|!=|<=|>=|=|<|>|\*|/|\+|-|\(|\)|,|\.)"
    r")"
)

_KEYWORDS = {
    "select",
    "from",
    "where",
    "group",
    "by",
    "having",
    "as",
    "and",
    "or",
    "not",
    "join",
    "inner",
    "left",
    "right",
    "outer",
    "full",
    "on",
    "null",
    "true",
    "false",
    "case",
    "when",
    "then",
    "else",
    "end",
    "union",
    "all",
    "intersect",
    "except",
    "order",
    "limit",
    "offset",
    "asc",
    "desc",
    "with",
}

_AGGREGATES = {
    "sum": reducers.sum,
    "count": reducers.count,
    "min": reducers.min,
    "max": reducers.max,
    "avg": reducers.avg,
}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise ValueError(f"SQL syntax error near {text[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            tokens.append(("num", m.group("num")))
        elif m.lastgroup == "str":
            tokens.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.lastgroup == "id":
            word = m.group("id")
            tokens.append(
                ("kw", word.lower()) if word.lower() in _KEYWORDS else ("id", word)
            )
        else:
            tokens.append(("op", m.group("op")))
    tokens.append(("eof", ""))
    return tokens


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]], tables: Dict[str, Table]):
        self.tokens = tokens
        self.pos = 0
        self.tables = {k.lower(): v for k, v in tables.items()}
        self.scope: Dict[str, Table] = {}
        self.aggregates: List[Tuple[str, Any]] = []
        # scalar subqueries awaiting a cross-join onto the outer table
        self.pending_scalars: List[Tuple[str, Table]] = []
        # aggregates inside the current HAVING clause: compiled into hidden
        # reduce outputs the HAVING filter then references
        self.having_aggs: List[Any] = []
        self.in_having = False

    def _apply_pending_scalars(self, table: Table) -> Table:
        """Cross-join each pending scalar-subquery result (one global row)
        onto ``table`` as a broadcast column, so surrounding expressions can
        reference it like any other column."""
        while self.pending_scalars:
            col, sub = self.pending_scalars.pop(0)
            [sub_col] = sub.column_names
            # equality join on a shared constant = cross join with the
            # single-row aggregate (reference joins the rewritten subquery
            # on id, sql.py:514)
            lhs = table.with_columns(_sql_one=0)
            rhs = sub.select(_sql_one_r=0, **{col: sub[sub_col]})
            jr = lhs.join(
                rhs, lhs._sql_one == rhs._sql_one_r, how=JoinMode.LEFT
            )
            cols = {n: ColumnReference(lhs, n) for n in table.column_names}
            cols[col] = ColumnReference(rhs, col)
            table = jr.select(**cols)
        return table

    # token helpers
    def peek(self) -> Tuple[str, str]:
        return self.tokens[self.pos]

    def next(self) -> Tuple[str, str]:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[str]:
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.pos += 1
            return v
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> str:
        got = self.accept(kind, value)
        if got is None:
            raise ValueError(f"SQL: expected {value or kind}, got {self.peek()}")
        return got

    # grammar
    def parse_query(self) -> Table:
        """[WITH ...] select_statement {UNION [ALL] | INTERSECT | EXCEPT}..."""
        if self.accept("kw", "with"):
            # CTEs (reference _with_block, sql.py:290): each name is visible
            # to later CTEs and to the main query
            while True:
                name = self.expect("id").lower()
                self.expect("kw", "as")
                self.expect("op", "(")
                self.tables[name] = self.parse_query()
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        left = self.parse_select()
        while True:
            if self.accept("kw", "union"):
                keep_all = self.accept("kw", "all") is not None
                right = _align_columns(left, self.parse_select(), "UNION")
                combined = left.concat_reindex(right)
                left = combined if keep_all else _distinct(combined)
            elif self.accept("kw", "intersect"):
                # by-value set semantics: _distinct keys rows by their values
                # (group hash), so key ops become value ops
                right = _align_columns(left, self.parse_select(), "INTERSECT")
                left = _distinct(left).intersect(_distinct(right))
            elif self.accept("kw", "except"):
                right = _align_columns(left, self.parse_select(), "EXCEPT")
                left = _distinct(left).difference(_distinct(right))
            else:
                break
        # ORDER BY / LIMIT / OFFSET bind to the whole (possibly set-op
        # combined) query result, per standard SQL
        order_items: List[Tuple[Any, bool]] = []
        limit_n: Optional[int] = None
        offset_n = 0
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                key_fn = self.parse_expr_lazy()
                desc = False
                if self.accept("kw", "desc"):
                    desc = True
                else:
                    self.accept("kw", "asc")
                order_items.append((key_fn, desc))
                if not self.accept("op", ","):
                    break
        if self.accept("kw", "limit"):
            limit_n = int(self.expect("num"))
        if self.accept("kw", "offset"):
            offset_n = int(self.expect("num"))
        if order_items or limit_n is not None or offset_n:
            left = _order_limit(left, order_items, limit_n, offset_n)
        return left

    def parse_select(self) -> Table:
        # aggregate registry is PER SELECT: a subquery's aggregates must not
        # make the enclosing (or a following set-op) select aggregate too
        outer_aggregates = self.aggregates
        outer_having = self.having_aggs
        outer_scalars = self.pending_scalars
        self.aggregates = []
        self.having_aggs = []
        self.pending_scalars = []
        try:
            return self._parse_select_body()
        finally:
            self.aggregates = outer_aggregates
            self.having_aggs = outer_having
            self.pending_scalars = outer_scalars

    def _parse_select_body(self) -> Table:
        self.expect("kw", "select")
        projections: List[Tuple[Optional[str], Any, bool]] = []  # (alias, expr_fn, is_star)
        while True:
            if self.accept("op", "*"):
                projections.append((None, None, True))
            else:
                expr_fn = self.parse_expr_lazy()
                alias = None
                if self.accept("kw", "as"):
                    alias = self.expect("id")
                elif self.peek()[0] == "id" and self.tokens[self.pos + 1][1] in (",",) + ("",):
                    pass
                projections.append((alias, expr_fn, False))
            if not self.accept("op", ","):
                break
        self.expect("kw", "from")
        table = self.parse_table_source()

        if self.accept("kw", "where"):
            cond_fn = self.parse_expr_lazy()
            table = self._apply_pending_scalars(table)
            table = table.filter(cond_fn(table))
        else:
            table = self._apply_pending_scalars(table)

        group_exprs: List[Any] = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            while True:
                group_exprs.append(self.parse_expr_lazy())
                if not self.accept("op", ","):
                    break

        having_fn = None
        if self.accept("kw", "having"):
            self.in_having = True
            try:
                having_fn = self.parse_expr_lazy()
            finally:
                self.in_having = False
        # scalars registered by SELECT/WHERE were cross-joined above; any
        # still pending came from GROUP BY/HAVING, where they have no
        # application point
        if self.pending_scalars:
            raise NotImplementedError(
                "SQL: scalar subqueries are supported in the SELECT list and "
                "WHERE clause only (not GROUP BY/HAVING/ORDER BY)"
            )
        if having_fn is not None and not (
            group_exprs or self._has_aggregates(projections)
        ):
            raise ValueError(
                "SQL: HAVING requires GROUP BY or aggregate projections"
            )

        def finish(result: Table) -> Table:
            return result

        if group_exprs or self._has_aggregates(projections):
            grefs = [g(table) for g in group_exprs]
            grouped = table.groupby(*grefs) if grefs else table.groupby()
            out_kwargs: Dict[str, Any] = {}
            for i, (alias, expr_fn, is_star) in enumerate(projections):
                if is_star:
                    raise ValueError("SELECT * with GROUP BY is not supported")
                expr = expr_fn(table)
                name = alias or self._infer_name(expr, f"col_{i}")
                out_kwargs[name] = expr
            visible = list(out_kwargs.keys())
            for i, agg_fn in enumerate(self.having_aggs):
                out_kwargs[f"_hv{i}"] = agg_fn(table)
            result = grouped.reduce(**out_kwargs)
            if having_fn is not None:
                result = result.filter(having_fn(result))
                if self.having_aggs:
                    result = result.select(**{n: result[n] for n in visible})
            return finish(result)

        # plain projection (bare * must not leak internal _sq scalar cols)
        visible_cols = [n for n in table.column_names if not n.startswith("_sq")]
        if len(projections) == 1 and projections[0][2]:
            if len(visible_cols) != len(table.column_names):
                table = table.select(**{n: table[n] for n in visible_cols})
            return finish(table)
        out_kwargs = {}
        for i, (alias, expr_fn, is_star) in enumerate(projections):
            if is_star:
                for n in visible_cols:
                    out_kwargs[n] = table[n]
                continue
            expr = expr_fn(table)
            name = alias or self._infer_name(expr, f"col_{i}")
            out_kwargs[name] = expr
        return finish(table.select(**out_kwargs))

    def _has_aggregates(self, projections) -> bool:
        return bool(self.aggregates)

    def _infer_name(self, expr, default: str) -> str:
        if isinstance(expr, ColumnReference):
            return expr.name
        return default

    def _parse_one_table(self) -> Table:
        """table name [AS alias] | ( subquery ) [AS] alias
        (reference _table / _subquery, sql.py:308-330)."""
        if self.accept("op", "("):
            sub = self.parse_query()
            self.expect("op", ")")
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect("id").lower()
            elif self.peek()[0] == "id":
                alias = self.next()[1].lower()
            if alias:
                self.tables[alias] = sub
                self.scope[alias] = sub
            return sub
        name = self.expect("id").lower()
        if name not in self.tables:
            raise ValueError(f"SQL: unknown table {name!r}")
        table = self.tables[name]
        self.scope[name] = table
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("id").lower()
        if alias:
            self.tables[alias] = table
            self.scope[alias] = table
        return table

    def parse_table_source(self) -> Table:
        table = self._parse_one_table()
        # joins
        while True:
            how = None
            if self.accept("kw", "join") or (
                self.accept("kw", "inner") and self.expect("kw", "join")
            ):
                how = JoinMode.INNER
            elif self.accept("kw", "left"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                how = JoinMode.LEFT
            elif self.accept("kw", "right"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                how = JoinMode.RIGHT
            elif self.accept("kw", "full"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                how = JoinMode.OUTER
            else:
                break
            other = self._parse_one_table()
            self.expect("kw", "on")
            cond_fn = self.parse_expr_lazy()

            # build condition referencing both tables explicitly
            def resolver(col, tbl=table, oth=other):
                return col

            cond = cond_fn(table, other)
            jr = table.join(other, cond, how=how)
            cols = {}
            for n in table.column_names:
                cols[n] = ColumnReference(table, n)
            for n in other.column_names:
                if n not in cols:
                    cols[n] = ColumnReference(other, n)
            table = jr.select(**cols)
        return table

    # expressions --------------------------------------------------------
    def parse_expr_lazy(self):
        """Parse one expression into a closure (table, [other]) -> ColumnExpression."""
        node = self.parse_or()
        return node

    def parse_or(self):
        left = self.parse_and()
        while self.accept("kw", "or"):
            right = self.parse_and()
            left = _lift2(left, right, lambda a, b: a | b)
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept("kw", "and"):
            right = self.parse_not()
            left = _lift2(left, right, lambda a, b: a & b)
        return left

    def parse_not(self):
        if self.accept("kw", "not"):
            inner = self.parse_not()
            return _lift1(inner, lambda a: ~a)
        return self.parse_comparison()

    def parse_comparison(self):
        left = self.parse_additive()
        k, v = self.peek()
        if k == "op" and v in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            right = self.parse_additive()
            ops = {
                "=": lambda a, b: a == b,
                "<>": lambda a, b: a != b,
                "!=": lambda a, b: a != b,
                "<": lambda a, b: a < b,
                "<=": lambda a, b: a <= b,
                ">": lambda a, b: a > b,
                ">=": lambda a, b: a >= b,
            }
            return _lift2(left, right, ops[v])
        return left

    def parse_additive(self):
        left = self.parse_multiplicative()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                right = self.parse_multiplicative()
                if v == "+":
                    left = _lift2(left, right, lambda a, b: a + b)
                else:
                    left = _lift2(left, right, lambda a, b: a - b)
            else:
                return left

    def parse_multiplicative(self):
        left = self.parse_primary()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/"):
                self.next()
                right = self.parse_primary()
                if v == "*":
                    left = _lift2(left, right, lambda a, b: a * b)
                else:
                    left = _lift2(left, right, lambda a, b: a / b)
            else:
                return left

    def parse_primary(self):
        k, v = self.peek()
        if k == "num":
            self.next()
            value = float(v) if "." in v else int(v)
            return lambda *tables: smart_coerce(value)
        if k == "str":
            self.next()
            return lambda *tables: smart_coerce(v)
        if k == "kw" and v in ("null", "true", "false"):
            self.next()
            value = {"null": None, "true": True, "false": False}[v]
            return lambda *tables: smart_coerce(value)
        if k == "kw" and v == "case":
            return self.parse_case()
        if self.accept("op", "("):
            if self.peek() == ("kw", "select"):
                # scalar aggregate subquery: build its (single-row) table
                # now, cross-join it onto the outer table before the
                # surrounding WHERE/SELECT evaluates (reference rewrites
                # these via sqlglot + join on id, sql.py:505-514)
                sub = self.parse_query()
                self.expect("op", ")")
                if len(sub.column_names) != 1:
                    raise ValueError(
                        "SQL: scalar subquery must produce exactly one column"
                    )
                col = f"_sq{len(self.pending_scalars)}"
                self.pending_scalars.append((col, sub))
                return lambda *tables, _c=col: ColumnReference(tables[0], _c)
            inner = self.parse_or()
            self.expect("op", ")")
            return inner
        if k == "id":
            name = self.next()[1]
            # aggregate?
            if name.lower() in _AGGREGATES and self.peek() == ("op", "("):
                self.next()
                agg = _AGGREGATES[name.lower()]
                if self.accept("op", "*"):
                    self.expect("op", ")")
                    arg = None
                else:
                    arg = self.parse_or()
                    self.expect("op", ")")
                if self.in_having:
                    # HAVING aggregate: computed as a hidden reduce output,
                    # the filter references the reduced column
                    idx = len(self.having_aggs)
                    self.having_aggs.append(
                        lambda *tables, _a=arg, _agg=agg: (
                            _agg(_a(*tables)) if _a is not None else _agg()
                        )
                    )
                    return lambda *tables, _i=idx: ColumnReference(
                        tables[0], f"_hv{_i}"
                    )
                self.aggregates.append((name, arg))
                if arg is None:
                    return lambda *tables: agg()
                return lambda *tables, _arg=arg: agg(_arg(*tables))
            # qualified name?
            if self.accept("op", "."):
                col = self.expect("id")
                tname = name.lower()

                def qualified(*tables, _t=tname, _c=col):
                    t = self.scope.get(_t)
                    if t is None:
                        raise ValueError(f"SQL: unknown table alias {_t}")
                    return ColumnReference(t, _c)

                return qualified

            def unqualified(*tables, _c=name):
                for t in tables:
                    if _c in t.column_names:
                        return ColumnReference(t, _c)
                return ColumnReference(tables[0], _c)

            return unqualified
        raise ValueError(f"SQL: unexpected token {self.peek()}")

    def parse_case(self):
        self.expect("kw", "case")
        whens = []
        else_fn = lambda *tables: smart_coerce(None)
        while self.accept("kw", "when"):
            cond = self.parse_or()
            self.expect("kw", "then")
            val = self.parse_or()
            whens.append((cond, val))
        if self.accept("kw", "else"):
            else_fn = self.parse_or()
        self.expect("kw", "end")

        def build(*tables):
            expr = else_fn(*tables)
            for cond, val in reversed(whens):
                expr = IfElseExpression(cond(*tables), val(*tables), expr)
            return expr

        return build


def _align_columns(left: Table, right: Table, op: str) -> Table:
    """Project ``right`` to ``left``'s column order (set ops require
    matching names — reference: 'UNION requires matching column names')."""
    if set(left.column_names) != set(right.column_names):
        raise ValueError(
            f"SQL {op} requires matching column names: "
            f"{sorted(left.column_names)} vs {sorted(right.column_names)}"
        )
    return right.select(**{n: right[n] for n in left.column_names})


def _distinct(table: Table) -> Table:
    """One row per distinct value combination, keyed by the value hash
    (groupby over all columns) — which also makes key-based set ops
    (restrict/difference) behave as value-based SQL set ops."""
    return table.groupby(*[table[n] for n in table.column_names]).reduce(
        **{n: table[n] for n in table.column_names}
    )


class _Desc:
    """Inverts comparison so DESC keys sort inside an ascending tuple sort
    (works for any comparable type — no numeric negation tricks)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return isinstance(other, _Desc) and other.v == self.v

    def __hash__(self):  # reducer state interns values by hash
        return hash((_Desc, self.v))


def _order_limit(
    table: Table,
    order_items: List[Tuple[Any, bool]],
    limit_n: Optional[int],
    offset_n: int,
) -> Table:
    """ORDER BY … LIMIT/OFFSET, incrementally: pack (sort-key, row) per row,
    reduce into one globally sorted tuple, slice the window, flatten back to
    rows and unpack.  Streaming updates move rows in/out of the window
    (beyond the reference, which rejects ordering ops — sql.py:661)."""
    from . import api_reducers as reducers
    from .expression import ApplyExpression, GetExpression, MakeTupleExpression

    names = table.column_names

    def sort_key_expr():
        key_parts = []
        for key_fn, desc in order_items:
            expr = key_fn(table)
            if desc:
                expr = ApplyExpression(_Desc, None, (expr,))
            key_parts.append(expr)
        return MakeTupleExpression(*key_parts)

    row_expr = MakeTupleExpression(*[table[n] for n in names])
    if order_items:
        packed = table.select(_p=MakeTupleExpression(sort_key_expr(), row_expr))
    else:
        packed = table.select(_p=MakeTupleExpression(row_expr, row_expr))
    allrows = packed.groupby().reduce(rows=reducers.sorted_tuple(packed._p))
    stop = None if limit_n is None else offset_n + limit_n
    window = allrows.select(
        rows=ApplyExpression(
            lambda rows, _o=offset_n, _s=stop: tuple(rows[_o:_s]),
            None,
            (allrows.rows,),
        )
    )
    flat = window.flatten(window.rows)
    return flat.select(
        **{
            n: GetExpression(GetExpression(flat.rows, 1), i)
            for i, n in enumerate(names)
        }
    )


def _lift2(a, b, fn):
    return lambda *tables: fn(a(*tables), b(*tables))


def _lift1(a, fn):
    return lambda *tables: fn(a(*tables))


def sql(query: str, **tables: Table) -> Table:
    """Run a SQL SELECT over the given tables::

        result = pw.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k", t=my_table)
    """
    tokens = _tokenize(query)
    parser = _Parser(tokens, tables)
    result = parser.parse_query()
    parser.expect("eof")
    return result
