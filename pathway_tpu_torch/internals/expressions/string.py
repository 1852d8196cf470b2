"""``expr.str.*`` namespace (reference: python/pathway/internals/expressions/string.py)."""

from __future__ import annotations

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression, smart_coerce


def _m(name, args, fun, return_type):
    return MethodCallExpression(name, args, fun, return_type)


class StringNamespace:
    def __init__(self, expr: ColumnExpression):
        self._e = expr

    def lower(self):
        return _m("str.lower", (self._e,), lambda s: s.lower(), dt.STR)

    def upper(self):
        return _m("str.upper", (self._e,), lambda s: s.upper(), dt.STR)

    def reversed(self):
        return _m("str.reversed", (self._e,), lambda s: s[::-1], dt.STR)

    def len(self):
        return _m("str.len", (self._e,), lambda s: len(s), dt.INT)

    def strip(self, chars=None):
        return _m("str.strip", (self._e,), lambda s: s.strip(chars), dt.STR)

    def lstrip(self, chars=None):
        return _m("str.lstrip", (self._e,), lambda s: s.lstrip(chars), dt.STR)

    def rstrip(self, chars=None):
        return _m("str.rstrip", (self._e,), lambda s: s.rstrip(chars), dt.STR)

    def count(self, sub, start=None, end=None):
        return _m(
            "str.count",
            (self._e, smart_coerce(sub)),
            lambda s, x: s.count(x, start, end) if start is not None else s.count(x),
            dt.INT,
        )

    def find(self, sub, start=None, end=None):
        return _m(
            "str.find",
            (self._e, smart_coerce(sub)),
            lambda s, x: s.find(x) if start is None else s.find(x, start, end),
            dt.INT,
        )

    def rfind(self, sub, start=None, end=None):
        return _m(
            "str.rfind",
            (self._e, smart_coerce(sub)),
            lambda s, x: s.rfind(x) if start is None else s.rfind(x, start, end),
            dt.INT,
        )

    def removeprefix(self, prefix):
        return _m(
            "str.removeprefix",
            (self._e, smart_coerce(prefix)),
            lambda s, p: s.removeprefix(p),
            dt.STR,
        )

    def removesuffix(self, suffix):
        return _m(
            "str.removesuffix",
            (self._e, smart_coerce(suffix)),
            lambda s, p: s.removesuffix(p),
            dt.STR,
        )

    def replace(self, old, new, count=-1):
        return _m(
            "str.replace",
            (self._e, smart_coerce(old), smart_coerce(new)),
            lambda s, o, n: s.replace(o, n, count),
            dt.STR,
        )

    def startswith(self, prefix):
        return _m(
            "str.startswith",
            (self._e, smart_coerce(prefix)),
            lambda s, p: s.startswith(p),
            dt.BOOL,
        )

    def endswith(self, suffix):
        return _m(
            "str.endswith",
            (self._e, smart_coerce(suffix)),
            lambda s, p: s.endswith(p),
            dt.BOOL,
        )

    def swapcase(self):
        return _m("str.swapcase", (self._e,), lambda s: s.swapcase(), dt.STR)

    def title(self):
        return _m("str.title", (self._e,), lambda s: s.title(), dt.STR)

    def split(self, sep=None, maxsplit=-1):
        return _m(
            "str.split", (self._e,), lambda s: tuple(s.split(sep, maxsplit)), dt.Tuple_()
        )

    def slice(self, start, end):
        return _m("str.slice", (self._e,), lambda s: s[start:end], dt.STR)

    def parse_int(self, optional: bool = False):
        def p(s):
            try:
                return int(s)
            except (ValueError, TypeError):
                if optional:
                    return None
                raise

        return _m("str.parse_int", (self._e,), p, dt.INT if not optional else dt.Optional_(dt.INT))

    def parse_float(self, optional: bool = False):
        def p(s):
            try:
                return float(s)
            except (ValueError, TypeError):
                if optional:
                    return None
                raise

        return _m(
            "str.parse_float",
            (self._e,),
            p,
            dt.FLOAT if not optional else dt.Optional_(dt.FLOAT),
        )

    def parse_bool(self, true_values=("on", "true", "yes", "1"), false_values=("off", "false", "no", "0"), optional: bool = False):
        def p(s):
            ls = s.lower()
            if ls in true_values:
                return True
            if ls in false_values:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")

        return _m("str.parse_bool", (self._e,), p, dt.BOOL)
