"""Metadata filter language for index queries.

Reference uses JMESPath extended with ``globmatch`` for candidate filtering
(src/external_integration/mod.rs:248 JMESPathFilterWithGlobPattern).  No
jmespath dependency exists here, so this is a self-contained parser for the
subset the reference's docs exercise: dotted field paths, literals,
``== != < <= > >=``, ``&& || !``, parentheses, and the functions
``contains(haystack, needle)`` and ``globmatch(pattern, field)``.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["compile_filter"]

_TOKEN = re.compile(
    r"\s*(?:"
    r"(?P<num>-?\d+\.\d+|-?\d+)"
    r"|(?P<str>'(?:[^']|\\')*'|`(?:[^`])*`|\"(?:[^\"])*\")"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>&&|\|\||==|!=|<=|>=|<|>|!|\(|\)|,|\.)"
    r")"
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise ValueError(f"bad filter syntax near {text[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            out.append(("num", m.group("num")))
        elif m.lastgroup == "str":
            s = m.group("str")
            out.append(("str", s[1:-1]))
        elif m.lastgroup == "name":
            out.append(("name", m.group("name")))
        else:
            out.append(("op", m.group("op")))
    out.append(("eof", ""))
    return out


class _P:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, val=None):
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            self.i += 1
            return v
        return None

    def expect(self, kind, val=None):
        got = self.accept(kind, val)
        if got is None:
            raise ValueError(f"filter: expected {val or kind}, got {self.peek()}")
        return got

    def parse(self):
        e = self.parse_or()
        self.expect("eof")
        return e

    def parse_or(self):
        left = self.parse_and()
        while self.accept("op", "||"):
            right = self.parse_and()
            left = (lambda l, r: lambda m: l(m) or r(m))(left, right)
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept("op", "&&"):
            right = self.parse_not()
            left = (lambda l, r: lambda m: l(m) and r(m))(left, right)
        return left

    def parse_not(self):
        if self.accept("op", "!"):
            inner = self.parse_not()
            return lambda m: not inner(m)
        return self.parse_cmp()

    def parse_cmp(self):
        left = self.parse_atom()
        k, v = self.peek()
        if k == "op" and v in ("==", "!=", "<", "<=", ">", ">="):
            self.next()
            right = self.parse_atom()
            ops = {
                "==": lambda a, b: a == b,
                "!=": lambda a, b: a != b,
                "<": lambda a, b: a is not None and b is not None and a < b,
                "<=": lambda a, b: a is not None and b is not None and a <= b,
                ">": lambda a, b: a is not None and b is not None and a > b,
                ">=": lambda a, b: a is not None and b is not None and a >= b,
            }
            op = ops[v]
            return lambda m: op(left(m), right(m))
        # no comparison: return the raw value (truthiness applies only at
        # boolean-context boundaries, not inside function arguments)
        return left

    def parse_atom(self):
        k, v = self.peek()
        if k == "num":
            self.next()
            value = float(v) if "." in v else int(v)
            return lambda m: value
        if k == "str":
            self.next()
            return lambda m: v
        if self.accept("op", "("):
            inner = self.parse_or()
            self.expect("op", ")")
            return inner
        if k == "name":
            name = self.next()[1]
            if name in ("true", "false", "null"):
                value = {"true": True, "false": False, "null": None}[name]
                return lambda m: value
            if self.peek() == ("op", "("):
                self.next()
                args = []
                if not self.accept("op", ")"):
                    while True:
                        args.append(self.parse_or())
                        if not self.accept("op", ","):
                            break
                    self.expect("op", ")")
                return self._function(name, args)
            # dotted path
            path = [name]
            while self.accept("op", "."):
                path.append(self.expect("name"))

            def lookup(m, _path=tuple(path)):
                cur = m
                for part in _path:
                    if isinstance(cur, dict):
                        cur = cur.get(part)
                    else:
                        return None
                return cur

            return lookup
        raise ValueError(f"filter: unexpected token {self.peek()}")

    def _function(self, name, args):
        if name == "contains":
            a, b = args
            return lambda m: (lambda h, n: h is not None and n in h)(a(m), b(m))
        if name in ("globmatch", "glob_pattern_match"):
            pat, field = args
            return lambda m: (
                lambda p, f: f is not None and fnmatch.fnmatch(str(f), str(p))
            )(pat(m), field(m))
        if name == "starts_with":
            a, b = args
            return lambda m: (lambda s, p: s is not None and str(s).startswith(str(p)))(
                a(m), b(m)
            )
        if name == "length":
            (a,) = args
            return lambda m: (lambda x: len(x) if x is not None else 0)(a(m))
        raise ValueError(f"filter: unknown function {name}")


def compile_filter(expr: Optional[str]) -> Optional[Callable[[Any], bool]]:
    """Compile a filter expression to metadata_dict -> bool (None passes all)."""
    if expr is None or expr == "":
        return None
    fn = _P(_tokenize(expr)).parse()
    return lambda m: bool(fn(m))
