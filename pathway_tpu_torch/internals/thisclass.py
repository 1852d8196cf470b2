"""``pw.this`` / ``pw.left`` / ``pw.right`` placeholders
(reference: python/pathway/internals/thisclass.py).

A placeholder behaves like a table for column-reference purposes; operators
resolve it against their actual input at lowering time via the eval-context
column mapping keyed by ``id(placeholder)``.
"""

from __future__ import annotations

from .expression import ColumnReference, IdExpression, PointerExpression

__all__ = ["this", "left", "right", "ThisMetaclass"]


class _ThisPlaceholder:
    _short_name: str

    def __init__(self, short_name: str):
        self._short_name = short_name

    @property
    def id(self) -> IdExpression:
        return IdExpression(self)

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__") or name.startswith("_abc"):
            raise AttributeError(name)
        return ColumnReference(self, name)

    def __getitem__(self, name) -> ColumnReference:
        if isinstance(name, ColumnReference):
            return ColumnReference(self, name.name)
        return ColumnReference(self, name)

    def pointer_from(self, *args, optional: bool = False, instance=None):
        return PointerExpression(self, *args, optional=optional, instance=instance)

    def __repr__(self):  # pragma: no cover
        return f"<pw.{self._short_name}>"


this = _ThisPlaceholder("this")
left = _ThisPlaceholder("left")
right = _ThisPlaceholder("right")
ThisMetaclass = _ThisPlaceholder
