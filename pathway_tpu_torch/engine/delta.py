"""Timestamped micro-batch deltas — the unit of incremental computation.

The reference engine propagates per-record ``(data, time, diff)`` updates
through differential-dataflow collections (external/differential-dataflow/,
src/engine/dataflow.rs:757).  This engine batches updates: a
``Delta`` is a *columnar* batch of keyed upserts/retractions produced at one
commit tick.  Columnar batches are what vectorised host evaluation and device
launches want — one device call per operator per tick, not per record.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..internals import dtype as dt
from ..internals.keys import KEY_DTYPE

__all__ = ["Delta", "RowStore", "empty_delta", "rows_equal", "values_equal"]


def values_equal(a: Any, b: Any) -> bool:
    """Value equality that is safe for np.ndarray cells.  NaN counts as
    equal to NaN (value-identity semantics): a retraction rebuilt with the
    same NaN cell must match the stored row, or the retraction would be
    silently skipped and the row leak (RowStore.apply)."""
    if a is b:
        return True
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not isinstance(a, np.ndarray) or not isinstance(b, np.ndarray):
            return False
        if a.shape != b.shape:
            return False
        try:
            return bool(np.array_equal(a, b, equal_nan=True))
        except TypeError:  # non-numeric dtypes reject equal_nan
            return bool(np.array_equal(a, b))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return rows_equal(a, b)
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    try:
        return bool(a == b)
    except (ValueError, TypeError):
        return False


def rows_equal(a: Optional[Tuple[Any, ...]], b: Optional[Tuple[Any, ...]]) -> bool:
    if a is None or b is None:
        return a is b
    try:
        # C-level tuple compare: the common all-scalar case never reaches the
        # per-value Python loop.  A True is always trustworthy; a False is
        # trustworthy unless a NaN cell (x != x) compared false to itself.
        if a == b:
            return True
        if all(x == x for x in a):
            return False
    except (ValueError, TypeError):
        pass  # ndarray cells: ambiguous truth value — take the careful path
    if len(a) != len(b):
        return False
    return all(values_equal(x, y) for x, y in zip(a, b))


def _object_array(values: Sequence[Any]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def as_column(values: Sequence[Any], dtype: Optional[dt.DType] = None) -> np.ndarray:
    """Build a column array; dense numpy when the dtype allows it."""
    if isinstance(values, np.ndarray) and values.dtype != object:
        return values
    npdt = dt.numpy_dtype_for(dtype) if dtype is not None else None
    if npdt is not None:
        try:
            return np.asarray(values, dtype=npdt)
        except (TypeError, ValueError, OverflowError):
            # OverflowError: out-of-int64 values stay python big ints in an
            # object column (the row-path behavior)
            pass
    return _object_array(list(values))


@dataclass
class Delta:
    """A batch of changes: row i means (keys[i], diff[i], {col: columns[col][i]}).

    diffs are +1 (insert) / -1 (retract).  Within one Delta a key may appear
    twice (retract old row + insert new row) — retractions sort first."""

    keys: np.ndarray  # uint64[n]
    diffs: np.ndarray  # int64[n]
    columns: Dict[str, np.ndarray]  # each len n

    def __post_init__(self):
        self.keys = np.asarray(self.keys, dtype=KEY_DTYPE)
        self.diffs = np.asarray(self.diffs, dtype=np.int64)

    @property
    def n(self) -> int:
        return len(self.keys)

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    def select_rows(self, mask_or_index: np.ndarray) -> "Delta":
        return Delta(
            keys=self.keys[mask_or_index],
            diffs=self.diffs[mask_or_index],
            columns={k: v[mask_or_index] for k, v in self.columns.items()},
        )

    def retractions(self) -> "Delta":
        return self.select_rows(self.diffs < 0)

    def insertions(self) -> "Delta":
        return self.select_rows(self.diffs > 0)

    def with_columns(self, columns: Dict[str, np.ndarray]) -> "Delta":
        return Delta(keys=self.keys, diffs=self.diffs, columns=columns)

    def with_keys(self, keys: np.ndarray) -> "Delta":
        return Delta(keys=keys, diffs=self.diffs, columns=self.columns)

    def rows(self) -> Iterable[Tuple[int, int, Tuple[Any, ...]]]:
        names = self.column_names
        for i in range(self.n):
            yield (
                int(self.keys[i]),
                int(self.diffs[i]),
                tuple(self.columns[c][i] for c in names),
            )

    @staticmethod
    def from_rows(
        column_names: Sequence[str],
        rows: Sequence[Tuple[int, int, Tuple[Any, ...]]],
        dtypes: Optional[Mapping[str, dt.DType]] = None,
    ) -> "Delta":
        keys = np.array([r[0] for r in rows], dtype=KEY_DTYPE)
        diffs = np.array([r[1] for r in rows], dtype=np.int64)
        columns = {}
        for ci, name in enumerate(column_names):
            vals = [r[2][ci] for r in rows]
            columns[name] = as_column(vals, dtypes.get(name) if dtypes else None)
        return Delta(keys=keys, diffs=diffs, columns=columns)

    @staticmethod
    def concat(deltas: Sequence["Delta"], column_names: Sequence[str]) -> "Delta":
        deltas = [d for d in deltas if d.n > 0]
        if not deltas:
            return empty_delta(column_names)
        if len(deltas) == 1:
            return deltas[0]
        keys = np.concatenate([d.keys for d in deltas])
        diffs = np.concatenate([d.diffs for d in deltas])
        columns = {}
        for name in column_names:
            cols = [d.columns[name] for d in deltas]
            if any(c.dtype == object for c in cols):
                cols = [c.astype(object) for c in cols]
            columns[name] = np.concatenate(cols)
        return Delta(keys=keys, diffs=diffs, columns=columns)

    def consolidated(self) -> "Delta":
        """Cancel exact insert/retract pairs per key, then order retractions
        before insertions (stable).

        Cancellation makes the ordering safe: ``RowStore.apply`` replays a
        delta positionally, so an uncancelled (−new, +new) pair from a
        delete-after-update transient, re-sorted retractions-first, would
        resurrect the deleted row.  Removing equal-and-opposite pairs
        preserves the multiset sum (aggregates unaffected) and leaves at most
        one retraction + one insertion per key in well-formed streams."""
        if self.n <= 1:
            return self
        keys = self.keys
        diffs = self.diffs
        keep = np.ones(self.n, dtype=bool)
        # cancellation needed only for keys carrying both polarities —
        # find those rows vectorised so the common single-upsert-in-a-bulk
        # delta never enters a python loop
        uniq, inv = np.unique(keys, return_inverse=True)
        if len(uniq) < self.n:
            has_pos = np.bincount(inv, weights=(diffs > 0)) > 0
            has_neg = np.bincount(inv, weights=(diffs < 0)) > 0
            mixed_rows = np.flatnonzero(has_pos[inv] & has_neg[inv])
            names = self.column_names
            cols = [self.columns[c] for c in names]
            groups: Dict[int, List[int]] = {}
            for i in mixed_rows:
                groups.setdefault(int(inv[i]), []).append(int(i))
            for idxs in groups.values():
                pos = [i for i in idxs if diffs[i] > 0]
                neg = [i for i in idxs if diffs[i] < 0]
                if len(pos) > 4 and len(neg) > 4:
                    # large group: match exact insert/retract pairs by
                    # serialized bytes first (linear), leaving only unmatched
                    # leftovers for the quadratic rows_equal scan — pickle
                    # equality implies value equality, but not vice versa
                    # (int vs np.int64), so leftovers still need the scan
                    import pickle

                    buckets: Dict[bytes, List[int]] = {}
                    unbucketed_pos: List[int] = []
                    for pi in pos:
                        try:
                            b = pickle.dumps(tuple(c[pi] for c in cols), 4)
                        except Exception:
                            unbucketed_pos.append(pi)
                            continue
                        buckets.setdefault(b, []).append(pi)
                    leftover_neg: List[int] = []
                    for ni in neg:
                        try:
                            b = pickle.dumps(tuple(c[ni] for c in cols), 4)
                        except Exception:
                            leftover_neg.append(ni)
                            continue
                        lst = buckets.get(b)
                        if lst:
                            pi = lst.pop()
                            keep[ni] = False
                            keep[pi] = False
                        else:
                            leftover_neg.append(ni)
                    pos = unbucketed_pos + [
                        pi for lst in buckets.values() for pi in lst
                    ]
                    neg = leftover_neg
                for ni in neg:
                    nrow = tuple(c[ni] for c in cols)
                    for pj, pi in enumerate(pos):
                        if pi is None:
                            continue
                        if rows_equal(tuple(c[pi] for c in cols), nrow):
                            keep[ni] = False
                            keep[pi] = False
                            pos[pj] = None
                            break
            if not keep.all():
                sub = self.select_rows(keep)
                if sub.n <= 1:
                    return sub
                order = np.argsort(sub.diffs, kind="stable")
                return sub.select_rows(order)
        order = np.argsort(diffs, kind="stable")
        if np.all(order == np.arange(self.n)):
            return self
        return self.select_rows(order)


def empty_delta(column_names: Sequence[str]) -> Delta:
    return Delta(
        keys=np.empty(0, dtype=KEY_DTYPE),
        diffs=np.empty(0, dtype=np.int64),
        columns={c: np.empty(0, dtype=object) for c in column_names},
    )


class RowStore:
    """Materialised current state of a table: key → row tuple.

    The engine keeps one RowStore per engine table so any operator can
    retract previously-emitted rows and stateful operators can look rows up
    (the analog of differential arrangements,
    external/differential-dataflow/ — but as plain indexed state since each
    delta application is a host-side batch)."""

    def __init__(self, column_names: Sequence[str]):
        self.column_names = list(column_names)
        self._rows: Dict[int, Tuple[Any, ...]] = {}

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._rows

    def get(self, key: int) -> Optional[Tuple[Any, ...]]:
        return self._rows.get(int(key))

    def items(self):
        return self._rows.items()

    def keys_array(self) -> np.ndarray:
        return np.fromiter(self._rows.keys(), dtype=KEY_DTYPE, count=len(self._rows))

    def apply(self, delta: Delta) -> None:
        """Replay a delta into the state — columnar: the common shapes
        (all-insert, or retractions-then-insertions as ``consolidated()``
        emits) run as C-level zip/update/pop bulk ops, never a per-row
        Python tuple build.  ``list(col)`` (not ``col.tolist()``) keeps
        np scalar types intact — np.uint64 cells are pointers
        (internals/keys.py:53) and must not decay to plain ints."""
        n = delta.n
        if n == 0:
            return
        names = self.column_names
        cols = [delta.columns[c] for c in names]
        diffs = delta.diffs
        rows = self._rows
        neg = int(np.searchsorted(diffs, 0))  # first non-negative diff
        if neg == 0 or not (diffs[:neg] < 0).all() or not (diffs[neg:] > 0).all():
            if (diffs > 0).all():
                neg = 0
            else:
                # unsorted mixed delta: positional replay (rare — only
                # un-consolidated callers)
                for i in range(n):
                    key = int(delta.keys[i])
                    if diffs[i] > 0:
                        rows[key] = tuple(c[i] for c in cols)
                    else:
                        cur = rows.get(key)
                        if cur is None or rows_equal(
                            cur, tuple(c[i] for c in cols)
                        ):
                            rows.pop(key, None)
                return
        keys = delta.keys.tolist()
        if neg:
            # value-aware retraction: deltas from different upstream ports
            # arrive in arbitrary order within a tick, so a stale retraction
            # (old row) may land AFTER the key's new row was stored — only
            # pop when the stored row is the one being retracted
            if cols:
                ret_rows = zip(*(list(c[:neg]) for c in cols))
            else:
                ret_rows = iter([()] * neg)
            for key, row in zip(keys[:neg], ret_rows):
                cur = rows.get(key)
                if cur is None or rows_equal(cur, row):
                    rows.pop(key, None)
        if neg < n:
            ins_keys = keys[neg:]
            if cols:
                ins_rows = zip(*(list(c[neg:]) for c in cols))
            else:
                ins_rows = iter([()] * len(ins_keys))
            rows.update(zip(ins_keys, ins_rows))

    def _columns_of(self, rows: List[Tuple[Any, ...]]) -> Dict[str, np.ndarray]:
        """Transpose row tuples into object columns (C-level zip)."""
        if rows:
            transposed = list(zip(*rows))
        else:
            transposed = [()] * len(self.column_names)
        return {
            name: _object_array(transposed[ci])
            for ci, name in enumerate(self.column_names)
        }

    def lookup_delta(self, keys: np.ndarray, diff: int = -1) -> Delta:
        """Build a delta of current rows for the given keys (used to retract)."""
        get = self._rows.get
        pairs = [
            (key, row)
            for key in np.asarray(keys, dtype=KEY_DTYPE).tolist()
            if (row := get(key)) is not None
        ]
        found_keys = [p[0] for p in pairs]
        return Delta(
            keys=np.array(found_keys, dtype=KEY_DTYPE),
            diffs=np.full(len(found_keys), diff, dtype=np.int64),
            columns=self._columns_of([p[1] for p in pairs]),
        )

    def to_delta(self, diff: int = 1) -> Delta:
        """Snapshot the entire state as one insertion delta."""
        return Delta(
            keys=self.keys_array(),
            diffs=np.full(len(self._rows), diff, dtype=np.int64),
            columns=self._columns_of(list(self._rows.values())),
        )

    def to_columns(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        return self.keys_array(), self._columns_of(list(self._rows.values()))
