"""Group-by reducers.

Mirrors the reference reducer set (src/engine/reduce.rs:22-594): semigroup
reducers (count / int & float / ndarray sums) update state in O(1) under
insertion *and* retraction; order-sensitive reducers (min/max/argmin/argmax,
unique, tuples) keep a per-group multiset so retractions are exact.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "Reducer",
    "CountReducer",
    "SumReducer",
    "NdarraySumReducer",
    "MinReducer",
    "MaxReducer",
    "ArgMinReducer",
    "ArgMaxReducer",
    "UniqueReducer",
    "AnyReducer",
    "SortedTupleReducer",
    "TupleReducer",
    "AvgReducer",
    "EarliestReducer",
    "LatestReducer",
    "StatefulReducer",
]


def _hashable(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return ("__ndarray__", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, dict)):
        import json

        return ("__json__", json.dumps(v, sort_keys=True, default=str))
    return v


class Reducer:
    """Interface: state = update(state, value, diff, key, ts); result(state).

    Additive reducers (count/sum/avg) additionally implement the vectorised
    pair ``batch_contribs``/``merge_contrib``: a whole delta collapses to one
    per-group contribution array (np.bincount over the group inverse index),
    and only *touched groups* are visited in Python — the groupby hot path
    (engine/operators/groupby.py) uses this to stay columnar per tick, the
    micro-batch analog of the reference's count-free semigroup reducers
    (src/engine/reduce.rs:40-101)."""

    name = "reducer"
    n_args = 1

    def init_state(self) -> Any:
        raise NotImplementedError

    def update(self, state: Any, value: Any, diff: int, key: int, ts: int) -> Any:
        raise NotImplementedError

    def result(self, state: Any) -> Any:
        raise NotImplementedError

    def batch_contribs(
        self,
        args: List[np.ndarray],
        diffs: np.ndarray,
        inv: np.ndarray,
        n_groups: int,
    ) -> Any:
        """Per-group aggregated contribution for one delta (group j's value
        at index j), or None when this reducer/dtype cannot vectorise —
        order-sensitive reducers return None and take the per-row path."""
        return None

    def merge_contrib(self, state: Any, contrib: Any) -> Any:
        raise NotImplementedError


class CountReducer(Reducer):
    name = "count"
    n_args = 0

    def init_state(self):
        return 0

    def update(self, state, value, diff, key, ts):
        return state + diff

    def result(self, state):
        return state

    def batch_contribs(self, args, diffs, inv, n_groups):
        return np.bincount(inv, weights=diffs, minlength=n_groups).astype(
            np.int64
        )

    def merge_contrib(self, state, contrib):
        return state + int(contrib)


class SumReducer(Reducer):
    name = "sum"

    def init_state(self):
        return None

    def update(self, state, value, diff, key, ts):
        contrib = value * diff
        return contrib if state is None else state + contrib

    def result(self, state):
        return state

    def batch_contribs(self, args, diffs, inv, n_groups):
        v = args[0]
        if not isinstance(v, np.ndarray) or v.ndim != 1 or v.dtype == object:
            return None
        if v.dtype != np.uint64 and np.issubdtype(v.dtype, np.integer):
            acc = np.zeros(n_groups, dtype=np.int64)
            # add.at (not bincount) keeps int64 arithmetic exact
            np.add.at(acc, inv, v.astype(np.int64) * diffs)
            return acc
        if np.issubdtype(v.dtype, np.floating):
            return np.bincount(inv, weights=v * diffs, minlength=n_groups)
        return None

    def merge_contrib(self, state, contrib):
        return contrib if state is None else state + contrib


class NdarraySumReducer(Reducer):
    name = "ndarray_sum"

    def init_state(self):
        return None

    def update(self, state, value, diff, key, ts):
        contrib = np.asarray(value) * diff
        return contrib if state is None else state + contrib

    def result(self, state):
        return state


class _MultisetReducer(Reducer):
    """Base: state is {hashable(value): [count, value]}."""

    def init_state(self):
        return {}

    def update(self, state, value, diff, key, ts):
        h = _hashable(value)
        entry = state.get(h)
        if entry is None:
            entry = [0, value]
            state[h] = entry
        entry[0] += diff
        # == 0, not <= 0: within one consolidated batch a retraction may be
        # processed before its matching insertion; negative counts must
        # persist so the insertion can cancel them
        if entry[0] == 0:
            del state[h]
        return state


class MinReducer(_MultisetReducer):
    name = "min"

    def result(self, state):
        return min((e[1] for e in state.values()), default=None)


class MaxReducer(_MultisetReducer):
    name = "max"

    def result(self, state):
        return max((e[1] for e in state.values()), default=None)


class _PairMultisetReducer(Reducer):
    """Multiset of (value, payload) pairs (for argmin/argmax)."""

    def init_state(self):
        return {}

    def update(self, state, value, diff, key, ts):
        # value is a tuple (order_value, payload)
        h = _hashable(value)
        entry = state.get(h)
        if entry is None:
            entry = [0, value]
            state[h] = entry
        entry[0] += diff
        # == 0, not <= 0: within one consolidated batch a retraction may be
        # processed before its matching insertion; negative counts must
        # persist so the insertion can cancel them
        if entry[0] == 0:
            del state[h]
        return state


class ArgMinReducer(_PairMultisetReducer):
    name = "argmin"
    n_args = 2

    def result(self, state):
        if not state:
            return None
        best = min(state.values(), key=lambda e: (e[1][0], e[1][1]))
        return best[1][1]


class ArgMaxReducer(_PairMultisetReducer):
    name = "argmax"
    n_args = 2

    def result(self, state):
        if not state:
            return None
        # ties broken by smallest payload repr (deterministic across runs)
        best = max(state.values(), key=lambda e: (e[1][0], [-ord(c) for c in repr(e[1][1])]))
        return best[1][1]


class UniqueReducer(_MultisetReducer):
    name = "unique"

    def result(self, state):
        if len(state) > 1:
            raise ValueError(
                "More than one distinct value passed to the unique reducer"
            )
        for e in state.values():
            return e[1]
        return None


class AnyReducer(_MultisetReducer):
    name = "any"

    def result(self, state):
        if not state:
            return None
        # deterministic: smallest by hashable encoding
        h = min(state.keys(), key=lambda x: repr(x))
        return state[h][1]


class SortedTupleReducer(Reducer):
    name = "sorted_tuple"

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def init_state(self):
        return {}

    def update(self, state, value, diff, key, ts):
        if value is None and self.skip_nones:
            return state
        h = _hashable(value)
        entry = state.get(h)
        if entry is None:
            entry = [0, value]
            state[h] = entry
        entry[0] += diff
        # == 0, not <= 0: within one consolidated batch a retraction may be
        # processed before its matching insertion; negative counts must
        # persist so the insertion can cancel them
        if entry[0] == 0:
            del state[h]
        return state

    def result(self, state):
        values: List[Any] = []
        for count, value in state.values():
            values.extend([value] * max(count, 0))
        return tuple(sorted(values, key=lambda v: (v is None, v)))


class TupleReducer(Reducer):
    """Tuple ordered by row key (deterministic)."""

    name = "tuple"
    n_args = 2  # (value, order_key)

    def __init__(self, skip_nones: bool = False):
        self.skip_nones = skip_nones

    def init_state(self):
        return {}

    def update(self, state, value, diff, key, ts):
        val, order = value
        if val is None and self.skip_nones:
            return state
        h = _hashable((order, val))
        entry = state.get(h)
        if entry is None:
            entry = [0, (order, val)]
            state[h] = entry
        entry[0] += diff
        # == 0, not <= 0: within one consolidated batch a retraction may be
        # processed before its matching insertion; negative counts must
        # persist so the insertion can cancel them
        if entry[0] == 0:
            del state[h]
        return state

    def result(self, state):
        entries = sorted(state.values(), key=lambda e: e[1][0])
        out: List[Any] = []
        for count, (order, val) in entries:
            out.extend([val] * max(count, 0))
        return tuple(out)


class AvgReducer(Reducer):
    name = "avg"

    def init_state(self):
        return (0.0, 0)

    def update(self, state, value, diff, key, ts):
        s, c = state
        return (s + value * diff, c + diff)

    def result(self, state):
        s, c = state
        return s / c if c else None

    def batch_contribs(self, args, diffs, inv, n_groups):
        v = args[0]
        if not isinstance(v, np.ndarray) or v.ndim != 1 or v.dtype == object:
            return None
        if v.dtype == np.uint64 or not (
            np.issubdtype(v.dtype, np.integer)
            or np.issubdtype(v.dtype, np.floating)
        ):
            return None
        sums = np.bincount(
            inv, weights=v.astype(np.float64) * diffs, minlength=n_groups
        )
        counts = np.bincount(inv, weights=diffs, minlength=n_groups).astype(
            np.int64
        )
        return list(zip(sums, counts))

    def merge_contrib(self, state, contrib):
        s, c = state
        ds, dc = contrib
        return (s + ds, c + int(dc))


class EarliestReducer(Reducer):
    name = "earliest"

    def init_state(self):
        return {}

    def update(self, state, value, diff, key, ts):
        h = _hashable((ts, key, value))
        entry = state.get(h)
        if entry is None:
            entry = [0, (ts, key, value)]
            state[h] = entry
        entry[0] += diff
        # == 0, not <= 0: within one consolidated batch a retraction may be
        # processed before its matching insertion; negative counts must
        # persist so the insertion can cancel them
        if entry[0] == 0:
            del state[h]
        return state

    def result(self, state):
        if not state:
            return None
        best = min(state.values(), key=lambda e: (e[1][0], e[1][1]))
        return best[1][2]


class LatestReducer(EarliestReducer):
    name = "latest"

    def result(self, state):
        if not state:
            return None
        best = max(state.values(), key=lambda e: (e[1][0], e[1][1]))
        return best[1][2]


class StatefulReducer(Reducer):
    """User combine function folded over the group's multiset IN ARRIVAL
    ORDER (reference: stateful reducers, reduce.rs:StatefulReducer &
    stateful_reduce.rs).  Retraction-safe because we re-fold on read.

    Each insertion records a per-group sequence number so interleaved
    duplicate values keep their positions (order-sensitive folds like the
    HMM/Viterbi reducer depend on it); a retraction of a value cancels its
    most recent surviving occurrence."""

    name = "stateful"

    def __init__(self, combine: Callable[[Optional[Any], List[Tuple[Any, ...]]], Any]):
        self.combine = combine

    def init_state(self):
        return {"n": 0, "items": {}}

    def update(self, state, value, diff, key, ts):
        items = state["items"]
        h = _hashable(value)
        entry = items.get(h)
        if entry is None:
            entry = [0, value, []]  # count, value, surviving arrival seqs
            items[h] = entry
        entry[0] += diff
        if diff > 0:
            entry[2].append(state["n"])
            state["n"] += 1
        elif entry[2]:
            entry[2].pop()
        # == 0, not <= 0: within one consolidated batch a retraction may be
        # processed before its matching insertion; negative counts must
        # persist so the insertion can cancel them
        if entry[0] == 0:
            del items[h]
        return state

    def result(self, state):
        ordered: List[Tuple[int, Any]] = []
        for count, value, seqs in state["items"].values():
            n = min(max(count, 0), len(seqs))
            for s in seqs[-n:] if n else []:
                ordered.append((s, value))
        if not ordered:
            return None
        ordered.sort(key=lambda p: p[0])
        return self.combine(None, [v for _, v in ordered])
