"""Incremental joins.

Reference: Graph::join_tables (src/engine/graph.rs:873) over differential
arrangements; JoinType inner/left/right/outer plus the non-retracting
"asof-now" flavors used by live retrieval serving
(stdlib/indexing/data_index.py:364-441).

Bilinear-rule discipline: a delta on one side joins the *other side's own
state as of before this delta* and then updates its own side, so
dA⋈B_old + dB⋈A_new sums to exactly A_new⋈B_new − A_old⋈B_old.
Outer padding uses per-join-key match counts derived from state sizes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ...internals.expression import ColumnExpression
from ...internals.keys import KEY_DTYPE, ref_scalars_batch
from ..delta import Delta, _object_array
from ..graph import EngineOperator, EngineTable
from .rowwise import build_eval_context

__all__ = ["JoinOperator", "AsofNowJoinOperator", "JoinKind"]


class JoinKind:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


_LPAD = 0x9D39247E33776D41  # sentinels mixed into padded-row keys
_RPAD = 0x8A305F5359C24D78


# join keys reserved for None pointers: match no real row id (ids are xxh3
# of values / sequential-salted, never these constants) and differ PER SIDE
# so a None on the left never meets a None on the right
_NONE_PTR_SENTINELS = (
    np.uint64(0xFFFFFFFFFFFFFFFE),  # left
    np.uint64(0xFFFFFFFFFFFFFFFF),  # right
)




class JoinOperator(EngineOperator):
    """Output columns: ``_l_<name>`` for left columns, ``_r_<name>`` for right
    columns; unmatched sides padded with None for outer kinds."""

    def __init__(
        self,
        left: EngineTable,
        right: EngineTable,
        output: EngineTable,
        left_key_exprs: Sequence[ColumnExpression],
        right_key_exprs: Sequence[ColumnExpression],
        left_ctx_cols: Mapping[Tuple[int, str], str],
        right_ctx_cols: Mapping[Tuple[int, str], str],
        kind: str = JoinKind.INNER,
        assign_id_from: Optional[str] = None,
        exact_match: bool = False,
        warn_unmatched_left: bool = False,
        pointer_keys: Optional[bool] = None,
        name: str = "join",
    ):
        super().__init__([left, right], output, name)
        # non-optional ix: the reference raises on an unresolved pointer; the
        # incremental engine keeps the row out of the output (it may match
        # later) but warns at tick end so lookup bugs stay loud (round-1
        # advice).  Warning is deferred to on_tick_end because within a tick
        # the left delta may simply be processed before the right one.
        self.warn_unmatched_left = warn_unmatched_left
        # build-time declaration that BOTH single-key sides are pointer
        # columns (ix / id joins): the raw-uint64 key path is then used
        # unconditionally, with Nones mapped to per-side sentinels — the
        # encoding must never depend on a delta's value mix, or inserts and
        # retractions of one row could disagree on its join key
        self.pointer_keys = pointer_keys
        self._unres_left: set = set()
        self._warned_unres: set = set()
        self.left_key_exprs = list(left_key_exprs)
        self.right_key_exprs = list(right_key_exprs)
        self.left_ctx_cols = dict(left_ctx_cols)
        self.right_ctx_cols = dict(right_ctx_cols)
        self.kind = kind
        self.assign_id_from = assign_id_from
        self.left_names = list(left.column_names)
        self.right_names = list(right.column_names)
        # own per-side state: join_key -> {row_key: row_tuple}
        self._left: Dict[int, Dict[int, Tuple[Any, ...]]] = {}
        self._right: Dict[int, Dict[int, Tuple[Any, ...]]] = {}

    def dist_routing(self, port: int):
        # distributed: co-locate both sides by JOIN key so matches happen
        # rank-locally (reference: differential join's exchange pact on the
        # arrangement key)
        return lambda delta: self._join_keys(delta, port)

    def snapshot_state(self):
        return {"left": self._left, "right": self._right}

    def restore_state(self, state) -> None:
        self._left = state["left"]
        self._right = state["right"]

    # -- helpers -----------------------------------------------------------
    def _join_keys(self, delta: Delta, side: int) -> np.ndarray:
        exprs = self.left_key_exprs if side == 0 else self.right_key_exprs
        ctx_cols = self.left_ctx_cols if side == 0 else self.right_ctx_cols
        ctx = build_eval_context(delta, ctx_cols)
        if self.pointer_keys and len(exprs) == 1:
            # declared pointer join (ix / id joins, dtype-known pointer
            # columns): raw-uint64 keys, Nones -> side sentinel
            arr = np.asarray(exprs[0]._eval(ctx))
            if arr.dtype == object:
                sentinel = _NONE_PTR_SENTINELS[side]
                arr = np.array(
                    [sentinel if v is None else np.uint64(v) for v in arr],
                    dtype=np.uint64,
                )
            return arr.astype(KEY_DTYPE)
        # undeclared: ALWAYS hash — the serialization tags values by their
        # own type, so both sides agree regardless of how each delta mixes
        # Nones/uint64s (a per-delta direct-path heuristic would let one
        # row's insertion and retraction disagree on its join key)
        vals = [np.asarray(e._eval(ctx)) for e in exprs]
        return ref_scalars_batch(vals)

    def _row(self, lrow: Optional[Tuple], rrow: Optional[Tuple]) -> Tuple[Any, ...]:
        l = lrow if lrow is not None else (None,) * len(self.left_names)
        r = rrow if rrow is not None else (None,) * len(self.right_names)
        return tuple(l) + tuple(r)

    # -- columnar output assembly -----------------------------------------
    def _out_keys_batch(
        self, lkeys: List[Optional[int]], rkeys: List[Optional[int]]
    ) -> np.ndarray:
        """Batched ``_out_key`` — one ref_scalars_batch call for the whole
        output instead of one per emitted row.  Row keys hash as
        pointer-tagged uint64 columns so the batch always takes the fully
        native serialize+hash path (plain python ints ≥ 2^63 would knock the
        whole column onto the per-value fallback)."""
        a = np.fromiter(
            (k if k is not None else _LPAD for k in lkeys),
            dtype=np.uint64,
            count=len(lkeys),
        )
        b = np.fromiter(
            (k if k is not None else _RPAD for k in rkeys),
            dtype=np.uint64,
            count=len(rkeys),
        )
        hashed = ref_scalars_batch([a, b])
        if self.assign_id_from == "left":
            return np.array(
                [
                    lk if lk is not None else h
                    for lk, h in zip(lkeys, hashed.tolist())
                ],
                dtype=KEY_DTYPE,
            )
        if self.assign_id_from == "right":
            return np.array(
                [
                    rk if rk is not None else h
                    for rk, h in zip(rkeys, hashed.tolist())
                ],
                dtype=KEY_DTYPE,
            )
        return hashed

    def _assemble(
        self,
        lkeys: List[Optional[int]],
        rkeys: List[Optional[int]],
        lrows: List[Optional[Tuple]],
        rrows: List[Optional[Tuple]],
        diffs: List[int],
    ) -> Delta:
        none_l = (None,) * len(self.left_names)
        none_r = (None,) * len(self.right_names)
        lt = (
            list(zip(*(r if r is not None else none_l for r in lrows)))
            if self.left_names
            else []
        )
        rt = (
            list(zip(*(r if r is not None else none_r for r in rrows)))
            if self.right_names
            else []
        )
        nl = len(self.left_names)
        columns = {}
        for ci, name in enumerate(self.output.column_names):
            # hidden side-id columns (padded side -> None) back `left.id` /
            # `right.id` in join selects; declared last, so the positional
            # left/right mapping below is unaffected
            if name == "_pw_lid":
                columns[name] = _object_array(lkeys)
            elif name == "_pw_rid":
                columns[name] = _object_array(rkeys)
            else:
                columns[name] = _object_array(lt[ci] if ci < nl else rt[ci - nl])
        return Delta(
            keys=self._out_keys_batch(lkeys, rkeys),
            diffs=np.asarray(diffs, dtype=np.int64),
            columns=columns,
        )

    # -- processing --------------------------------------------------------
    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        delta = delta.consolidated()
        jks = self._join_keys(delta, port)
        in_names = self.left_names if port == 0 else self.right_names
        cols = [delta.columns[c] for c in in_names]
        own = self._left if port == 0 else self._right
        other = self._right if port == 0 else self._left
        pad_own = self.kind in (
            (JoinKind.LEFT, JoinKind.OUTER) if port == 0 else (JoinKind.RIGHT, JoinKind.OUTER)
        )
        pad_other = self.kind in (
            (JoinKind.RIGHT, JoinKind.OUTER) if port == 0 else (JoinKind.LEFT, JoinKind.OUTER)
        )
        left_port = port == 0

        # parallel accumulators; output columns are assembled columnar at the
        # end (C-level zip) and out keys hashed in ONE batched call — per
        # emitted row this loop only does list extends/appends
        acc_l: List[Optional[int]] = []
        acc_r: List[Optional[int]] = []
        acc_lrow: List[Optional[Tuple]] = []
        acc_rrow: List[Optional[Tuple]] = []
        acc_diff: List[int] = []

        def emit_bucket(bucket: Dict[int, Tuple], key, row, d: int) -> None:
            """All (own row × other-bucket) pairs with diff d; ``key``/``row``
            None emits the padded form of the other side's rows."""
            m = len(bucket)
            if left_port:
                acc_l.extend([key] * m)
                acc_lrow.extend([row] * m)
                acc_r.extend(bucket.keys())
                acc_rrow.extend(bucket.values())
            else:
                acc_l.extend(bucket.keys())
                acc_lrow.extend(bucket.values())
                acc_r.extend([key] * m)
                acc_rrow.extend([row] * m)
            acc_diff.extend([d] * m)

        def emit_pad_own(key, row, d: int) -> None:
            if left_port:
                acc_l.append(key)
                acc_lrow.append(row)
                acc_r.append(None)
                acc_rrow.append(None)
            else:
                acc_l.append(None)
                acc_lrow.append(None)
                acc_r.append(key)
                acc_rrow.append(row)
            acc_diff.append(d)

        row_iter = (
            zip(*(list(c) for c in cols)) if cols else iter([()] * delta.n)
        )
        for jk, key, diff, row in zip(
            jks.tolist(), delta.keys.tolist(), delta.diffs.tolist(), row_iter
        ):
            own_bucket = own.setdefault(jk, {})
            other_bucket = other.get(jk) or {}
            own_before = len(own_bucket)

            if diff > 0:
                if other_bucket:
                    emit_bucket(other_bucket, key, row, 1)
                    if pad_other and own_before == 0:
                        # other side's rows were padded; retract padded forms
                        emit_bucket(other_bucket, None, None, -1)
                    if not left_port and self.warn_unmatched_left:
                        # right insert resolved these left rows
                        self._unres_left.difference_update(other_bucket.keys())
                elif pad_own:
                    emit_pad_own(key, row, 1)
                elif left_port and self.warn_unmatched_left:
                    self._unres_left.add(key)
                own_bucket[key] = row
            else:
                if left_port and self.warn_unmatched_left:
                    self._unres_left.discard(key)
                own_bucket.pop(key, None)
                own_after = len(own_bucket)
                if (
                    not left_port
                    and self.warn_unmatched_left
                    and own_after == 0
                    and other_bucket
                ):
                    # last right row for this key retracted: the surviving
                    # left rows are unmatched again
                    self._unres_left.update(other_bucket.keys())
                if other_bucket:
                    emit_bucket(other_bucket, key, row, -1)
                    if pad_other and own_after == 0 and own_before > 0:
                        emit_bucket(other_bucket, None, None, 1)
                elif pad_own:
                    emit_pad_own(key, row, -1)
                if not own_bucket:
                    own.pop(jk, None)
        if not acc_diff:
            return None
        return self._assemble(acc_l, acc_r, acc_lrow, acc_rrow, acc_diff)

    def on_tick_end(self, ts: int):
        if self.warn_unmatched_left and self._unres_left != self._warned_unres:
            if self._unres_left:
                import logging

                logging.getLogger(__name__).warning(
                    "%s: %d row(s) currently have unresolved pointers and are "
                    "absent from the output (non-optional ix promises every "
                    "pointer resolves; pass optional=True to keep unmatched "
                    "rows with None columns)",
                    self.name,
                    len(self._unres_left),
                )
            self._warned_unres = set(self._unres_left)
        return None


class AsofNowJoinOperator(JoinOperator):
    """``join_asof_now``: each left (query) row joins the right state *as of
    arrival* and the result never retracts when the right side later changes
    (reference: the asof-now contract of query_as_of_now,
    stdlib/indexing/data_index.py:364-441; use_external_index_as_of_now,
    graph.rs:915).  Left retractions do retract previously emitted rows."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # lkey -> list of (out_key, out_row) previously emitted
        self._emitted: Dict[int, List[Tuple[int, Tuple[Any, ...]]]] = {}

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        if port == 1:
            # maintain right state only; no re-emission (asof-now contract)
            jks = self._join_keys(delta, 1)
            cols = [delta.columns[c] for c in self.right_names]
            for i in range(delta.n):
                jk = int(jks[i])
                key = int(delta.keys[i])
                if delta.diffs[i] > 0:
                    self._right.setdefault(jk, {})[key] = tuple(c[i] for c in cols)
                else:
                    bucket = self._right.get(jk)
                    if bucket is not None:
                        bucket.pop(key, None)
                        if not bucket:
                            self._right.pop(jk, None)
            return None
        delta = delta.consolidated()
        jks = self._join_keys(delta, 0)
        cols = [delta.columns[c] for c in self.left_names]
        pad_left = self.kind in (JoinKind.LEFT, JoinKind.OUTER)

        # retractions replay previously emitted rows verbatim; insertions
        # accumulate columnar (same scheme as JoinOperator.process) — the
        # per-left-key _emitted bookkeeping is filled in after the one
        # batched out-key hash
        ret_keys: List[int] = []
        ret_rows: List[Tuple[Any, ...]] = []
        acc_l: List[int] = []
        acc_r: List[Optional[int]] = []
        acc_lrow: List[Tuple] = []
        acc_rrow: List[Optional[Tuple]] = []
        emit_spans: List[Tuple[int, int, int]] = []  # (left key, start, stop)
        row_iter = (
            zip(*(list(c) for c in cols)) if cols else iter([()] * delta.n)
        )
        for jk, key, diff, row in zip(
            jks.tolist(), delta.keys.tolist(), delta.diffs.tolist(), row_iter
        ):
            if diff < 0:
                for out_key, out_row in self._emitted.pop(key, []):
                    ret_keys.append(out_key)
                    ret_rows.append(out_row)
                continue
            start = len(acc_l)
            bucket = self._right.get(jk) or {}
            if bucket:
                m = len(bucket)
                acc_l.extend([key] * m)
                acc_lrow.extend([row] * m)
                acc_r.extend(bucket.keys())
                acc_rrow.extend(bucket.values())
            elif pad_left:
                acc_l.append(key)
                acc_lrow.append(row)
                acc_r.append(None)
                acc_rrow.append(None)
            emit_spans.append((key, start, len(acc_l)))
        if not acc_l and not ret_keys:
            if emit_spans:
                # inner-join queries that matched nothing still reset their
                # emitted bookkeeping
                for key, _s, _e in emit_spans:
                    self._emitted[key] = []
            return None
        ins = (
            self._assemble(acc_l, acc_r, acc_lrow, acc_rrow, [1] * len(acc_l))
            if acc_l
            else None
        )
        if ins is not None:
            ins_keys = ins.keys.tolist()
            ins_rows = list(
                zip(*(ins.columns[c] for c in self.output.column_names))
            )
            for key, start, stop in emit_spans:
                self._emitted[key] = list(
                    zip(ins_keys[start:stop], ins_rows[start:stop])
                )
        else:
            for key, _s, _e in emit_spans:
                self._emitted[key] = []
        rets = (
            Delta(
                keys=np.asarray(ret_keys, dtype=KEY_DTYPE),
                diffs=np.full(len(ret_keys), -1, dtype=np.int64),
                columns={
                    name: _object_array(col)
                    for name, col in zip(
                        self.output.column_names,
                        zip(*ret_rows)
                        if ret_rows
                        else [[]] * len(self.output.column_names),
                    )
                },
            )
            if ret_keys
            else None
        )
        if ins is None:
            return rets
        if rets is None:
            return ins
        return Delta.concat([rets, ins], self.output.column_names)
