"""Fuzzy joins of the port (counterpart of
``pathway_tpu/stdlib/ml/smart_table_ops.py``) — probabilistic record
matching between live tables
(reference: python/pathway/stdlib/ml/smart_table_ops/_fuzzy_join.py —
fuzzy_match_tables / smart_fuzzy_match / fuzzy_self_match / fuzzy_match;
feature generation :35-57, discrete normalizations :60-92, two-stage
argmax pair selection :410-470).

Rows are tokenized into features; a pair's weight is the sum over shared
features of a count-normalized feature weight (discretized so live count
changes rarely perturb weights); each left row then picks its best right
and each right keeps its best left (pseudoweight tie-break on ids, so the
matching is deterministic).  Everything is ordinary dataflow — the matching
updates incrementally as either table changes."""

from __future__ import annotations

import math
from enum import IntEnum, auto
from typing import Any, Callable, Dict, Optional

import numpy as np

from ...internals import api_reducers as reducers
from ...internals.expression import ApplyExpression, IdExpression
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = [
    "FuzzyJoinFeatureGeneration",
    "FuzzyJoinNormalization",
    "fuzzy_match_tables",
    "smart_fuzzy_match",
    "fuzzy_self_match",
    "fuzzy_match",
]


def _tokenize(obj: Any):
    return tuple(str(obj).split())


def _letters(obj: Any):
    return tuple(c.lower() for c in str(obj) if c.isalnum())


class FuzzyJoinFeatureGeneration(IntEnum):
    AUTO = auto()
    TOKENIZE = auto()
    LETTERS = auto()

    @property
    def generate(self) -> Callable[[Any], Any]:
        if self == FuzzyJoinFeatureGeneration.LETTERS:
            return _letters
        return _tokenize


def _discrete_weight(cnt: float) -> float:
    if cnt <= 0:
        return 0.0
    return 1.0 / (2 ** math.ceil(math.log2(cnt)) if cnt > 1 else 1)


def _discrete_logweight(cnt: float) -> float:
    if cnt <= 0:
        return 0.0
    return 1.0 / math.ceil(math.log2(cnt + 1))


class FuzzyJoinNormalization(IntEnum):
    WEIGHT = auto()
    LOGWEIGHT = auto()
    NONE = auto()

    @property
    def normalize(self) -> Callable[[float], float]:
        if self == FuzzyJoinNormalization.WEIGHT:
            return _discrete_weight
        if self == FuzzyJoinNormalization.LOGWEIGHT:
            return _discrete_logweight
        return lambda cnt: float(cnt)


def _edges_for(table: Table, col, generation: FuzzyJoinFeatureGeneration) -> Table:
    gen = generation.generate
    with_feats = table.select(
        origin_id=IdExpression(table),
        feature=ApplyExpression(gen, None, args=(col,)),
    )
    return with_feats.flatten(with_feats.feature)


def smart_fuzzy_match(
    left_col,
    right_col,
    *,
    by_hand_match: Optional[Table] = None,
    normalization: FuzzyJoinNormalization = FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation: FuzzyJoinFeatureGeneration = FuzzyJoinFeatureGeneration.AUTO,
) -> Table:
    """Match rows of two tables by a fuzzy comparison of one column each.

    Returns a table with columns ``left`` (pointer), ``right`` (pointer) and
    ``weight`` (float), one row per matched pair."""
    left = left_col.table
    right = right_col.table
    symmetric = left is right and left_col.name == right_col.name

    el = _edges_for(left, left_col, feature_generation)
    # self-match: a distinct table object for the right side so column
    # references resolve per side in the join (reference: edges_right =
    # edges_left.copy(), _fuzzy_join.py:353)
    er = el.copy() if symmetric else _edges_for(right, right_col, feature_generation)

    all_edges = el if symmetric else el.concat_reindex(er)
    feat_cnt = all_edges.groupby(id=all_edges.pointer_from(this.feature)).reduce(
        cnt=reducers.count()
    )
    norm = normalization.normalize
    feat_weight = feat_cnt.select(
        w=ApplyExpression(lambda c: norm(float(c)), None, args=(this.cnt,))
    )

    pairs = el.join(er, el.feature == er.feature).select(
        left=el.origin_id,
        right=er.origin_id,
        feature=el.feature,
    )
    if symmetric:
        pairs = pairs.filter(this.left != this.right)
    weighted = pairs.select(
        left=this.left,
        right=this.right,
        weight=feat_weight.ix(pairs.pointer_from(pairs.feature)).w,
    )
    summed = weighted.groupby(
        id=weighted.pointer_from(this.left, this.right)
    ).reduce(
        left=reducers.any(this.left),
        right=reducers.any(this.right),
        weight=reducers.sum(this.weight),
    )

    # pseudoweight orders pairs deterministically: (weight, min_id, max_id)
    def pseudo(w, l, r):
        a, b = (int(l), int(r)) if int(l) < int(r) else (int(r), int(l))
        return (float(w), a, b)

    scored = summed.select(
        left=this.left,
        right=this.right,
        pseudo=ApplyExpression(
            pseudo, None, args=(this.weight, this.left, this.right)
        ),
        weight=this.weight,
    )
    by_left = scored.groupby(id=this.left).reduce(
        left=reducers.any(this.left),
        right=reducers.argmax(
            this.pseudo,
            ApplyExpression(lambda r: np.uint64(r), None, args=(this.right,)),
        ),
        pseudo=reducers.max(this.pseudo),
    )
    by_right = by_left.groupby(id=this.right).reduce(
        right=reducers.any(this.right),
        left=reducers.argmax(
            this.pseudo,
            ApplyExpression(lambda l: np.uint64(l), None, args=(this.left,)),
        ),
        pseudo=reducers.max(this.pseudo),
    )
    matches = by_right.select(
        left=this.left,
        right=this.right,
        weight=ApplyExpression(lambda p: p[0], None, args=(this.pseudo,)),
    )
    if symmetric:
        matches = matches.filter(
            ApplyExpression(
                lambda l, r: int(l) < int(r), None, args=(this.left, this.right)
            )
        )
    if by_hand_match is not None:
        matches = matches.update_rows(
            by_hand_match.with_id_from(by_hand_match.right)
        )
    return matches


def fuzzy_match_tables(
    left_table: Table,
    right_table: Table,
    *,
    by_hand_match: Optional[Table] = None,
    normalization: FuzzyJoinNormalization = FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation: FuzzyJoinFeatureGeneration = FuzzyJoinFeatureGeneration.AUTO,
    left_projection: Dict[str, str] = {},
    right_projection: Dict[str, str] = {},
) -> Table:
    """Fuzzy-match whole rows: columns are concatenated into one description
    per row (optionally bucketed by projections) and matched fuzzily
    (reference: fuzzy_match_tables, _fuzzy_join.py:106-176)."""

    def concat_desc(table: Table, columns=None) -> Table:
        cols = columns or table.column_names
        return table.select(
            desc=ApplyExpression(
                lambda *args: " ".join(str(a) for a in args),
                None,
                args=tuple(table[c] for c in cols),
            )
        )

    if not left_projection or not right_projection:
        l = concat_desc(left_table)
        r = concat_desc(right_table)
        return smart_fuzzy_match(
            l.desc,
            r.desc,
            by_hand_match=by_hand_match,
            normalization=normalization,
            feature_generation=feature_generation,
        )

    buckets: Dict[str, tuple] = {}
    for col, b in left_projection.items():
        buckets.setdefault(b, ([], []))[0].append(col)
    for col, b in right_projection.items():
        buckets.setdefault(b, ([], []))[1].append(col)
    partials = []
    for b, (lcols, rcols) in buckets.items():
        if not lcols or not rcols:
            continue
        l = concat_desc(left_table, lcols)
        r = concat_desc(right_table, rcols)
        partials.append(
            smart_fuzzy_match(
                l.desc,
                r.desc,
                by_hand_match=by_hand_match,
                normalization=normalization,
                feature_generation=feature_generation,
            )
        )
    if not partials:
        raise ValueError(
            "fuzzy_match_tables: left_projection and right_projection share "
            f"no bucket (left buckets {sorted(set(left_projection.values()))}, "
            f"right buckets {sorted(set(right_projection.values()))})"
        )
    merged = partials[0].concat_reindex(*partials[1:]) if len(partials) > 1 else partials[0]
    return merged.groupby(
        id=merged.pointer_from(this.left, this.right)
    ).reduce(
        left=reducers.any(this.left),
        right=reducers.any(this.right),
        weight=reducers.sum(this.weight),
    )


def fuzzy_self_match(col, **kwargs) -> Table:
    """Match rows of a table against itself (reference: fuzzy_self_match)."""
    return smart_fuzzy_match(col, col, **kwargs)


def fuzzy_match(left_col, right_col, **kwargs) -> Table:
    return smart_fuzzy_match(left_col, right_col, **kwargs)
