"""Louvain community detection (counterpart of
``pathway_tpu/stdlib/graphs/louvain_communities.py``; reference: python/pathway/stdlib/graphs/louvain_communities/impl.py —
_propose_clusters/_one_step local moves, _louvain_level_fixed_iterations,
louvain_communities_fixed_iterations multi-level driver, exact_modularity).

The reference randomizes local moves and relies on ``gradual_broadcast`` of
an approximate total weight; this build is deterministic: every iteration
each vertex evaluates the standard modularity gain of joining each
neighbouring cluster,

    gain(i, C) = k_{i,C} - k_i * tot_C / (2m)

(with ``tot_C`` excluding ``k_i`` when i ∈ C), and adopts the argmax when it
strictly beats staying put (ties broken by cluster key, so runs are
reproducible).  Iterations are dataflow rounds — join + groupby + argmax —
so clusterings refresh incrementally as edges change.  The global ``2m``
scalar reaches row contexts through a constant-key ix into the single-row
total table (the engine analog of the reference's gradual broadcast).

Works on a ``WeightedGraph`` whose edges are undirected (each edge stored
once; both endpoints count it).
"""

from __future__ import annotations

import numpy as np

from ...internals import api_reducers as reducers
from ...internals.expression import ApplyExpression
from ...internals.table import Table
from ...internals.thisclass import this
from .graph import WeightedGraph

__all__ = [
    "louvain_level_fixed_iterations",
    "louvain_communities_fixed_iterations",
    "exact_modularity",
]


def _initial_clustering(G: WeightedGraph) -> Table:
    """Every vertex in its own cluster (cluster id = vertex key)."""
    return G.V.select(c=this.id)


def _symmetric_edges(E: Table) -> Table:
    """Each undirected edge seen from both endpoints."""
    fwd = E.select(a=this.u, b=this.v, weight=this.weight)
    bwd = E.select(a=this.v, b=this.u, weight=this.weight)
    return fwd.concat_reindex(bwd)


def _one_iteration(clustering: Table, sym: Table, phase: int = 0) -> Table:
    # weighted degree k_i per vertex
    deg = sym.groupby(id=this.a).reduce(k=reducers.sum(this.weight))
    # single-row global: 2m = total symmetric weight (group key 0)
    total = sym.reduce(two_m=reducers.sum(this.weight))

    # candidate moves: vertex a -> cluster of a neighbour, k_{a,C} summed
    labelled = sym.select(
        a=this.a,
        c_b=clustering.ix(sym.b).c,
        weight=this.weight,
    )
    k_ic = labelled.groupby(id=labelled.pointer_from(this.a, this.c_b)).reduce(
        a=reducers.any(this.a),
        cand=reducers.any(this.c_b),
        w=reducers.sum(this.weight),
    )
    # tot_C = sum of member degrees per cluster
    member_k = clustering.select(
        c=this.c, k=deg.ix(clustering.id, context=clustering).k
    )
    tot = member_k.groupby(id=this.c).reduce(tot=reducers.sum(this.k))

    # reduce() with no grouping keys its single row at 0; evaluating to a
    # uint64 array makes the join use the values as keys directly
    zero_key = ApplyExpression(
        lambda a: np.zeros(len(a), dtype=np.uint64),
        None,
        args=(k_ic.a,),
        batched=True,
    )
    cand = k_ic.select(
        a=this.a,
        cand=this.cand,
        w=this.w,
        k_a=deg.ix(k_ic.a).k,
        own=clustering.ix(k_ic.a).c,
        tot_cand=tot.ix(k_ic.cand).tot,
        two_m=total.ix(zero_key).two_m,
    )

    def gain(w, k_a, own, cand_c, tot_cand, two_m):
        tot_adj = tot_cand - (k_a if own == cand_c else 0.0)
        return float(w) - float(k_a) * float(tot_adj) / float(two_m)

    scored = cand.select(
        a=this.a,
        cand=this.cand,
        own=this.own,
        score=ApplyExpression(
            gain,
            None,
            args=(this.w, this.k_a, this.own, this.cand, this.tot_cand, this.two_m),
        ),
    )
    # best candidate per vertex; deterministic tie-break on cluster key
    best = scored.groupby(id=this.a).reduce(
        choice=reducers.argmax(
            ApplyExpression(
                lambda s, c: (s, -int(c)), None, args=(this.score, this.cand)
            ),
            # payload keeps the cluster label pointer-typed (np.uint64) — a
            # python int would hash/serialize differently and split groups
            ApplyExpression(
                lambda c, s: (np.uint64(c), s), None, args=(this.cand, this.score)
            ),
        ),
    )
    own_score = (
        scored.filter(this.cand == this.own)
        .groupby(id=this.a)
        .reduce(stay=reducers.max(this.score))
    )

    sel = clustering.join_left(best, clustering.id == best.id).select(
        c=this.c, choice=best.choice
    )
    final = sel.join_left(own_score, sel.id == own_score.id)

    def pick(key, own_c, choice, stay, _phase=phase):
        # alternating-parity gate: only half the vertices move per iteration
        # (deterministic stand-in for the reference's randomized local moves —
        # simultaneous symmetric moves would swap labels forever)
        if (int(key) & 1) != (_phase & 1):
            return own_c
        if choice is None:
            return own_c
        cand_c, score = choice
        baseline = stay if stay is not None else 0.0
        if score > baseline + 1e-12 and cand_c != own_c:
            return np.uint64(cand_c)
        return own_c

    from ...internals.expression import IdExpression

    return final.select(
        c=ApplyExpression(
            pick, None, args=(IdExpression(sel), sel.c, sel.choice, own_score.stay)
        )
    )


def louvain_level_fixed_iterations(
    G: WeightedGraph, number_of_iterations: int = 5
) -> Table:
    """One Louvain level: repeated deterministic local moves
    (reference: _louvain_level_fixed_iterations, impl.py:252)."""
    clustering = _initial_clustering(G)
    sym = _symmetric_edges(G.E)
    for i in range(number_of_iterations):
        clustering = _one_iteration(clustering, sym, phase=i)
    return clustering


def louvain_communities_fixed_iterations(
    G: WeightedGraph, levels: int = 1, iterations_per_level: int = 5
) -> Table:
    """Multi-level Louvain: cluster, contract, repeat
    (reference: louvain_communities_fixed_iterations, impl.py:282-338).

    Returns a clustering of the ORIGINAL vertices (cluster labels from the
    final level, composed through the contractions)."""
    clustering = louvain_level_fixed_iterations(G, iterations_per_level)
    for _ in range(levels - 1):
        G = G.contracted_to_weighted_simple_graph(clustering)
        next_clustering = louvain_level_fixed_iterations(G, iterations_per_level)
        # compose: original vertex -> old cluster -> new cluster
        clustering = clustering.select(c=next_clustering.ix(clustering.c).c)
    return clustering


def exact_modularity(G: WeightedGraph, clustering: Table) -> float:
    """Q = Σ_C [ Σ_in(C)/(2m) − (Σ_tot(C)/(2m))² ]
    (reference: exact_modularity, impl.py:340-378).  Runs the graph and
    returns a float (host-side; for tests and evaluation)."""
    from ...internals.run import run as pw_run

    sym = _symmetric_edges(G.E)
    deg = sym.groupby(id=this.a).reduce(k=reducers.sum(this.weight))
    labelled = sym.select(
        c_a=clustering.ix(sym.a).c,
        c_b=clustering.ix(sym.b).c,
        weight=this.weight,
    )
    internal = (
        labelled.filter(this.c_a == this.c_b)
        .groupby(id=this.c_a)
        .reduce(w_in=reducers.sum(this.weight))
    )
    member_k = clustering.select(
        c=this.c, k=deg.ix(clustering.id, context=clustering).k
    )
    tot = member_k.groupby(id=this.c).reduce(tot=reducers.sum(this.k))
    pw_run(monitoring_level=None)

    keys_t, cols_t = tot._materialize()
    keys_i, cols_i = internal._materialize()
    _, sym_cols = sym._materialize()
    two_m = float(sym_cols["weight"].sum()) if len(sym_cols["weight"]) else 0.0
    if two_m == 0.0:
        return 0.0
    internal_by_key = dict(zip(keys_i.tolist(), cols_i["w_in"].tolist()))
    q = 0.0
    for key, tot_c in zip(keys_t.tolist(), cols_t["tot"].tolist()):
        w_in = internal_by_key.get(key, 0.0)
        q += w_in / two_m - (tot_c / two_m) ** 2
    return q
