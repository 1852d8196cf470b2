"""Hidden-Markov-model decoding as a stateful reducer, in the port
(counterpart of ``pathway_tpu/stdlib/ml/hmm.py``)
(reference: python/pathway/stdlib/ml/hmm.py:11-210 — create_hmm_reducer
builds a custom accumulator running beam-searched Viterbi over a
networkx.DiGraph of states).

Graph contract (same as the reference): nodes carry a
``calc_emission_log_ppb(observation) -> float`` attribute, edges carry
``log_transition_ppb``; ``graph.graph["start_nodes"]`` lists entry states.
The returned reducer folds a group's observations (in arrival order — pair
with ``sort_by``/windowby for explicit ordering) and yields the most likely
state path as a tuple."""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ...internals import api_reducers as reducers

__all__ = ["create_hmm_reducer"]


def create_hmm_reducer(
    graph,
    beam_size: Optional[int] = None,
    num_results_kept: Optional[int] = None,
) -> Callable:
    """Returns a reducer expression factory: use as
    ``table.groupby(...).reduce(path=hmm_reducer(pw.this.observation))``."""
    nodes = list(graph.nodes)
    idx_of = {n: i for i, n in enumerate(nodes)}
    n_states = len(nodes)
    emit = [graph.nodes[n]["calc_emission_log_ppb"] for n in nodes]
    start_idx = [idx_of[n] for n in graph.graph["start_nodes"]]
    successors = [
        [
            (idx_of[m], graph.get_edge_data(n, m)["log_transition_ppb"])
            for m in graph.successors(n)
        ]
        for n in nodes
    ]
    beam = beam_size if beam_size is not None else n_states + 1

    def viterbi(observations) -> Optional[tuple]:
        if not observations:
            return None
        ppb = np.full(n_states, -np.inf)
        for i in start_idx:
            ppb[i] = emit[i](observations[0])
        live = list(start_idx)
        backpointers = []
        for obs in observations[1:]:
            new_ppb = np.full(n_states, -np.inf)
            back = np.full(n_states, -1, dtype=int)
            for src in live:
                base = ppb[src]
                for dst, logp in successors[src]:
                    cand = base + logp
                    if cand > new_ppb[dst]:
                        new_ppb[dst] = cand
                        back[dst] = src
            reached = np.flatnonzero(new_ppb > -np.inf)
            for dst in reached:
                new_ppb[dst] += emit[dst](obs)
            if len(reached) > beam:
                keep = reached[np.argpartition(new_ppb[reached], -beam)[-beam:]]
            else:
                keep = reached
            live = [int(i) for i in keep]
            if not live:
                return None  # no path continues
            backpointers.append(back)
            ppb = new_ppb
        best = int(np.argmax(ppb))
        path = [best]
        for back in reversed(backpointers):
            prev = int(back[path[-1]])
            if prev < 0:
                break
            path.append(prev)
        states = tuple(nodes[i] for i in reversed(path))
        if num_results_kept is not None:
            states = states[-num_results_kept:]
        return states

    def combine(_state: Any, rows) -> Optional[tuple]:
        return viterbi([r[0] for r in rows])

    return reducers.stateful_many(combine)
