"""Global graph state.

The reference keeps a global ``ParseGraph`` of user operators that a
GraphRunner later lowers onto the engine (python/pathway/internals/
parse_graph.py:104, graph_runner/__init__.py:36).  Here the Table API lowers
*eagerly* onto the engine graph (the DAG of columnar-delta operators in
engine/graph.py); this module holds that graph plus run bookkeeping.
"""

from __future__ import annotations

from typing import List, Optional

from ..engine.graph import EngineGraph

__all__ = ["G", "GraphHolder"]


class GraphHolder:
    def __init__(self):
        self.engine_graph = EngineGraph()
        self.ran = False
        # operator ids already executed by a previous run() — later runs
        # bootstrap newly added operators from upstream stores
        self.ran_ops: set = set()
        # callables invoked before run (e.g. connector thread starters);
        # each fires exactly once
        self.pre_run_hooks: List = []
        self.hooks_started: int = 0
        # callables invoked after run finishes
        self.post_run_hooks: List = []
        # per-graph build ordinals (e.g. kafka read #) — deterministic
        # across ranks because every rank builds the same graph in the same
        # order, and reset with the graph (unlike module-level counters,
        # which would drift on notebook re-runs / second graphs)
        self.io_ordinals: dict = {}

    def clear(self) -> None:
        self.engine_graph = EngineGraph()
        self.ran = False
        self.ran_ops = set()
        self.pre_run_hooks = []
        self.hooks_started = 0
        self.post_run_hooks = []
        self.io_ordinals = {}

    def claim_io_ordinal(self, kind: str) -> int:
        n = self.io_ordinals.get(kind, 0)
        self.io_ordinals[kind] = n + 1
        return n


G = GraphHolder()
