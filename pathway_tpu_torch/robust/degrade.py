"""The degradation ladder (counterpart of
``pathway_tpu/robust/degrade.py``): the rung flags, ``ServeResult`` and
``record_degraded``, which counts on the port's
``pathway_serve_degraded_total{reason}`` and stamps the rung on the
active trace (the tail sampler keeps degraded serves).

=====================  ==========================  ==========================
failure                rung served                 response flag
=====================  ==========================  ==========================
reranker down /        stage-1 scores              ``rerank_skipped``
circuit open /
deadline tight
forward-index gather   previous-stage scores       ``late_interaction_skipped``
down / deadline tight
exact tail             resident-only IVF search    ``tail_skipped``
unavailable
index shard down       the live shards' merge      ``shard_skipped``
generator down         extractive answer           ``extractive_answer``
SLO burn firing +      empty result set            ``load_shed``
shed-class priority
stage 1 down           empty result set            ``retrieval_failed``
fabric host dead       a surviving host's rows     ``host_failover``
no healthy host        empty result set            ``replica_lost``
partition dead         surviving partitions' rows  ``partition_lost``
=====================  ==========================  ==========================
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .. import observe
from ..observe import trace as _trace

__all__ = [
    "EXTRACTIVE_ANSWER",
    "HOST_FAILOVER",
    "LATE_INTERACTION_SKIPPED",
    "LOAD_SHED",
    "PARTITION_LOST",
    "REPLICA_LOST",
    "RERANK_SKIPPED",
    "RETRIEVAL_FAILED",
    "SHARD_SKIPPED",
    "TAIL_SKIPPED",
    "ServeResult",
    "extractive_answer",
    "record_degraded",
]

RERANK_SKIPPED = "rerank_skipped"
LATE_INTERACTION_SKIPPED = "late_interaction_skipped"
TAIL_SKIPPED = "tail_skipped"
SHARD_SKIPPED = "shard_skipped"
EXTRACTIVE_ANSWER = "extractive_answer"
LOAD_SHED = "load_shed"
RETRIEVAL_FAILED = "retrieval_failed"
HOST_FAILOVER = "host_failover"
REPLICA_LOST = "replica_lost"
PARTITION_LOST = "partition_lost"

_degraded_counters: Dict[str, observe.Counter] = {}


def record_degraded(reason: str, n: int = 1) -> None:
    """Count ``n`` degraded serves for rung ``reason`` and stamp the
    rung on the active trace."""
    c = _degraded_counters.get(reason)
    if c is None:
        c = _degraded_counters[reason] = observe.counter("pathway_serve_degraded_total", reason=reason)
    c.inc(n)
    t = _trace.current()
    if t is not None:
        t.set_status(reason)


class ServeResult(list):
    """Serve rows plus ladder metadata.  Compares equal to a plain list
    of the same rows; carries ``degraded`` — the rung flags of this serve,
    deduplicated in order — and ``meta`` (e.g. ``index_generation``), which
    mirrors the flags under ``degraded_reasons``."""

    __slots__ = ("degraded", "meta")

    def __init__(
        self,
        rows: Iterable[Any] = (),
        degraded: Sequence[str] = (),
        meta: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(rows)
        deduped: List[str] = []
        for flag in degraded:
            if flag not in deduped:
                deduped.append(flag)
        self.degraded = tuple(deduped)
        self.meta = dict(meta or {})
        if self.degraded and "degraded_reasons" not in self.meta:
            self.meta["degraded_reasons"] = list(self.degraded)

    @property
    def ok(self) -> bool:
        return not self.degraded


def _sentences(text: str) -> List[str]:
    out: List[str] = []
    cur: List[str] = []
    for ch in str(text):
        cur.append(ch)
        if ch in ".!?":
            s = "".join(cur).strip()
            if s:
                out.append(s)
            cur = []
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


def extractive_answer(question: str, docs: Sequence[str], max_sentences: int = 2) -> str:
    """Generator-down rung: the sentences of the top passages sharing the
    most terms with the question (ties by passage rank); with no overlap,
    the leading sentence of the first passage that has one."""
    q_terms = {t for t in str(question).lower().split() if len(t) > 2}
    scored: List[Tuple[float, int, str]] = []
    for rank, doc in enumerate(docs):
        for sent in _sentences(doc):
            terms = set(sent.lower().split())
            overlap = len(q_terms & terms)
            if overlap:
                scored.append((-(overlap / (1 + len(terms) ** 0.5)), rank, sent))
    scored.sort()
    picked = [s for _, _, s in scored[:max_sentences]]
    if not picked:
        picked = next((lead for lead in (_sentences(d)[:1] for d in docs) if lead), [])
    return " ".join(picked)
