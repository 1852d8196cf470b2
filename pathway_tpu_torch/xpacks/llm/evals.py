"""RAG answer-quality evaluation harness of the port (counterpart of
``pathway_tpu/xpacks/llm/evals.py``; reference:
integration_tests/rag_evals/{evaluator.py,test_eval.py,connector.py:31} —
spin up the QA app, query it over HTTP with a labeled QA set, score the
answers; the reference's headline chart is accuracy vs supporting-document
count for the adaptive strategy, docs/.adaptive-rag/article.py:85).

Fully offline design: the reference scores a remote GPT with RAGAS; this
harness instead separates WHAT the RAG loop controls (retrieval, context
growth, prompt plumbing, stop-when-answered) from raw LLM quality by using
a deterministic EXTRACTIVE reader as the chat model: given the prompt our
QA pipeline builds, it answers correctly iff the supporting fact is among
the supplied context documents, and says "No information found." otherwise.
Accuracy at n documents then measures exactly what the adaptive loop
varies — whether n documents of context contain the answer — and the
adaptive run's documents-used distribution measures its token savings, the
two numbers the reference's chart reports.

Scoring mirrors the reference's lenient comparator
(evaluator.py compare_sim_with_date): normalized exact-match OR
SequenceMatcher similarity above a threshold.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass, field
from difflib import SequenceMatcher
from typing import Dict, List, Optional, Sequence

__all__ = [
    "EvalCase",
    "EvalResult",
    "ExtractiveReaderChat",
    "make_fact_corpus",
    "score_answer",
    "run_eval",
    "accuracy_vs_doc_count",
]

NO_ANSWER = "No information found."

_ENTITIES = [
    "Freedonia", "Sylvania", "Osterlich", "Marxville", "Duckburg",
    "Grandview", "Ambrosia", "Borduria", "Syldavia", "Latveria",
    "Elbonia", "Genosha", "Krakozhia", "Molvania", "Petoria",
    "Brutopia", "Glubbdubdrib", "Laputa", "Lilliput", "Blefuscu",
    "Vulgaria", "Zubrowka", "Panem", "Wadiya",
]
_ATTRIBUTES = ["capital", "currency", "anthem", "flower"]
_VALUES = {
    "capital": ["Fredville", "Sylvan City", "Osterburg", "Marxton",
                "Duckfort", "Granditon", "Ambroton", "Bordopolis"],
    "currency": ["crown", "florin", "thaler", "ducat", "guilder",
                 "mark", "peso", "dinar"],
    "anthem": ["Hail Progress", "Onward Rivers", "Golden Dawn",
               "Mountain Song", "Steel Hymn", "Harbor Call",
               "Sunrise March", "Valley Chorus"],
    "flower": ["edelweiss", "tulip", "orchid", "lotus", "poppy",
               "iris", "dahlia", "aster"],
}
_FILLER = (
    "The region is known for its rolling hills and busy markets. "
    "Travelers praise the railways and the long summer festivals. "
    "Local historians debate the founding era at great length. "
)


@dataclass
class EvalCase:
    question: str
    label: str
    file: str


@dataclass
class EvalResult:
    accuracy: float
    cases: int
    correct: int
    avg_docs_used: Optional[float] = None
    answered_with_one_doc: Optional[float] = None
    records: List[dict] = field(default_factory=list)


def make_fact_corpus(
    out_dir: str, n_docs: int = 24, seed: int = 0, distractors: bool = True
) -> List[EvalCase]:
    """Write ``n_docs`` fact documents (each planting ONE unique fact
    inside filler prose) and return the QA set asking for every fact.

    ``distractors=True`` additionally writes one decoy per entity that
    uses the SAME entity and attribute words without stating the fact —
    so top-1 retrieval is genuinely contested and the accuracy-vs-doc-
    count curve has the reference chart's growing shape instead of being
    trivially flat (docs/.adaptive-rag/article.py:85)."""
    import os

    rng = random.Random(seed)
    cases: List[EvalCase] = []
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_docs):
        entity = _ENTITIES[i % len(_ENTITIES)]
        attribute = _ATTRIBUTES[i % len(_ATTRIBUTES)]
        value = rng.choice(_VALUES[attribute])
        fname = f"doc_{i:03d}.txt"
        fact = f"The {attribute} of {entity} is {value}."
        body = (
            f"Notes on {entity}. {_FILLER}{fact} {_FILLER}"
            f"Scholars continue to study {entity} closely."
        )
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(body)
        if distractors:
            # half the decoys are lexically STRONG (outrank the fact doc
            # at top-1), half weak — so the curve starts mid-range and
            # climbs with n like the reference chart, instead of sitting
            # at either extreme
            if i % 2 == 0:
                decoy = (
                    f"Travel guide for {entity}. The {attribute} question of "
                    f"{entity} fascinates visitors; every tour of {entity} "
                    f"debates the {attribute} at length, but the {attribute} "
                    f"itself is recorded in the registry of {entity}. {_FILLER}"
                )
            else:
                decoy = (
                    f"Travel guide for {entity}. Visitors ask about the "
                    f"{attribute} of {entity}, which this guide does not "
                    f"cover. {_FILLER}The registry holds such records. "
                    f"{_FILLER}"
                )
            with open(os.path.join(out_dir, f"decoy_{i:03d}.txt"), "w") as f:
                f.write(decoy)
        cases.append(
            EvalCase(
                question=f"What is the {attribute} of {entity}?",
                label=value,
                file=fname,
            )
        )
    return cases


class ExtractiveReaderChat:
    """Deterministic reader standing in for the chat model: extracts the
    asked-for fact from the CONTEXT EMBEDDED IN THE PROMPT (the same prompt
    our QA pipeline sends a real LLM), or refuses with the configured
    no-answer phrase — which is what drives the adaptive loop to widen."""

    batched = False

    def __init__(self):
        self.calls = 0
        self.func = self._reply  # chat-UDF surface (_call_chat uses .func)

    def _reply(self, messages) -> str:
        self.calls += 1
        prompt = messages[-1]["content"] if isinstance(messages, list) else str(messages)
        if not isinstance(prompt, str):
            prompt = str(prompt)
        q = re.search(r"Question: What is the (\w+) of (\w+)\?", prompt)
        if not q:
            return NO_ANSWER
        attribute, entity = q.group(1), q.group(2)
        m = re.search(
            rf"The {re.escape(attribute)} of {re.escape(entity)} is ([^.\n]+)\.",
            prompt,
        )
        return m.group(1).strip() if m else NO_ANSWER


def _normalize(s: str) -> str:
    return "".join(c for c in s.lower() if c.isalnum())


def score_answer(pred: str, label: str, min_similarity: float = 0.68) -> bool:
    """Lenient match (reference evaluator.py compare_sim_with_date):
    normalized containment or SequenceMatcher similarity."""
    a, b = _normalize(str(pred)), _normalize(str(label))
    if not b:
        return NO_ANSWER.lower() in str(pred).lower()
    if b in a:
        return True
    return SequenceMatcher(None, a, b).ratio() > min_similarity


def run_eval(answer_fn, cases: Sequence[EvalCase]) -> EvalResult:
    """Score ``answer_fn(question) -> answer`` over the QA set."""
    records = []
    correct = 0
    for case in cases:
        pred = answer_fn(case.question)
        ok = score_answer(pred, case.label)
        correct += ok
        records.append(
            {"question": case.question, "label": case.label,
             "pred": str(pred), "correct": bool(ok)}
        )
    return EvalResult(
        accuracy=correct / max(len(cases), 1),
        cases=len(cases),
        correct=correct,
        records=records,
    )


def accuracy_vs_doc_count(
    retrieve_fn,
    llm,
    cases: Sequence[EvalCase],
    doc_counts: Sequence[int] = (1, 2, 4, 8),
) -> Dict[int, float]:
    """The reference's headline chart (docs/.adaptive-rag/article.py:85):
    answer every question with a FIXED number of context documents and
    report accuracy per count.  ``retrieve_fn(question, k) -> [doc_text]``."""
    from .prompts import prompt_qa_geometric_rag
    from .question_answering import _call_chat

    curve: Dict[int, float] = {}
    for n in doc_counts:
        correct = 0
        for case in cases:
            docs = retrieve_fn(case.question, n)
            prompt = prompt_qa_geometric_rag(
                case.question, docs, information_not_found_response=NO_ANSWER
            )
            pred = _call_chat(llm, prompt)
            correct += score_answer(pred, case.label)
        curve[n] = correct / max(len(cases), 1)
    return curve
