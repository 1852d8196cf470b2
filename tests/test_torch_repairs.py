"""Three port faults against the reference, each repaired:

1. rerank stages take a float ``over_fetch`` and a ``budget_fraction``
   (``pathway_tpu/ops/retrieve_rerank.py:137-161``): pool widths
   ``max(ceil(over_fetch * k), k, 1)``, each stage handed its share of
   the remaining deadline and that share recorded on the trace;
2. public callables of ported modules that the port lacked (an explicit
   list checked on the port's source, and each one's behaviour);
3. ``broadcast_obj`` answers the local value when the ``dist.broadcast``
   site faults, as ``tests/test_robust.py:1683-1705`` asserts of the
   reference.
"""

import ast
import inspect
import math
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pathway_tpu.observe import trace as ref_trace
from pathway_tpu.ops import retrieve_rerank as ref_rr
from pathway_tpu.robust import Deadline as RefDeadline
from pathway_tpu_torch import config, observe
from pathway_tpu_torch.observe import trace
from pathway_tpu_torch.ops import retrieve_rerank as port_rr
from pathway_tpu_torch.parallel import distributed as dist
from pathway_tpu_torch.robust import Deadline, inject

_PORT = Path(__file__).resolve().parents[1] / "pathway_tpu_torch"


# -- fault 1 -------------------------------------------------------------------------

@pytest.mark.parametrize("over_fetch", [None, 0.5, 1.0, 1.5, 2.25, 4.0, 7.3])
@pytest.mark.parametrize("k", [1, 3, 10, 32])
def test_stage_pool_widths_for_a_float_over_fetch(over_fetch, k):
    for name in ("RerankStage", "CrossEncoderStage"):
        got = getattr(port_rr, name)(over_fetch=over_fetch).width(k)
        assert got == getattr(ref_rr, name)(over_fetch=over_fetch).width(k)
    got = port_rr.LateInteractionStage(None, over_fetch=over_fetch, budget_fraction=0.5)
    want = ref_rr.LateInteractionStage(None, over_fetch=over_fetch, budget_fraction=0.5)
    assert got.width(k) == want.width(k) == max(math.ceil((over_fetch or 4.0) * k), k, 1)
    assert got.budget_fraction == want.budget_fraction == 0.5
    # an explicit count overrides the factor
    assert port_rr.CrossEncoderStage(candidates=7, over_fetch=over_fetch).width(k) == 7


def _echo_stage(module, name, **kw):
    """A stage that keeps the rows it is given and records the deadline
    it was handed."""

    class Echo(module.RerankStage):
        seen = []

        def submit(self, pipeline, queries, cand_rows, keep, deadline,
                   query_tokens=None, query_mask=None, pool_width=None):
            Echo.seen.append((len(cand_rows[0]), None if deadline is None else deadline.remaining_s()))
            return lambda: ([row[:keep] for row in cand_rows], None)

    Echo.name = name
    return Echo(**kw)


def _run_chain(module, trace_mod, deadline_cls):
    first = _echo_stage(module, "first", over_fetch=2.5, budget_fraction=0.5)
    second = _echo_stage(module, "second", over_fetch=1.5, budget_fraction=0.25)
    pipe = module.RetrieveRerankPipeline(types.SimpleNamespace(), k=4, stages=[first, second])
    hits = [[(key, 1.0 - key / 100) for key in range(40)] for _ in range(2)]
    ctx = trace_mod.start_trace("repair", sample=False)
    with trace_mod.use(ctx):
        out = pipe._submit_chain(["q0", "q1"], hits, 4, deadline=deadline_cls.after_ms(10_000))()
    spans = {s[2]: s[6] for s in ctx.spans}
    return first.seen, second.seen, [list(r) for r in out], spans


def test_stages_get_their_share_of_the_deadline_on_the_trace():
    port = _run_chain(port_rr, trace, Deadline)
    ref = _run_chain(ref_rr, ref_trace, RefDeadline)
    for (first, second, rows, spans) in (port, ref):
        # pool widths: ceil(2.5 * 4) = 10 rows to the first stage, which
        # keeps ceil(1.5 * 4) = 6 for the second, which keeps k = 4
        assert [w for w, _ in first] == [10] and [w for w, _ in second] == [6]
        assert all(len(r) == 4 for r in rows)
        # each stage's deadline is its fraction of what remained
        assert 0 < first[0][1] <= 5.0 and 0 < second[0][1] <= 0.25 * 10.0
        assert 0 < spans["stage.first"]["budget_ms"] <= 5000.0
        assert 0 < spans["stage.second"]["budget_ms"] <= 2500.0
        assert spans["stage.first"]["keep"] == 6 and spans["stage.second"]["keep"] == 4
    assert port[2] == ref[2]


def test_stage_without_fraction_gets_the_whole_deadline():
    stage = port_rr.RerankStage()
    d = Deadline.after_ms(1000)
    assert stage.budget_fraction is None and stage.sub_deadline(d) is d and stage.sub_deadline(None) is None
    half = port_rr.RerankStage(budget_fraction=0.5).sub_deadline(d)
    assert half.remaining_s() <= 0.5 and half.remaining_s() <= d.remaining_s()


# -- fault 2 -------------------------------------------------------------------------

# (port module file, class or None, callable) that the reference has
_SURFACE = [
    ("robust/retry.py", "CircuitBreaker", "reset"),
    ("ops/dispatch_counter.py", "DispatchCounter", "reset"),
    ("ops/dispatch_counter.py", "DispatchCounter", "snapshot"),
    ("cache/result.py", "ResultCache", "clear"),
    ("observe/trace.py", None, "set_sample"),
    ("observe/trace.py", None, "sample_rate"),
    ("observe/histogram.py", "LatencyHistogram", "merge_from"),
    ("observe/hbm.py", None, "tree_nbytes"),
    ("index/forward.py", None, "forward_tokens_per_doc"),
    ("index/forward.py", None, "forward_quant_mode"),
    ("parallel/shards.py", None, "serve_shards"),
    ("config.py", None, "get"),
    ("models/generator.py", "TextGenerator", "__init__"),
]


def _defined(tree, cls, name):
    scope = tree.body
    if cls is not None:
        scope = next(n.body for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    return next((n for n in scope if isinstance(n, ast.FunctionDef) and n.name == name), None)


@pytest.mark.parametrize("path,cls,name", _SURFACE)
def test_public_callable_exists_in_the_port(path, cls, name):
    fn = _defined(ast.parse((_PORT / path).read_text()), cls, name)
    assert fn is not None, f"{path}: {cls}.{name} missing"
    args = [a.arg for a in fn.args.args]
    # the keywords the reference's callers pass
    expect = {"serve_shards": ["default"], "get": ["key", "fallback"], "__init__": ["checkpoint_path"]}
    assert set(expect.get(name, [])) <= set(args)


def test_circuit_breaker_reset():
    from pathway_tpu_torch.robust import CircuitBreaker

    b = CircuitBreaker("repair-reset", failure_threshold=2, reset_s=60)
    b.record_failure()
    b.record_failure()
    assert b.state == "open" and not b.allow()
    b.reset()
    assert b.state == "closed" and b.allow()


def test_dispatch_counter_reset_and_snapshot():
    from pathway_tpu_torch.ops.dispatch_counter import DispatchCounter, record_dispatch, record_fetch

    with DispatchCounter() as c:
        record_dispatch("a")
        record_dispatch("b", shards=3)
        record_fetch("a")
        assert c.snapshot() == (2, 1)
        c.reset()
        assert c.snapshot() == (0, 0) and c.events == [] and c.physical_dispatches == 0


def test_result_cache_clear():
    from pathway_tpu_torch.cache.result import ResultCache

    rc = ResultCache(max_bytes=1 << 20)
    assert rc.put_row("q", 1, 10, [(1, 0.5)]) and len(rc) == 1
    rc.clear()
    assert len(rc) == 0 and rc.get_rows([("q", 1)], 10) is None


def test_trace_set_sample_and_sample_rate():
    before = trace.sample_rate()
    try:
        trace.set_sample(0.0)
        assert trace.sample_rate() == 0.0 and trace.start_trace("x") is None
        trace.set_sample(7.0)
        assert trace.sample_rate() == 1.0 and trace.start_trace("x") is not None
        trace.set_sample(-1)
        assert trace.sample_rate() == 0.0
    finally:
        trace.set_sample(before)


def test_latency_histogram_merge_from():
    from pathway_tpu.observe.histogram import LatencyHistogram as RefHist
    from pathway_tpu_torch.observe.histogram import LatencyHistogram

    port = (LatencyHistogram(), LatencyHistogram())
    ref = (RefHist(), RefHist())
    for (a, b) in (port, ref):
        for ns in (1_000, 50_000, 3_000_000):
            a.observe_ns(ns)
        for ns in (2_000, 3_000_000):
            b.observe_ns(ns)
        a.merge_from(b)
    assert port[0].snapshot() == ref[0].snapshot() and port[0].count == 5


def test_hbm_tree_nbytes():
    from pathway_tpu.observe.hbm import tree_nbytes as ref_nbytes
    from pathway_tpu_torch.observe.hbm import tree_nbytes

    arrays = {"a": np.zeros((4, 3), np.float32), "b": [np.zeros(5, np.int8), (np.zeros(2), "skip")]}
    assert tree_nbytes(arrays) == ref_nbytes(arrays) == 48 + 5 + 16
    assert tree_nbytes({"t": torch.zeros(4, 3), "u": [torch.zeros(2, dtype=torch.bfloat16)]}) == 52


def test_forward_knob_helpers(monkeypatch):
    from pathway_tpu.index import forward_quant_mode as ref_quant, forward_tokens_per_doc as ref_tokens
    from pathway_tpu_torch.index import forward_quant_mode, forward_tokens_per_doc

    monkeypatch.delenv("PATHWAY_FORWARD_TOKENS", raising=False)
    monkeypatch.delenv("PATHWAY_FORWARD_QUANT", raising=False)
    assert forward_tokens_per_doc() == ref_tokens() == 16
    assert forward_tokens_per_doc(24) == ref_tokens(24) == 24
    assert forward_quant_mode("none") == ref_quant("none") == "none"
    monkeypatch.setenv("PATHWAY_FORWARD_TOKENS", "8")
    monkeypatch.setenv("PATHWAY_FORWARD_QUANT", "none")
    assert forward_tokens_per_doc(24) == ref_tokens(24) == 8
    assert forward_quant_mode() == ref_quant() == "none"


def test_serve_shards_default_and_config_fallback(monkeypatch):
    from pathway_tpu import config as ref_config
    from pathway_tpu.parallel.shards import serve_shards as ref_serve_shards
    from pathway_tpu_torch.parallel import serve_shards

    monkeypatch.delenv("PATHWAY_SERVE_SHARDS", raising=False)
    assert serve_shards() == ref_serve_shards() == 0
    assert serve_shards(4) == ref_serve_shards(4) == 4
    # a site default is clamped like the environment
    assert config.get("serve.shards", fallback=10**6) == ref_config.get("serve.shards", fallback=10**6) == 4096
    monkeypatch.setenv("PATHWAY_SERVE_SHARDS", "3")
    assert serve_shards(4) == ref_serve_shards(4) == 3
    assert config.get("serve.shards", fallback=9) == 3


def test_text_generator_takes_checkpoint_path():
    from pathway_tpu_torch.models.generator import TextGenerator

    assert "checkpoint_path" in inspect.signature(TextGenerator).parameters
    kw = dict(dimension=16, n_layers=1, n_heads=2, max_length=32, vocab_size=128, kv_cache=None, eos_id=None,
              device="cpu", dtype=torch.float32)
    a = TextGenerator(**kw)
    b = TextGenerator(checkpoint_path="/nonexistent", **kw)
    # as in the reference, the path names no weights: the seeded init
    assert all(torch.equal(x, y) for x, y in zip(a.module.state_dict().values(), b.module.state_dict().values()))


# -- fault 3 -------------------------------------------------------------------------

def test_faulted_broadcast_answers_the_local_value():
    deg = observe.counter("pathway_dist_degraded_total", site="broadcast")
    before = deg.value
    with inject.armed("dist.broadcast", "raise", times=1):
        assert dist.broadcast_obj(42, name="repair-bc-raise") == 42
    with inject.armed("dist.broadcast", "delay", delay_s=0.02):
        assert dist.broadcast_obj(43, name="repair-bc-delay") == 43
    t0 = time.monotonic()
    with inject.armed("dist.broadcast", "hang", hang_s=30.0):
        assert dist.broadcast_obj(44, name="repair-bc-hang", deadline=Deadline(0.0)) == 44
    assert time.monotonic() - t0 < 2.0
    assert deg.value == before + 2


def test_faulted_barrier_degrades_counted():
    deg = observe.counter("pathway_dist_degraded_total", site="barrier")
    before = deg.value
    with inject.armed("dist.barrier", "raise", times=1):
        assert dist.barrier("repair-raise") is False
    with inject.armed("dist.barrier", "delay", delay_s=0.02):
        assert dist.barrier("repair-delay") is True
    t0 = time.monotonic()
    with inject.armed("dist.barrier", "hang", hang_s=30.0):
        assert dist.barrier("repair-hang", deadline=Deadline(0.0)) is False
    assert time.monotonic() - t0 < 2.0
    assert deg.value == before + 2
