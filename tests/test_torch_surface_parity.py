"""The surface the port gained to match the reference, held against
``pathway_tpu`` on the CPU:

- the knob table's introspection (``describe``, ``markdown_table``, the
  CLI in its three formats) and a poisoned ``load()``;
- ``observe.count`` / ``enabled``, the module-level ``slo.evaluate``,
  ``render_prometheus`` classic and OpenMetrics (exemplars on bucket
  samples only), the metrics server's negotiation, the ``/serve_stats``
  columns (``generators``, ``slo``);
- ``DeviceKnnIndex.search(..., candidate_keys=)``: keys exactly, f32
  scores within 1e-5, ties allowed to swap only within 1e-5;
- ``OffsetAntichain``'s reads and ``DispatchCounter(max_events=)``.

Scrapes are compared line for line over the series this file records
(each carries a probe label), the exemplars' unix stamps left out: both
packages render the same text for the same events.
"""

import json
import re
import urllib.request

import numpy as np
import pytest

from pathway_tpu import config as ref_config
from pathway_tpu import observe as ref_observe
from pathway_tpu.io._offsets import OffsetAntichain as RefAntichain
from pathway_tpu.observe import slo as ref_slo
from pathway_tpu.ops import dispatch_counter as ref_dc
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.robust import inject as ref_inject
from pathway_tpu_torch import config, observe
from pathway_tpu_torch.internals.metrics import MetricsServer
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._offsets import OffsetAntichain
from pathway_tpu_torch.observe import slo, trace
from pathway_tpu_torch.ops import dispatch_counter as dc
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.robust import CircuitBreaker, inject
from pathway_tpu_torch.serve import ServeScheduler

from .test_torch_ivf import assert_same_ranking
from .test_torch_rerank import QUERIES, _pipes, stack  # noqa: F401 - fixture

TOL = 1e-5  # f32 scores across the packages; keys swap only between scores tied within it

# The port's knob docs that differ from the reference's, each with its reason.
DOC_DIFFERS = {
    "cache.embed": "the port has no fused-kernel split: its search-only path is what changes score bits",
    "decode.step_bucket": "the port compiles nothing: a chunk is a dispatch, not a compiled program",
    "generator.kv": "the port's doc says what its switch selects: the KV-cache decode or the full re-attend",
    "native.disable": "the port's plain versions replace its own host libraries, not one native library",
    "observe.enabled": "the port's profiler has a switch of its own (observe.profile_sample)",
    "ops.donation_guard": "the port has no buffer donation: its guard stamps in-place writes",
    "ops.donation_guard_strict": "the port has no buffer donation: its guard stamps in-place writes",
    "ops.recompile_limit": "the port compiles nothing: the budget is on shape signatures per callable",
    "parallel.coordinator_address": "the port's coordinator is its own control plane, not JAX's",
    "robust.faults": "the port's example uses a mode both packages accept (raise)",
    "serve.shed": "the port's doc leaves out the reference's round history",
}
_FIELDS = ("key", "env", "type", "default", "bounds", "mutability")


# -- config ----------------------------------------------------------------------------


def test_describe_rows_equal_the_reference_row_for_row():
    mine, theirs = config.describe(), ref_config.describe()
    assert [r["key"] for r in mine] == [r["key"] for r in theirs]
    assert len(mine) == len(config.knobs()) == len(config.registry())
    for m, t in zip(mine, theirs):
        assert {f: m[f] for f in _FIELDS} == {f: t[f] for f in _FIELDS}, m["key"]
        assert (m["doc"] == t["doc"]) == (m["key"] not in DOC_DIFFERS), m["key"]
    for knob in config.knobs():
        assert knob.default_doc() == ref_config.registry()[knob.key].default_doc(), knob.key


def test_markdown_table_equals_the_reference_but_for_the_listed_docs():
    mine = config.markdown_table().split("\n")
    theirs = ref_config.markdown_table().split("\n")
    assert len(mine) == len(theirs) == len(config.knobs()) + 2
    for m, t in zip(mine, theirs):
        key = m.split("`")[1] if m.startswith("| `") else None
        if key in DOC_DIFFERS:
            assert m.rsplit(" | ", 1)[0] == t.rsplit(" | ", 1)[0]  # every cell but the doc
        else:
            assert m == t


def test_cli_text_and_json(capsys):
    """The reference's own CLI cases (``tests/test_config.py``)."""
    assert config.main(["--format", "text"]) == 0
    out = capsys.readouterr().out
    assert "serve.coalesce_us" in out and "PATHWAY_SERVE_COALESCE_US" in out
    assert config.main(["--format", "json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    by_key = {r["key"]: r for r in rows}
    assert by_key["serve.coalesce_us"]["mutability"] == "dynamic"
    assert by_key["decode.kv_quant"]["mutability"] == "static"
    assert len(rows) == len(config.knobs())
    assert rows == config.describe()


def test_cli_markdown_matches_helper(capsys):
    assert config.main(["--format", "markdown"]) == 0
    assert capsys.readouterr().out.strip() == config.markdown_table().strip()


def test_cli_text_header_equals_the_reference(capsys):
    config.main(["--format", "text"])
    mine = capsys.readouterr().out.split("\n")[0]
    ref_config.main(["--format", "text"])
    assert mine == capsys.readouterr().out.split("\n")[0]


def test_poisoned_load_serves_the_last_good_values(monkeypatch):
    """A poisoned value degrades to the declared default in both
    packages; an armed ``config.load`` returns the last-good document,
    counted once, never raised; disarmed, the reload works again."""
    monkeypatch.setenv("PATHWAY_CACHE_RESULT_TTL_S", "sixty")
    monkeypatch.setenv("PATHWAY_SERVE_MAX_BATCH", "32")
    docs = []
    for cfg, obs, inj in ((ref_config, ref_observe, ref_inject), (config, observe, inject)):
        clean = cfg.load()
        assert clean["cache.result_ttl_s"] == cfg.registry()["cache.result_ttl_s"].default
        assert clean["serve.max_batch"] == 32
        before = obs.counter("pathway_config_load_failures_total").value
        inj.load_env("config.load=raise")
        try:
            cfg._warned = {t for t in cfg._warned if not t.startswith("load:")}
            degraded = cfg.load()
        finally:
            inj.disarm()
        assert degraded == clean
        assert obs.counter("pathway_config_load_failures_total").value == before + 1
        assert cfg.load() == clean
        docs.append(clean)
    assert docs[0] == docs[1]


# -- observe ---------------------------------------------------------------------------


def test_count_and_enabled_equal_the_reference():
    probe = "parity_count_probe"
    for obs in (ref_observe, observe):
        assert obs.enabled() is True
        obs.count("pathway_serve_degraded_total", 2, reason=probe)
        obs.set_enabled(False)
        try:
            assert obs.enabled() is False
            obs.count("pathway_serve_degraded_total", 5, reason=probe)
        finally:
            obs.set_enabled(True)
    assert observe.counter("pathway_serve_degraded_total", reason=probe).value == ref_observe.counter(
        "pathway_serve_degraded_total", reason=probe
    ).value


def _feed(obs, probe):
    """One fixed series of events under ``probe``, with exemplars
    stamped on three buckets (the same trace ids in both packages)."""
    h = obs.histogram("pathway_serve_stage_seconds", stage=probe)
    for ns in (900, 5_000, 70_000_000, 3 * 10**9):
        h.observe_ns(ns)
    for ns, tid in ((900, "0a1b"), (70_000_000, "ff00"), (3 * 10**9, "c0de")):
        h.set_exemplar(ns, tid)
    obs.counter("pathway_serve_degraded_total", reason=probe).inc(3)
    obs.gauge("pathway_serve_replica_depth", scheduler=probe, replica="0").set(1.5)


_STAMP = re.compile(r" [0-9]+\.[0-9]+$")

# The reference's exposition parser (``tests/test_observe.py``), copied.
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"  # metric name
    r"(\{(?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?)*\})?"  # labels
    r" (NaN|[+-]?Inf|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_EXEMPLAR_RE = re.compile(r'^\{trace_id="[0-9a-f]+"\} ' r"[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)? [0-9]+\.[0-9]+$")


def _parse_exposition(body: str):
    samples = []
    types = {}
    for raw in body.split("\n"):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            assert len(parts) == 4, f"malformed TYPE line: {raw!r}"
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        if " # " in line:
            line, exemplar = line.split(" # ", 1)
            assert _EXEMPLAR_RE.match(exemplar), f"malformed exemplar suffix: {raw!r}"
            assert "_bucket" in line.split()[0], f"exemplar on a non-bucket sample: {raw!r}"
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable sample line: {raw!r}"
        name, labelblob, value = m.group(1), m.group(2), m.group(3)
        samples.append((name, frozenset(_LABEL_RE.findall(labelblob or "")), float(value)))
    return samples, types


@pytest.mark.parametrize("openmetrics", [False, True])
def test_scrapes_equal_the_reference_line_for_line(openmetrics):
    probe = f"parity_scrape_probe_{int(openmetrics)}"
    scrapes = []
    for obs in (ref_observe, observe):
        _feed(obs, probe)
        lines = [line for line in obs.render_prometheus(openmetrics=openmetrics) if probe in line]
        scrapes.append([_STAMP.sub("", line) if " # " in line else line for line in lines])
    assert scrapes[0] == scrapes[1]
    mine = scrapes[1]
    with_ex = [line for line in mine if " # " in line]
    if openmetrics:
        assert len(with_ex) == 3 and all("_bucket{" in line for line in with_ex)
        assert {line.split('trace_id="')[1].split('"')[0] for line in with_ex} == {"0a1b", "ff00", "c0de"}
        body = [line for line in observe.render_prometheus(openmetrics=True) if probe in line]
        _parse_exposition("\n".join(body))
    else:
        assert with_ex == [] and not any("# {" in line for line in mine)
        _parse_exposition("\n".join(mine))


def test_metrics_server_negotiates_exemplars_of_kept_traces(stack):
    """A degraded serve is kept, and its spans' exemplars ride on the
    OpenMetrics scrape only: the classic scrape stays ``version=0.0.4``
    with no exemplar token, and every exemplar names a kept trace."""
    _, pipe = _pipes(stack, "cross_encoder")
    pipe._breaker = CircuitBreaker("parity-exemplar-keep", failure_threshold=100, reset_s=60)
    observe.reset()  # drops every exemplar stamped before (reset keeps the series)
    trace.reset()
    with inject.armed("rerank.dispatch", "raise"):
        with ServeScheduler(pipe, window_us=10_000, result_cache=None) as sched:
            got = sched.serve([QUERIES[1]])
    assert got.degraded == ("rerank_skipped",)
    server = MetricsServer(G.engine_graph, port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        classic = urllib.request.urlopen(f"{base}/metrics", timeout=10)
        assert "version=0.0.4" in classic.headers["Content-Type"]
        classic_body = classic.read().decode()
        assert " # {" not in classic_body
        _parse_exposition(classic_body)
        req = urllib.request.Request(f"{base}/metrics", headers={"Accept": "application/openmetrics-text"})
        om = urllib.request.urlopen(req, timeout=10)
        assert "openmetrics-text" in om.headers["Content-Type"]
        om_body = om.read().decode()
        assert om_body.rstrip().endswith("# EOF")
        _parse_exposition(om_body.replace("# EOF", ""))
        ids = re.findall(r' # \{trace_id="([0-9a-f]+)"\}', om_body)
        assert ids and set(ids) <= set(trace._kept)
        stats = json.loads(urllib.request.urlopen(f"{base}/serve_stats", timeout=10).read())
        assert {"generators", "slo"} <= set(stats)
        doc = json.loads(urllib.request.urlopen(f"{base}/slo", timeout=10).read())
        assert set(doc) == set(slo.evaluate())
    finally:
        server.stop()
        trace.reset()


class _GenProvider:
    """A provider of samples labeled ``generator=``, as the decoders'."""

    def __init__(self, name):
        self.name = name

    def observe_metrics(self):
        yield ("gauge", "pathway_decode_slots_active", {"generator": self.name}, 3.0)
        yield ("counter", "pathway_decode_tokens_total", {"generator": self.name, "phase": "decode"}, 17.0)


def test_serve_stats_columns_equal_the_reference(monkeypatch):
    monkeypatch.setenv("PATHWAY_SLO_TICK_S", "0")
    keep = []
    snaps = []
    for obs, slo_mod in ((ref_observe, ref_slo), (observe, slo)):
        slo_mod.set_engine(None)
        keep.append(_GenProvider("parity_gen_probe"))
        obs.register_provider(keep[-1])
        snaps.append(obs.snapshot())
    ref_snap, snap = snaps
    assert list(snap) == list(ref_snap)
    assert snap["generators"]["parity_gen_probe"] == ref_snap["generators"]["parity_gen_probe"] == {
        "pathway_decode_slots_active": 3.0,
        'pathway_decode_tokens_total{phase="decode"}': 17.0,
    }
    assert set(snap["slo"]) == set(ref_snap["slo"])
    assert set(snap["slo"]["slos"]) == set(ref_snap["slo"]["slos"])
    for name, row in snap["slo"]["slos"].items():
        assert set(row) == set(ref_snap["slo"]["slos"][name]), name
    json.dumps(snap)


def test_module_level_slo_evaluate_equals_the_reference(monkeypatch):
    monkeypatch.setenv("PATHWAY_SLO_TICK_S", "0")
    docs = []
    for obs, slo_mod in ((ref_observe, ref_slo), (observe, slo)):
        obs.reset()
        engine = slo_mod.set_engine(None)
        h = obs.histogram("pathway_serve_request_seconds")
        for _ in range(10):
            h.observe_ns(1_000_000)
        slo_mod.evaluate(max_age_s=0)
        obs.counter("pathway_serve_degraded_total", reason="parity_slo_eval_probe").inc(6)
        h.observe_ns(1_000_000)
        doc = slo_mod.evaluate(max_age_s=0)
        assert doc["slos"] == engine.evaluate()["slos"]
        docs.append({
            name: (row["state"], row["good"], row["total"], row["windows"]["fast"]["burn_rate"])
            for name, row in doc["slos"].items()
        } | {"should_shed": doc["should_shed"], "alerting": doc["alerting"]})
    assert docs[0] == docs[1]
    assert docs[1]["serve_availability"][0] == "firing"
    slo.reset()
    ref_slo.reset()


# -- filtered exact search --------------------------------------------------------------


def _knn_pair(n=200, d=32, seed=5, metric="cos"):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.choice(10_000, size=n, replace=False)]
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    ref = RefKnn(dimension=d, metric=metric, initial_capacity=256)
    ref.add(keys, vecs)
    port = DeviceKnnIndex(d, metric=metric, initial_capacity=256, device="cpu")
    port.add(keys, vecs)
    queries = rng.normal(size=(6, d)).astype(np.float32)
    return ref, port, keys, queries, rng


def _same_rows(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert_same_ranking(w, g, tie=TOL, atol=TOL)


@pytest.mark.parametrize("metric", ["cos", "dot"])
def test_filtered_search_equals_the_reference(metric):
    ref, port, keys, queries, rng = _knn_pair(metric=metric)
    k = 10
    plain = port.search(queries, k)
    allow = []
    for qi, row in enumerate(plain):
        if qi % 3 == 2:
            allow.append(None)  # no filter on this row
        else:
            top = [key for key, _ in row[:4]]
            allow.append(top + [int(x) for x in rng.choice(keys, size=20, replace=False)])
    want, got = ref.search(queries, k, candidate_keys=allow), port.search(queries, k, candidate_keys=allow)
    _same_rows(want, got)
    for qi, row in enumerate(got):
        expect = [kv for kv in plain[qi] if allow[qi] is None or kv[0] in set(allow[qi])]
        assert [key for key, _ in row] == [key for key, _ in expect]
        if allow[qi] is None:
            assert len(row) == k
        else:
            assert 4 <= len(row) <= k  # filtered within the top k: a row may hold fewer


def test_filtered_search_after_remove_and_past_the_live_rows():
    ref, port, keys, queries, rng = _knn_pair(n=40)
    first = port.search(queries, 5)
    gone = sorted({key for row in first for key, _ in row[:2]})
    ref.remove(gone)
    port.remove(gone)
    allow = [list(keys) if qi % 2 else None for qi in range(len(queries))]
    for k in (5, 64):  # 64 > the 40 - len(gone) live rows
        want, got = ref.search(queries, k, candidate_keys=allow), port.search(queries, k, candidate_keys=allow)
        _same_rows(want, got)
        for row in got:
            assert not {key for key, _ in row} & set(gone)
            assert len(row) == min(k, 40 - len(gone))
    # an allow-list of removed keys only: nothing comes back
    only_gone = [gone] * len(queries)
    assert port.search(queries, 5, candidate_keys=only_gone) == ref.search(queries, 5, candidate_keys=only_gone)
    assert all(row == [] for row in port.search(queries, 5, candidate_keys=only_gone))


# -- offsets and the dispatch counter ---------------------------------------------------


def test_offset_antichain_reads_equal_the_reference():
    steps = [("a", 3), ("b", 1), ("a", 2), ("c", 7), ("b", 4)]
    results = []
    for cls in (RefAntichain, OffsetAntichain):
        x = cls()
        for part, off in steps:
            x.advance(part, off)
        y = cls.from_dict({"a": 3, "b": 2})
        z = cls.from_dict(None)
        results.append((
            x.get("a"), x.get("zz"), x.get("zz", -1), sorted(x.items()), x.dominates(y), y.dominates(x),
            z.dominates(z), x.dominates(z), len(z), sorted(x.merge(y).items()), y == cls({"a": 3, "b": 2}),
        ))
    assert results[0] == results[1]
    assert results[1][:5] == (3, None, -1, [("a", 3), ("b", 4), ("c", 7)], True)


@pytest.mark.parametrize("mode", ["logical", "physical"])
def test_dispatch_counter_max_events_equals_the_reference(mode):
    out = []
    for mod, obs in ((ref_dc, ref_observe), (dc, observe)):
        with mod.DispatchCounter(3, mode) as c:
            for i in range(4):
                mod.record_dispatch(f"parity_dc_{i}", shards=2)
            mod.record_fetch("parity_dc_f")
            ring = [line for line in obs.render_prometheus() if 'ring="dispatch_counter"' in line]
        out.append((c.max_events, c.mode, c.dispatches, c.fetches, c.physical_dispatches, c.events,
                    c.events_dropped, ring))
    assert out[0] == out[1]
    assert out[1][5] == [("dispatch", f"parity_dc_{i}") for i in range(3)] and out[1][6] == 2
    assert 'pathway_observe_ring_capacity{ring="dispatch_counter"} 3' in out[1][7]
    assert dc.DispatchCounter().max_events == ref_dc.DispatchCounter().max_events == 4096
    with pytest.raises(ValueError):
        dc.DispatchCounter(mode="both")


# -- chip_smoke.py phase 28 on the CPU --------------------------------------------------


def test_chip_smoke_surface_phase_on_the_cpu():
    """``chip_smoke.py`` phase 28 at 4,096 rows with a small f32 encoder
    and generator on the CPU: the phase raises on any failed check
    (filtered rows against the unfiltered top k filtered by their lists,
    removed keys never returned, scheduled serves against the direct
    serve, the decoder burst against solo ``generate``, the decode-row
    kernels at the burst's shape against their plain versions, exemplars
    on bucket samples naming kept traces, the ``/serve_stats`` columns,
    the knob CLI's markdown in a subprocess)."""
    import importlib.util
    from pathlib import Path

    import torch

    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    enc = SentenceEncoder(dimension=64, n_layers=1, n_heads=2, max_length=32, vocab_size=4096, seed=1,
                          dtype=torch.float32, device="cpu")
    docs = chip_smoke.corpus(chip_smoke.N_DOCS)
    n = 4096
    keys = chip_smoke.keys_for(n)
    exact = DeviceKnnIndex(64, metric="cos", initial_capacity=n, device="cpu")
    exact.add_from_device(keys, enc.encode_to_device(docs[:n]))
    ivf = IvfKnnIndex(64, metric="cos", device="cpu")
    ivf.build_from_matrix(keys, exact._matrix[:n])
    gen = TextGenerator(dimension=32, n_layers=1, n_heads=2, max_length=64, vocab_size=512, dtype=torch.float32,
                        device="cpu", kv_cache=None, eos_id=None)
    try:
        launches, shape, decode, rows = chip_smoke.surface_phase("[cpu]", enc, exact, ivf, docs, keys,
                                                                 dev=torch.device("cpu"), gen=gen)
    finally:
        trace.reset()
    # the kernels' plain versions on the CPU: no launch counted, nothing timed
    assert (launches, shape, decode) == (0, None, {"add_layer_norm_rows": 0, "tied_readout": 0})
    assert rows["add_layer_norm_rows"]["max_abs_err"] <= chip_smoke.LN_ATOL
    assert rows["tied_readout"]["max_abs_err"] <= chip_smoke.READOUT_ATOL
    assert all(r["ms"] is None and r["plain_ms"] is None for r in rows.values())
    assert len(exact) == n
