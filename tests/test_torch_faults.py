"""Five faults the port had against the reference, each repaired and held
to the reference on the CPU through the same sequence of calls: results,
degraded counters, scraped samples (as sets of (kind, name, labels,
value), the per-instance ``index`` label left out) and knob values.

1. the IVF exact-tail upload retries under ``ivf.tail_upload``; past its
   budget the serve answers resident-only, flagged ``tail_skipped``, and
   the next serve recovers;
2. IVF maintenance has the ``ivf.absorb`` / ``ivf.retrain`` fault sites,
   the ``pathway_ivf_*`` provider, ``hbm_bytes`` and the absorb / retrain
   histograms;
3. ``ForwardIndex`` reads the ``forward.tokens`` / ``forward.quant``
   knobs, has the ``forward.absorb`` / ``forward.upload`` fault sites
   (a failed pass degrades, never raises), the ``pathway_forward_*``
   provider and the int8 audit gauge;
4. every encoder forward dispatches under ``encoder.dispatch`` (plain,
   packed and token-state encodes);
5. ``default_specs`` carries the observe-only ``decode_ttlt`` objective.
"""

import numpy as np
import pytest
import torch

from pathway_tpu import config as ref_config
from pathway_tpu import observe as ref_observe
from pathway_tpu.index import ForwardIndex as RefForward
from pathway_tpu.observe import slo as ref_slo
from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.robust import inject as ref_inject
from pathway_tpu_torch import config, observe
from pathway_tpu_torch.index import ForwardIndex
from pathway_tpu_torch.observe import slo
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.robust import inject

from .test_torch_forward import T_DOC, _assert_same_forward, corpus, encoders
from .test_torch_ivf import _absorb_pair, _assert_same_layout, _wait_maintenance
from .test_torch_rerank import DOCS, QUERIES, assert_same_serve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    inject.disarm()
    ref_inject.disarm()


@pytest.fixture(scope="module")
def pair():
    return encoders()


def _samples(ix):
    """Provider samples without the per-instance ``index`` label."""
    return {
        (kind, name, tuple(sorted((k, str(v)) for k, v in labels.items() if k != "index")), float(value))
        for kind, name, labels, value in ix.observe_metrics()
    }


def _counts(*series):
    """Values of ``(name, labels)`` counters in both registries."""
    return [
        (ref_observe.counter(name, **labels).value, observe.counter(name, **labels).value)
        for name, labels in series
    ]


def _deltas(after, before):
    return [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)]


# -- fault 1: the exact-tail upload rung ---------------------------------------------


_TAIL_SERIES = (
    ("pathway_serve_degraded_total", {"reason": "tail_skipped"}),
    ("pathway_robust_retries_total", {"site": "ivf.tail_upload"}),
    ("pathway_robust_retry_exhausted_total", {"site": "ivf.tail_upload"}),
)


def test_fault1_tail_upload_failure_serves_resident_only_then_recovers(pair):
    ref_enc, enc = pair
    keys = sorted(DOCS)
    vecs = ref_enc.encode([DOCS[k] for k in keys])
    indexes = []
    for cls, kw in ((RefIvf, {}), (IvfKnnIndex, {"device": "cpu"})):
        ix = cls(32, n_clusters=4, n_probe=4, seed=3, absorb_threshold=4096, **kw)
        ix.add(keys[:32], vecs[:32])
        ix.build()
        ix.add(keys[32:], vecs[32:])  # rides the exact tail
        indexes.append(ix)
    ref_ivf, ivf = indexes
    ref, port = RefServe(ref_enc, ref_ivf, k=8, embed_cache=None), FusedEncodeSearch(enc, ivf, k=8)
    queries = QUERIES + [" ".join(DOCS[k].split()[::2]) for k in (36, 44)]
    tail_keys = set(keys[32:])
    clean_ref, clean = ref(queries), port(queries)
    assert_same_serve(clean_ref, clean)
    assert clean.ok and any(key in tail_keys for row in clean for key, _ in row)

    before = _counts(*_TAIL_SERIES)
    for ix in indexes:
        with ix._lock:
            ix._tail_cache = None  # the next serve uploads again
    # four failures: the three attempts of one serve, then the first of the next
    ref_inject.arm("ivf.tail_upload", "raise", times=4)
    inject.arm("ivf.tail_upload", "raise", times=4)
    want, got = ref(queries), port(queries)
    assert_same_serve(want, got)
    assert got.degraded == ("tail_skipped",) and got.meta["degraded_reasons"] == ["tail_skipped"]
    assert all(key not in tail_keys for row in got for key, _ in row)
    assert all(len(row) > 0 for row in got), "resident rows still served"
    assert ivf.tail_degraded and ref_ivf.tail_degraded
    assert _deltas(_counts(*_TAIL_SERIES), before) == [(1, 1), (2, 2), (1, 1)]

    # nothing was cached: the next serve uploads (one more failure, then success)
    want2, got2 = ref(queries), port(queries)
    assert_same_serve(want2, got2)
    assert got2.ok and list(got2) == list(clean)
    assert not ivf.tail_degraded and not ref_ivf.tail_degraded
    assert _deltas(_counts(*_TAIL_SERIES), before) == [(1, 1), (3, 3), (1, 1)]
    assert inject.fired_count("ivf.tail_upload") == ref_inject.fired_count("ivf.tail_upload") == 4
    assert ivf.stats["tail_cache_misses"] == ref_ivf.stats["tail_cache_misses"] == 3
    assert _samples(ivf) == _samples(ref_ivf)


# -- fault 2: IVF maintenance fault sites and metrics ---------------------------------


def _hist_counts(name):
    return ref_observe.histogram(name).count, observe.histogram(name).count


def test_fault2_absorb_fault_site_and_metrics_as_reference():
    ref, port, keys, data, rng = _absorb_pair(seed=8)
    absorbs0 = _hist_counts("pathway_ivf_absorb_seconds")
    ref_inject.arm("ivf.absorb", "raise", times=1)  # the first plan fails, the retry lands
    inject.arm("ivf.absorb", "raise", times=1)
    near = data[::29][:70] + 0.02 * rng.normal(size=(70, 32)).astype(np.float32)
    new_keys = [9 * 10**9 + i for i in range(len(near))]
    for ix in (ref, port):
        ix.add(new_keys, near)
    _wait_maintenance(ref, port)
    for key in ("absorbs", "absorb_failures", "retrains", "retrain_failures", "sync_builds"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["absorbs"] == port.stats["absorb_failures"] == 1
    _assert_same_layout(port, ref)
    assert _samples(port) == _samples(ref)
    assert ("counter", "pathway_ivf_maintenance_total", (("kind", "absorb_errors"),), 1.0) in _samples(port)
    assert port.hbm_bytes() == ref.hbm_bytes() and port.hbm_bytes()["resident"] > 0
    after = _hist_counts("pathway_ivf_absorb_seconds")
    assert after[0] - absorbs0[0] == after[1] - absorbs0[1] == 1
    lines = observe.render_prometheus()
    assert f'pathway_ivf_maintenance_failures_total{{index="{port._observe_id}",kind="absorb"}} 1' in lines


def test_fault2_retrain_fault_site_and_metrics_as_reference():
    ref, port, keys, data, rng = _absorb_pair(seed=14, threshold=10**6)
    retrains0 = _hist_counts("pathway_ivf_retrain_seconds")
    ref_inject.arm("ivf.retrain", "raise", times=1)
    inject.arm("ivf.retrain", "raise", times=1)
    fresh = data[::3] + 0.02 * rng.normal(size=(683, 32)).astype(np.float32)
    new_keys = [8 * 10**9 + i for i in range(len(fresh))]
    for ix in (ref, port):
        ix.add(new_keys, fresh)
    _wait_maintenance(ref, port)
    assert port.stats["retrains"] == ref.stats["retrains"] == 1
    assert port.stats["retrain_failures"] == ref.stats["retrain_failures"] == 1
    _assert_same_layout(port, ref)
    assert _samples(port) == _samples(ref)
    assert port.hbm_bytes() == ref.hbm_bytes()
    after = _hist_counts("pathway_ivf_retrain_seconds")
    assert after[0] - retrains0[0] == after[1] - retrains0[1] == 1
    # a serve uploads the tail: the tail component counts it (the port
    # uploads the rows alone, the reference a padded matrix and a mask)
    port.add([7], data[:1])
    port.search(data[:2], k=3)
    assert port.hbm_bytes()["tail"] == 32 * 4


# -- fault 3: ForwardIndex knobs, fault sites, metrics --------------------------------


@pytest.mark.parametrize("env", [{}, {"PATHWAY_FORWARD_TOKENS": "4", "PATHWAY_FORWARD_QUANT": "none"},
                                 {"PATHWAY_FORWARD_TOKENS": "many", "PATHWAY_FORWARD_QUANT": "fp4"}])
def test_fault3_forward_knobs_as_reference(pair, env, monkeypatch):
    for name in ("PATHWAY_FORWARD_TOKENS", "PATHWAY_FORWARD_QUANT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ref_enc, enc = pair
    for key in ("forward.tokens", "forward.quant"):
        assert config.get(key) == ref_config.get(key)
    for tokens in (None, 8):
        for quant in (None, "int8", "none", "bogus"):
            ref = RefForward(ref_enc, tokens_per_doc=tokens, quant=quant, initial_capacity=64)
            port = ForwardIndex(enc, tokens_per_doc=tokens, quant=quant, initial_capacity=64)
            assert (port.tokens_per_doc, port.quant) == (ref.tokens_per_doc, ref.quant), (tokens, quant)


def test_fault3_forward_fault_sites_and_metrics_as_reference(pair):
    ref_enc, enc = pair
    ref = RefForward(ref_enc, tokens_per_doc=T_DOC, initial_capacity=64)
    port = ForwardIndex(enc, tokens_per_doc=T_DOC, initial_capacity=64)
    absorb0 = _hist_counts("pathway_forward_absorb_seconds")
    docs = corpus(40, seed=9)
    for ix, inj in ((ref, ref_inject), (port, inject)):
        with inj.armed("forward.absorb", "raise", times=1):
            assert ix.add(range(10), docs[:10]) == 0
        with inj.armed("forward.upload", "raise", times=1):
            assert ix.add(range(10), docs[:10]) == 0
        assert len(ix) == 0 and not ix._free
        assert ix.add(range(40), docs) == 40
        ix.remove([3])
    _assert_same_forward(port, ref)
    for key in ("absorbs", "docs_absorbed", "absorb_failures", "upload_failures"):
        assert port.stats[key] == ref.stats[key], key
    assert (port.stats["absorb_failures"], port.stats["upload_failures"]) == (2, 1)
    # one gather: 4 candidates, 2 of them not resident
    qtok, _, _ = ref_enc.encode_token_states(docs[:1])
    ids, qmask = ref_enc.tokenizer.encode_batch(docs[:1])
    qtok = np.asarray(qtok)[:1, : ids.shape[1]]
    ref.gather_submit(qtok, qmask, [[0, 3, 5, 1000]], 2)[0]()
    port.gather_submit(torch.from_numpy(qtok), qmask, [[0, 3, 5, 1000]], 2)[0]()
    got, want = _samples(port), _samples(ref)
    audit = [s for s in got if s[1] == "pathway_forward_quant_abs_err"]
    ref_audit = [s for s in want if s[1] == "pathway_forward_quant_abs_err"]
    assert len(audit) == len(ref_audit) == 1 and abs(audit[0][3] - ref_audit[0][3]) < 1e-5
    ratio = [s for s in got if s[1] == "pathway_forward_compression_ratio"]
    ref_ratio = [s for s in want if s[1] == "pathway_forward_compression_ratio"]
    assert abs(ratio[0][3] - ref_ratio[0][3]) < 1e-9
    approx = ("pathway_forward_quant_abs_err", "pathway_forward_compression_ratio")
    assert {s for s in got if s[1] not in approx} == {s for s in want if s[1] not in approx}
    assert ("counter", "pathway_forward_gather_rows_total", (("kind", "missing"),), 2.0) in got
    after = _hist_counts("pathway_forward_absorb_seconds")
    assert after[0] - absorb0[0] == after[1] - absorb0[1] == 1


# -- fault 4: encoder dispatch retries -------------------------------------------------


_ENC_SERIES = (
    ("pathway_robust_retries_total", {"site": "encoder.dispatch"}),
    ("pathway_robust_retry_exhausted_total", {"site": "encoder.dispatch"}),
)


@pytest.mark.parametrize("entry", ["encode_to_device", "encode_packed_to_device", "encode_token_states"])
def test_fault4_encoder_dispatch_retries_as_reference(pair, entry):
    ref_enc, enc = pair
    texts = corpus(6, seed=12, lo=1, hi=12)

    def run(e):
        out = getattr(e, entry)(texts)
        return np.asarray(out[0] if isinstance(out, tuple) else out)

    clean, ref_clean = run(enc), run(ref_enc)
    np.testing.assert_allclose(clean, ref_clean, atol=1e-5)
    before = _counts(*_ENC_SERIES)
    ref_inject.arm("encoder.dispatch", "raise", times=2)
    inject.arm("encoder.dispatch", "raise", times=2)
    got, want = run(enc), run(ref_enc)
    np.testing.assert_array_equal(got, clean)
    np.testing.assert_array_equal(want, ref_clean)
    assert inject.fired_count("encoder.dispatch") == ref_inject.fired_count("encoder.dispatch") == 2
    assert _deltas(_counts(*_ENC_SERIES), before) == [(2, 2), (0, 0)]
    # a persistent fault exhausts the budget in both
    ref_inject.arm("encoder.dispatch", "raise")
    inject.arm("encoder.dispatch", "raise")
    with pytest.raises(ref_inject.FaultInjected):
        run(ref_enc)
    with pytest.raises(inject.FaultInjected):
        run(enc)
    assert _deltas(_counts(*_ENC_SERIES), before) == [(4, 4), (1, 1)]


# -- fault 5: the decode TTLT objective -------------------------------------------------


@pytest.mark.parametrize("ttlt_ms", [None, "150", "-3", "slow"])
def test_fault5_decode_ttlt_objective_as_reference(ttlt_ms, monkeypatch):
    monkeypatch.setenv("PATHWAY_SLO_TICK_S", "0")
    if ttlt_ms is None:
        monkeypatch.delenv("PATHWAY_SLO_TTLT_MS", raising=False)
    else:
        monkeypatch.setenv("PATHWAY_SLO_TTLT_MS", ttlt_ms)
    assert config.get("observe.slo_ttlt_ms") == ref_config.get("observe.slo_ttlt_ms")
    rows = []
    for obs, slo_mod in ((ref_observe, ref_slo), (observe, slo)):
        obs.reset()
        specs = {s.name: s for s in slo_mod.default_specs()}
        spec = specs["decode_ttlt"]
        assert (spec.kind, spec.hist, spec.objective, spec.shed) == (
            "latency", "pathway_generator_ttlt_seconds", 0.99, False)
        h = obs.histogram("pathway_generator_ttlt_seconds")
        engine = slo_mod.SloEngine([specs["decode_ttlt"]])
        first = engine.evaluate(max_age_s=0)["slos"]["decode_ttlt"]
        for ms in (40, 90, 140, 600, 2500, 9000):
            h.observe_ns(int(ms * 1e6))
        second = engine.evaluate(max_age_s=0)
        rows.append((first, second["slos"]["decode_ttlt"], second["should_shed"], spec.threshold_s))
    assert rows[0] == rows[1]
    assert rows[1][1]["total"] == 6 and rows[1][2] is False
