"""The port's online tuner (``pathway_tpu_torch/serve/tuner.py``) and the
knob write path it stands on (``pathway_tpu_torch/config.py``), against
the reference (``pathway_tpu/serve/tuner.py``, ``pathway_tpu/config.py``).

- the cases of ``tests/test_tuner.py``, run against the port;
- both packages' ``Tuner`` fed one scripted signal sequence (queue-wait
  observations, generator pack rows, cache-tier stats, an SLO burn,
  profiler samples) journal the same (knob, value, direction) triples
  and hold the same ``overrides()`` after every tick;
- every knob the port declares carries the reference's mutability and
  bounds, and ``set`` clamps and vetoes alike;
- the override layer wins over the parse cache, also when the
  environment string changes after a ``set``; ``auto_pytest`` bools are
  read per call.
"""

from __future__ import annotations

import os

import pytest

from pathway_tpu import config as ref_config
from pathway_tpu import observe as ref_observe
from pathway_tpu.cache import store as ref_store
from pathway_tpu.observe import profile as ref_profile
from pathway_tpu.robust import inject as ref_inject
from pathway_tpu.serve.tuner import Tuner as RefTuner
from pathway_tpu_torch import config, observe
from pathway_tpu_torch.cache import store
from pathway_tpu_torch.cache.store import CacheTier
from pathway_tpu_torch.observe import profile
from pathway_tpu_torch.robust import inject
from pathway_tpu_torch.serve.tuner import Tuner, tuner_from_env

PORT_KNOBS = sorted(config.registry())


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in list(os.environ):
        if name.startswith("PATHWAY_"):
            monkeypatch.delenv(name)
    strides = (profile.sample_stride(), ref_profile.sample_stride())
    for cfg in (config, ref_config):
        cfg.clear_overrides()
    for obs in (observe, ref_observe):
        obs.reset()
    inject.disarm()
    ref_inject.disarm()
    yield
    for cfg in (config, ref_config):
        cfg.clear_overrides()
    for obs in (observe, ref_observe):
        obs.reset()
    inject.disarm()
    ref_inject.disarm()
    profile.set_sample(1.0 / strides[0] if strides[0] else 0.0)
    ref_profile.set_sample(1.0 / strides[1] if strides[1] else 0.0)


def _counter_value(name, **labels):
    return observe.counter(name, **labels).value


# -- the cases of tests/test_tuner.py, against the port ---------------------

def test_propose_clamps_to_registry_bounds():
    t = Tuner(interval_s=0.01)
    assert t.propose("serve.coalesce_us", 10**12, "up")
    assert config.get("serve.coalesce_us") == 100000.0
    assert t.propose("decode.step_bucket", -5, "down")
    assert config.get("decode.step_bucket") == 1
    assert t.propose("decode.step_bucket", 10**6, "up")
    assert config.get("decode.step_bucket") == 128


def test_static_knob_vetoed_and_counted():
    t = Tuner(interval_s=0.01)
    before = _counter_value("pathway_tuner_vetoed_total", knob="decode.kv_quant")
    assert not t.propose("decode.kv_quant", "int8", "up")
    assert t.stats["vetoes"] == 1
    assert _counter_value("pathway_tuner_vetoed_total", knob="decode.kv_quant") == before + 1
    assert config.overrides() == {}


def test_adjustments_counted_by_knob_and_direction():
    t = Tuner(interval_s=0.01)
    assert t.propose("serve.coalesce_us", 3000, "up")
    assert t.propose("serve.coalesce_us", 1500, "down")
    assert _counter_value("pathway_tuner_adjustments_total", knob="serve.coalesce_us", direction="up") == 1
    assert _counter_value("pathway_tuner_adjustments_total", knob="serve.coalesce_us", direction="down") == 1
    assert observe.gauge("pathway_tuner_value", knob="serve.coalesce_us").value == 1500.0


def test_revert_restores_env_and_default_layer(monkeypatch):
    monkeypatch.setenv("PATHWAY_SERVE_COALESCE_US", "4000")
    t = Tuner(interval_s=0.01)
    assert t.propose("serve.coalesce_us", 9000, "up")
    assert t.propose("decode.step_bucket", 16, "up")
    assert config.get("serve.coalesce_us") == 9000.0
    t.revert()
    assert config.overrides() == {}
    assert config.get("serve.coalesce_us") == 4000.0
    assert config.get("decode.step_bucket") == 8


def test_revert_restores_live_tier_budgets():
    tier = CacheTier("result", max_bytes=1 << 20)
    tier.stats["hits"] = 50
    tier.stats["evictions"] = 10
    t = Tuner(interval_s=0.01)
    assert t.tick() >= 1
    assert tier.max_bytes == config.get("cache.result_bytes") > 1 << 20
    t.revert()
    assert tier.max_bytes == 1 << 20
    assert config.overrides() == {}


def test_cache_budget_grows_on_evictions_with_hits():
    tier = CacheTier("result", max_bytes=1 << 20)
    t = Tuner(interval_s=0.01)
    t.tick()
    t.revert()
    tier.stats["hits"] += 100
    tier.stats["evictions"] += 20
    base = config.get("cache.result_bytes")
    assert t.tick() >= 1
    assert config.get("cache.result_bytes") > base
    assert tier.max_bytes == config.get("cache.result_bytes")


def test_cache_budget_shrinks_when_idle():
    tier = CacheTier("generator_kv", max_bytes=256 << 20)
    t = Tuner(interval_s=0.01)
    t.tick()
    t.revert()
    base = config.get("cache.kv_bytes")
    assert t.tick() >= 1
    assert config.get("cache.kv_bytes") < base
    assert tier.max_bytes == config.get("cache.kv_bytes")


def test_step_bucket_shrinks_on_low_occupancy():
    t = Tuner(interval_s=0.01)
    t.tick()
    observe.record_occupancy("generator", real=2, padded=8)
    assert config.get("decode.step_bucket") == 8
    t.tick()
    assert config.get("decode.step_bucket") == 4


def test_step_bucket_grows_on_saturation():
    t = Tuner(interval_s=0.01)
    t.tick()
    observe.record_occupancy("generator", real=8, padded=8)
    t.tick()
    assert config.get("decode.step_bucket") == 16


def test_coalesce_shrinks_under_slo_burn(monkeypatch):
    t = Tuner(interval_s=0.01)
    monkeypatch.setattr(Tuner, "_slo_fast_burn", lambda self: 2.0)
    t.tick()
    assert config.get("serve.coalesce_us") < 2000.0


def test_coalesce_grows_when_window_binds(monkeypatch):
    t = Tuner(interval_s=0.01)
    t.tick()
    h = observe.histogram("pathway_serve_queue_wait_seconds")
    for _ in range(10):
        h.observe_s(0.0019)
    monkeypatch.setattr(Tuner, "_slo_fast_burn", lambda self: 0.0)
    t.tick()
    assert config.get("serve.coalesce_us") > 2000.0


def test_profile_sample_backs_off_under_overhead(monkeypatch):
    t = Tuner(interval_s=0.01)
    t.tick()
    monkeypatch.setattr(
        t, "_delta", lambda key, cur, _orig=t._delta: (1e6 if key == "profile_samples" else _orig(key, cur))
    )
    base = config.get("observe.profile_sample")
    t.tick()
    assert config.get("observe.profile_sample") < base
    assert profile.sample_stride() >= int(round(1.0 / base))
    t.revert()  # the live stride follows the knob back
    assert profile.sample_stride() == int(round(1.0 / base))


def test_injected_fault_freezes_and_reverts():
    tier = CacheTier("result", max_bytes=1 << 20)
    t = Tuner(interval_s=0.01)
    t.tick()
    t.revert()
    tier.stats["hits"] += 100
    tier.stats["evictions"] += 20
    assert t.tick() >= 1
    assert config.overrides() != {}
    before = _counter_value("pathway_tuner_faults_total")
    inject.load_env("tuner.adjust=raise")
    assert t.tick() == 0
    assert t.frozen
    assert config.overrides() == {}
    assert tier.max_bytes == 1 << 20
    assert _counter_value("pathway_tuner_faults_total") == before + 1
    inject.disarm()
    assert t.tick() == 0


def test_tuner_from_env_default_off():
    assert tuner_from_env() is None


def test_tuner_from_env_starts_and_stops(monkeypatch):
    monkeypatch.setenv("PATHWAY_TUNER", "1")
    monkeypatch.setenv("PATHWAY_TUNER_INTERVAL_S", "0.05")
    t = tuner_from_env()
    try:
        assert t is not None and t._thread.is_alive()
        assert t.interval_s == 0.05
    finally:
        t.stop()
    assert t._thread is None


def test_tuner_families_render():
    t = Tuner(interval_s=0.01)
    t.propose("serve.coalesce_us", 3000, "up")
    t.propose("decode.kv_quant", "int8", "up")
    body = "\n".join(observe.render_prometheus())
    assert 'pathway_tuner_adjustments_total{direction="up",knob="serve.coalesce_us"} 1' in body
    assert 'pathway_tuner_vetoed_total{knob="decode.kv_quant"} 1' in body
    assert 'pathway_tuner_value{knob="serve.coalesce_us"} 3000' in body


# -- both tuners on one scripted signal sequence ----------------------------

# per tick: (queue waits in s, generator (real, padded) or None,
# result-tier (hits, evictions, misses) increments, kv-tier increments,
# fast burn, profiler samples so far)
_SCRIPT = [
    ([], None, (0, 0, 0), (0, 0, 0), 0.0, 0),
    ([0.0019] * 10, (8, 8), (100, 20, 5), (0, 0, 0), 0.0, 10),
    ([0.0025] * 6, (2, 8), (0, 0, 0), (0, 0, 0), 0.2, 10),
    ([0.0001] * 4, (16, 16), (40, 0, 40), (3, 0, 1), 2.0, 5000),
    ([0.004] * 8, None, (10, 10, 0), (0, 0, 0), 1.5, 5000),
    ([0.001] * 3, (1, 16), (0, 0, 0), (0, 0, 0), 0.0, 5002),
    ([0.0035] * 5, (4, 4), (5, 7, 1), (0, 0, 0), 0.0, 5010),
]


def _drive(tuner_cls, cfg, obs, store_mod, profile_mod, monkeypatch):
    result = store_mod.CacheTier("result", max_bytes=1 << 20)
    kv = store_mod.CacheTier("generator_kv", max_bytes=256 << 20)
    monkeypatch.setattr(store_mod, "live_tiers", lambda: [result, kv])
    burns = iter(row[4] for row in _SCRIPT)
    samples = iter(row[5] for row in _SCRIPT)
    monkeypatch.setattr(tuner_cls, "_slo_fast_burn", lambda self: next(burns))
    monkeypatch.setattr(profile_mod, "profile_stats", lambda: {"scripted": {"samples": next(samples)}})
    tuner = tuner_cls(interval_s=1.0)
    journal = []
    propose = tuner.propose

    def recording(knob, value, direction):
        ok = propose(knob, value, direction)
        journal.append((knob, cfg.overrides().get(knob) if ok else value, direction, ok))
        return ok

    tuner.propose = recording
    per_tick = []
    h = obs.histogram("pathway_serve_queue_wait_seconds")
    for waits, occ, d_result, d_kv, _burn, _samples in _SCRIPT:
        for w in waits:
            h.observe_s(w)
        if occ is not None:
            obs.record_occupancy("generator", real=occ[0], padded=occ[1])
        for tier, deltas in ((result, d_result), (kv, d_kv)):
            for stat, d in zip(("hits", "evictions", "misses"), deltas):
                tier.stats[stat] += d
        n = tuner.tick()
        per_tick.append((n, dict(cfg.overrides()), result.max_bytes, kv.max_bytes))
    tuner.revert()
    return journal, per_tick, (dict(cfg.overrides()), result.max_bytes, kv.max_bytes)


def test_both_tuners_journal_alike_on_scripted_signals(monkeypatch):
    port = _drive(Tuner, config, observe, store, profile, monkeypatch)
    ref = _drive(RefTuner, ref_config, ref_observe, ref_store, ref_profile, monkeypatch)
    journal, per_tick, after = port
    assert journal == ref[0]
    for tick, (mine, theirs) in enumerate(zip(per_tick, ref[1])):
        assert mine == theirs, tick
    assert after == ref[2] == ({}, 1 << 20, 256 << 20)
    # the script moves every controller
    assert {k for k, *_ in journal} == {
        "serve.coalesce_us", "decode.step_bucket", "cache.result_bytes", "cache.kv_bytes", "observe.profile_sample",
    }
    assert {d for *_, d, _ok in journal} == {"up", "down"}


# -- the knob write path ------------------------------------------------------

def test_every_port_knob_has_the_reference_mutability_and_bounds():
    ref = ref_config.registry()
    for key in PORT_KNOBS:
        mine, theirs = config.registry()[key], ref[key]
        for field in ("mutability", "auto_pytest", "lo", "hi", "choices", "default", "kind", "env"):
            assert getattr(mine, field) == getattr(theirs, field), (key, field)
    dynamic = {k for k in PORT_KNOBS if config.registry()[k].mutability == config.DYNAMIC}
    assert dynamic == {
        "serve.coalesce_us", "cache.result_bytes", "cache.embed_bytes", "cache.kv_bytes", "decode.step_bucket",
        "ingest.batch_docs", "ingest.poll_ms", "ingest.backpressure_ms", "warmstate.interval_s",
        "observe.profile_sample", "fabric.hedge_ms", "partition.gather_timeout_s",
    }
    for key in ("tuner.enabled", "tuner.interval_s", "observe.profile_sample", "ops.recompile_limit",
                "ops.recompile_strict", "ops.donation_guard", "ops.donation_guard_strict"):
        assert key in PORT_KNOBS


@pytest.mark.parametrize("key", PORT_KNOBS)
def test_set_clamps_and_vetoes_as_reference(key):
    knob = config.registry()[key]
    if knob.mutability != config.DYNAMIC:
        with pytest.raises(config.StaticKnobError):
            config.set(key, knob.default)
        with pytest.raises(ref_config.StaticKnobError):
            ref_config.set(key, knob.default)
        assert config.overrides() == ref_config.overrides() == {}
        return
    for value in (-10**9, 0, 3, 0.5, knob.default, 10**13):
        got, want = config.set(key, value), ref_config.set(key, value)
        assert got == want and type(got) is type(want), (value, got, want)
        assert config.get(key) == ref_config.get(key) == got
    assert config.snapshot()[key] == got
    config.clear_override(key)
    ref_config.clear_override(key)
    assert config.get(key) == ref_config.get(key) == knob.default


def test_override_wins_over_the_parse_cache(monkeypatch):
    monkeypatch.setenv("PATHWAY_SERVE_COALESCE_US", "4000")
    assert config.get("serve.coalesce_us") == 4000.0  # parsed and cached
    config.set("serve.coalesce_us", 7000)
    assert config.get("serve.coalesce_us") == 7000.0
    monkeypatch.setenv("PATHWAY_SERVE_COALESCE_US", "5000")  # env moves after the set
    assert config.get("serve.coalesce_us") == 7000.0
    assert config.overrides() == {"serve.coalesce_us": 7000.0}
    config.clear_overrides()
    assert config.get("serve.coalesce_us") == 5000.0
    snap = config.snapshot()
    assert snap == {k: config.get(k) for k in PORT_KNOBS}


def test_auto_pytest_bools_are_read_per_call(monkeypatch):
    for key in ("ops.recompile_strict", "ops.donation_guard_strict"):
        assert config.get(key) is True  # under pytest
        monkeypatch.delenv("PYTEST_CURRENT_TEST")
        assert config.get(key) is False and ref_config.get(key) is False
        monkeypatch.setenv("PYTEST_CURRENT_TEST", "x")
        assert config.get(key) is True
        monkeypatch.setenv(config.registry()[key].env, "0")
        assert config.get(key) is False
        monkeypatch.delenv(config.registry()[key].env)
