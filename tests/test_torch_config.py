"""The port's knob table (``pathway_tpu_torch/config.py``) against the
reference's registry (``pathway_tpu/config.py``): every port knob is
declared there with the same environment name, type, default, bounds
and choices; the same environment gives the same typed value, and the
same malformed or out-of-bounds value gives the same fallback."""

import pytest

from pathway_tpu import config as ref_config
from pathway_tpu_torch import config

PORT_KNOBS = sorted(config.registry())

# (raw environment values) per kind: valid, edge, malformed
_RAW = {
    "bool": ["1", "off", " TRUE ", "", "maybe"],
    "int": ["7", "0", "-5", "99999999999999", "12abc", "3.5"],
    "float": ["2.5", "0", "-1", "1e12", "x", "nan-ish"],
    "enum": ["LOW", "high", "bogus"],
    "str": ["a,b", "", "cache.get=raise:p=0.5"],
}


def test_port_table_is_a_subset_of_the_reference_registry():
    ref = ref_config.registry()
    assert PORT_KNOBS and set(PORT_KNOBS) <= set(ref)
    for key in PORT_KNOBS:
        mine, theirs = config.registry()[key], ref[key]
        for field in ("env", "kind", "default", "lo", "hi", "choices", "site_prefix"):
            assert getattr(mine, field) == getattr(theirs, field), (key, field)


@pytest.mark.parametrize("key", PORT_KNOBS)
def test_same_env_same_value(key, monkeypatch):
    knob = config.registry()[key]
    monkeypatch.delenv(knob.env, raising=False)
    assert config.get(key) == ref_config.get(key), "declared default"
    for raw in _RAW[knob.kind]:
        monkeypatch.setenv(knob.env, raw)
        got, want = config.get(key), ref_config.get(key)
        assert got == want and type(got) is type(want), (raw, got, want)


def test_per_site_retry_attempts(monkeypatch):
    monkeypatch.setenv("PATHWAY_RETRY_ATTEMPTS", "4")
    monkeypatch.setenv("PATHWAY_RETRY_ATTEMPTS_RERANK_DISPATCH", "9")
    monkeypatch.setenv("PATHWAY_RETRY_ATTEMPTS_CACHE_GET", "zero")
    for site in ("rerank.dispatch", "cache.get", "serve.dispatch"):
        assert config.get_site("robust.retry_attempts", site) == ref_config.get_site("robust.retry_attempts", site)
    assert config.get_site("robust.retry_attempts", "rerank.dispatch") == 9
    assert config.get_site("robust.retry_attempts", "cache.get") == 3  # malformed: the default


def test_unknown_key_raises():
    with pytest.raises(config.UnknownKnobError):
        config.get("serve.no_such_knob")


_QA_SLICE_KNOBS = [
    "chat.continuous", "qa.rerank_coalesce", "observe.metrics_port", "observe.metrics_host", "cli.spawn_args",
    "persistence.storage",
]


@pytest.mark.parametrize("key", _QA_SLICE_KNOBS)
def test_question_answering_slice_knobs_equal_the_reference_field_by_field(key):
    """The knobs the QA slice's modules read (llms, question_answering,
    internals/config, metrics, cli): every declared field, mutability and
    doc included, is the reference's."""
    mine, theirs = config.registry()[key], ref_config.registry()[key]
    for field in ("env", "kind", "default", "doc", "lo", "hi", "choices", "mutability", "site_prefix", "auto_pytest"):
        assert getattr(mine, field) == getattr(theirs, field), (key, field)


_PERSISTENCE_SLICE_KNOBS = [
    "persistence.mode", "persistence.replay_storage", "persistence.storage", "persistence.snapshot_interval_ms",
]


@pytest.mark.parametrize("key", _PERSISTENCE_SLICE_KNOBS)
def test_persistence_slice_knobs_equal_the_reference_field_by_field(key):
    """The knobs ``internals/config.py`` reads for ``pw.run``'s
    persistence config: every declared field is the reference's."""
    mine, theirs = config.registry()[key], ref_config.registry()[key]
    for field in ("env", "kind", "default", "doc", "lo", "hi", "choices", "mutability", "site_prefix", "auto_pytest"):
        assert getattr(mine, field) == getattr(theirs, field), (key, field)


def test_process_config_reads_the_port_table(monkeypatch):
    from pathway_tpu.internals.config import PathwayConfig as RefConfig
    from pathway_tpu_torch.internals.config import PathwayConfig, get_config, local_config

    monkeypatch.setenv("PATHWAY_METRICS_PORT", "23456")
    monkeypatch.setenv("PATHWAY_METRICS_HOST", "0.0.0.0")
    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", "/state")
    monkeypatch.setenv("PATHWAY_PERSISTENCE_MODE", "OPERATOR_PERSISTING")
    monkeypatch.setenv("PATHWAY_SNAPSHOT_INTERVAL_MS", "250")
    for env in ("PATHWAY_REPLAY_STORAGE", "PATHWAY_MONITORING_SERVER", "PATHWAY_LICENSE_KEY"):
        monkeypatch.delenv(env, raising=False)
    mine, theirs = PathwayConfig(), RefConfig()
    assert vars(mine) == {name: getattr(theirs, name) for name in vars(mine)}
    assert vars(mine) == {
        "persistence_mode": "OPERATOR_PERSISTING", "replay_storage": None, "persistent_storage": "/state",
        "snapshot_interval_ms": 250, "metrics_port": 23456, "metrics_host": "0.0.0.0",
        "monitoring_server": None, "license_key": None,
    }
    assert mine.process_id == theirs.process_id
    with local_config(metrics_port=1):
        assert get_config().metrics_port == 1
    assert get_config().metrics_port != 1


_EXCHANGE_KNOBS = ["parallel.exchange_host", "parallel.exchange_heartbeat_s", "parallel.exchange_heartbeat_timeout_s"]


@pytest.mark.parametrize("key", _EXCHANGE_KNOBS)
def test_exchange_plane_knobs_equal_the_reference_field_by_field(key):
    """The knobs the exchange plane reads (``parallel/exchange.py``): every
    declared field, mutability and doc included, is the reference's."""
    mine, theirs = config.registry()[key], ref_config.registry()[key]
    for field in ("env", "kind", "default", "doc", "lo", "hi", "choices", "mutability", "site_prefix", "auto_pytest"):
        assert getattr(mine, field) == getattr(theirs, field), (key, field)
