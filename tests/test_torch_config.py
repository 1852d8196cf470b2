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
