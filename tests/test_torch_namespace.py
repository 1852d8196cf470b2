"""The port's ``pw`` namespace against the reference's public names.

The port's counterpart of ``tests/test_api_parity.py::
test_namespace_covers_reference_all`` (which reads an upstream checkout
that is not here), checked against ``dir(pathway_tpu)``: every public name
is present in the port, ported, or in ``pw.io`` a stub that raises
``NotImplementedError`` naming its slice in ``ROADMAP.md``.  The same
holds for ``pw.io``, ``pw.stdlib`` and the stdlib modules, ``pw.utils``
and ``pw.viz`` included.
The reference's names are read in a fresh interpreter: a worker that ran
other tests holds submodules they imported.
"""

import functools
import json
import os
import subprocess
import sys
import types

import pytest

import pathway_tpu
import pathway_tpu_torch

PACKAGES = (pathway_tpu, pathway_tpu_torch)

# names of the reference that the port does not carry, and why
_EXCEPTIONS = {
    # the reference's native host runtime (ctypes over native/src); the
    # port's host code is csrc/host, built by kernels/build.py
    "native",
    # the feature object ``from __future__ import annotations`` leaves in a
    # module's namespace, not an API
    "annotations",
}


_MODULES = {
    "pw": "", "io": ".io", "stdlib": ".stdlib", "temporal": ".stdlib.temporal", "graphs": ".stdlib.graphs",
    "ordered": ".stdlib.ordered", "statistical": ".stdlib.statistical", "indexing": ".stdlib.indexing",
    "ml": ".stdlib.ml", "utils": ".stdlib.utils", "viz": ".stdlib.viz",
}


@functools.lru_cache(maxsize=None)
def _reference_public():
    code = (
        "import importlib, json\n"
        f"mods = {_MODULES!r}\n"
        "print(json.dumps({k: [n for n in dir(importlib.import_module('pathway_tpu' + m)) if not n.startswith('_')]"
        " for k, m in mods.items()}))"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": root}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _public(where):
    return sorted(n for n in _reference_public()[where] if n not in _EXCEPTIONS)


def _port_module(where):
    module = pathway_tpu_torch
    for part in _MODULES[where].split(".")[1:]:
        module = getattr(module, part)
    return module


def _is_stub(obj) -> bool:
    try:
        return isinstance(vars(obj).get("later_slice"), str)
    except TypeError:
        return False


def _assert_stub_raises(obj):
    """A stub names its slice when it is used (a module in any function
    it is asked for)."""
    if isinstance(obj, types.ModuleType):
        obj = obj.read
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md, framework slice {obj.later_slice}"):
        obj()


@pytest.mark.parametrize("where", list(_MODULES))
def test_namespace_covers_reference_public_names(where):
    port = _port_module(where)
    missing = [n for n in _public(where) if not hasattr(port, n)]
    assert missing == []
    stubs = [n for n in _public(where) if _is_stub(getattr(port, n))]
    for name in stubs:
        _assert_stub_raises(getattr(port, name))
    # the multi-process engine (framework slice 4) is ported: no stub names it
    assert [n for n in stubs if getattr(port, n).later_slice == "4"] == []
    if where != "io":
        # the rest of the host API is ported: outside pw.io no stub is left
        assert stubs == []
    if where == "pw":
        for name in ("sql", "export_table", "import_table", "ExportedTable", "enable_interactive_mode", "LiveTable",
                     "ClassArg", "attribute", "input_attribute", "input_method", "method", "output_attribute",
                     "transformer", "AsyncTransformer", "pandas_transformer", "utils", "viz"):
            assert name in _public(where) and hasattr(port, name), name
        # lazy in both packages (its import warns): absent from dir() until used
        assert "asynchronous" not in _public(where) and not _is_stub(port.asynchronous)
        for name in ("temporal", "graphs", "ordered", "statistical", "windowby", "asof_join", "interval_join",
                     "window_join", "iterate", "iterate_universe", "AsofJoinResult", "IntervalJoinResult",
                     "WindowJoinResult", "PathwayConfig", "get_config", "config", "Pointer_",
                     "set_license_key", "set_monitoring_config"):
            assert name in _public(where) and not _is_stub(getattr(port, name)), name


def test_connectors_of_a_later_slice_are_stub_modules():
    """``pw.io.kafka`` and the 18 other transport-gated connectors: any
    function raises naming slice 3c; private names stay AttributeError."""
    gated = [n for n in _public("io") if _is_stub(getattr(pathway_tpu_torch.io, n))]
    assert len(gated) == 19 and "kafka" in gated
    for name in gated:
        mod = getattr(pathway_tpu_torch.io, name)
        for fn in ("read", "write"):
            with pytest.raises(NotImplementedError, match=rf"pw\.io\.{name}\.{fn} .*framework slice 3c"):
                getattr(mod, fn)()
        assert not hasattr(mod, "__path__")
    from pathway_tpu_torch.io import kafka

    assert kafka is pathway_tpu_torch.io.kafka


def test_license_and_monitoring_setters_are_the_reference_ones(monkeypatch):
    """``pw.set_license_key(None)`` is a no-op apart from the field it
    writes; ``pw.set_monitoring_config`` writes the endpoint; the process
    config has the reference's value in every field it carries."""
    port, ref = pathway_tpu_torch.get_config(), pathway_tpu.internals.config.get_config()
    assert vars(port) == {name: getattr(ref, name) for name in vars(port)}
    assert {"license_key", "monitoring_server"} <= set(vars(port))
    before = dict(vars(port))
    try:
        assert pathway_tpu_torch.set_license_key(None) is None
        assert vars(port) == {**before, "license_key": None}
        for pw in PACKAGES:
            pw.set_license_key("LICENSE-KEY")
            pw.set_monitoring_config(server_endpoint="http://127.0.0.1:4317")
        assert vars(port) == {name: getattr(ref, name) for name in vars(port)}
        assert (port.license_key, port.monitoring_server) == ("LICENSE-KEY", "http://127.0.0.1:4317")
    finally:
        for pw in PACKAGES:
            pw.set_license_key(before["license_key"])
            pw.set_monitoring_config(server_endpoint=before["monitoring_server"])
    monkeypatch.setenv("PATHWAY_LICENSE_KEY", "from-env")
    monkeypatch.setenv("PATHWAY_MONITORING_SERVER", "http://collector:4317")
    fresh, ref_fresh = pathway_tpu_torch.PathwayConfig(), pathway_tpu.PathwayConfig()
    assert (fresh.license_key, fresh.monitoring_server) == (ref_fresh.license_key, ref_fresh.monitoring_server)
    assert fresh.license_key == "from-env"


def test_ported_aliases_and_knob_table():
    pw = pathway_tpu_torch
    assert pw.Pointer_ is pw.Pointer
    assert pw.config.get("license.key") == pathway_tpu.config.get("license.key")
    assert pw.PathwayConfig is pw.internals.config.PathwayConfig
    assert pw.temporal is pw.stdlib.temporal and pw.graphs is pw.stdlib.graphs
    assert pw.windowby is pw.stdlib.temporal.windowby and pw.iterate is pw.internals.iterate.iterate
    assert pw.utils is pw.stdlib.utils and pw.viz is pw.stdlib.viz
