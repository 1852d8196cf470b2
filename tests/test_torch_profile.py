"""The port's per-callable device-time profiler
(``pathway_tpu_torch/observe/profile.py``) against the reference
(``pathway_tpu/observe/profile.py``): transparent wrapping, the same
deterministic 1-in-N stride for the same fractions, the disabled path,
a sample dropped on an injected fault, the 2 dispatches + 2 fetches
budget of a serve with every call sampled, the ``pathway_profile_*``
families and the ``profile`` column of ``observe.snapshot()``.  On the
CPU an output is ready at return, so samples are booked at once; the
CUDA-event path is held in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from pathway_tpu.observe import profile as ref_profile
from pathway_tpu_torch import observe
from pathway_tpu_torch.observe import profile
from pathway_tpu_torch.ops import dispatch_counter
from pathway_tpu_torch.robust import inject

_ROOT = Path(__file__).resolve().parents[1]

DOCS = {
    i: f"profile doc {i} about {topic} under load"
    for i, topic in enumerate(
        [
            "incremental dataflow", "vector indexes", "exactly once", "stream joins", "window aggregation",
            "schema registries", "kafka offsets", "snapshot replay", "rag retrieval", "sharded state",
            "commit ticks", "key ownership",
        ]
        * 2
    )
}
QUERIES = ["rag retrieval serving", "exactly once stream"]


@pytest.fixture(scope="module")
def serve_stack():
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    kw = dict(dimension=16, n_layers=1, n_heads=2, vocab_size=256, dtype=torch.float32, device="cpu")
    enc = SentenceEncoder(max_length=16, **kw)
    ce = CrossEncoderModel(max_length=32, **kw)
    ivf = IvfKnnIndex(dimension=16, metric="cos", n_clusters=4, n_probe=4, device="cpu")
    keys = sorted(DOCS)
    ivf.add(keys, enc.encode([DOCS[i] for i in keys]))
    ivf.build()
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(enc, ivf, k=8), ce, DOCS, k=3, candidates=8)
    pipe(QUERIES)
    return enc, ce, ivf, pipe


@pytest.fixture(autouse=True)
def _full_sampling():
    """Sample every call; restore the stride after."""
    stride0 = profile.sample_stride()
    profile.set_sample(1.0)
    yield
    profile.set_sample(1.0 / stride0 if stride0 else 0.0)
    inject.disarm()


def test_wrap_is_transparent_and_attributes_device_time():
    calls = []

    def kernel(x):
        calls.append(1)
        return torch.as_tensor(x) * 2

    fn = profile.wrap("test.transparent", kernel)
    out = fn(np.arange(8.0))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), np.arange(8.0) * 2)
    assert len(calls) == 1
    assert fn.__wrapped__ is kernel and fn.profile_site == "test.transparent"
    assert profile.drain()
    stats = profile.profile_stats()["test.transparent"]
    assert stats["samples"] >= 1
    assert stats["device_s"] > 0
    assert 0.0 <= stats["share_of_wall"] <= 1.0


@pytest.mark.parametrize("fraction", [-1.0, 0.0, 0.01, 0.1, 0.2, 0.25, 0.3, 1 / 3, 0.4, 0.5, 0.7, 0.99, 1.0, 2.0])
def test_stride_equals_the_reference(fraction):
    assert profile._stride_of(fraction) == ref_profile._stride_of(fraction)
    s_ref = ref_profile.sample_stride()
    try:
        profile.set_sample(fraction)
        ref_profile.set_sample(fraction)
        assert profile.sample_stride() == ref_profile.sample_stride()
    finally:
        ref_profile.set_sample(1.0 / s_ref if s_ref else 0.0)


def test_sampling_stride_is_deterministic():
    fn = profile.wrap("test.stride", lambda x: torch.as_tensor(x))
    profile.set_sample(0.25)
    assert profile.sample_stride() == 4
    s0 = observe.counter("pathway_profile_samples_total", callable="test.stride").value
    for _ in range(16):
        fn(np.ones(2))
    assert profile.drain()
    s1 = observe.counter("pathway_profile_samples_total", callable="test.stride").value
    assert s1 - s0 == 4


def test_disabled_recorder_skips_sampling_entirely():
    fn = profile.wrap("test.disabled", lambda x: torch.as_tensor(x))
    fn(np.ones(3))  # resolve the site
    before = profile.profile_stats()["test.disabled"]
    observe.set_enabled(False)
    try:
        out = fn(np.ones(3))
        assert float(out.sum()) == 3.0
    finally:
        observe.set_enabled(True)
    after = profile.profile_stats()["test.disabled"]
    assert after["calls"] == before["calls"]
    assert after["samples"] == before["samples"]


def test_sample_zero_is_off():
    fn = profile.wrap("test.off", lambda x: torch.as_tensor(x))
    profile.set_sample(0.0)
    assert profile.sample_stride() == 0
    for _ in range(8):
        fn(np.ones(2))
    assert profile.profile_stats().get("test.off", {"samples": 0})["samples"] == 0


def test_output_without_tensor_drops_sample_not_call():
    fn = profile.wrap("test.hostonly", lambda x: {"n": int(x)})
    dropped = observe.counter("pathway_profile_samples_dropped_total")
    before = dropped.value
    assert fn(3) == {"n": 3}
    assert dropped.value == before + 1


def test_injected_fault_drops_sample_and_keeps_result():
    fn = profile.wrap("test.fault", lambda x: torch.as_tensor(x) + 1)
    fn(np.zeros(2))
    samples0 = profile.profile_stats()["test.fault"]["samples"]
    dropped = observe.counter("pathway_profile_samples_dropped_total")
    before = dropped.value
    for mode in ("raise", "hang"):
        inject.arm("profile.sample", mode)
        try:
            out = fn(np.zeros(2))
        finally:
            inject.disarm("profile.sample")
        np.testing.assert_array_equal(out.numpy(), [1.0, 1.0])
    assert dropped.value == before + 2
    assert profile.profile_stats()["test.fault"]["samples"] == samples0


def test_serve_budget_2plus2_with_profiler_sampling_every_call(serve_stack):
    _enc, _ce, _ivf, pipe = serve_stack
    pipe(QUERIES)
    with dispatch_counter.DispatchCounter() as counter:
        got = pipe(QUERIES)
    assert got and all(got)
    assert counter.dispatches == 2, counter.events
    assert counter.fetches == 2, counter.events
    assert profile.drain()
    stats = profile.profile_stats()
    assert stats["serve.fused_ivf"]["samples"] >= 1
    assert stats["rerank.stage2"]["samples"] >= 1


def test_every_reference_label_of_the_stack_is_attributed(serve_stack):
    enc, ce, ivf, _pipe = serve_stack
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.serve import ContinuousDecoder

    enc.encode(QUERIES)
    enc.encode_token_states(QUERIES)
    enc.encode_packed_to_device(QUERIES)
    ce.predict([(QUERIES[0], DOCS[1]), (QUERIES[1], DOCS[2])], packed=False)
    ce.predict([(QUERIES[0], DOCS[1])])
    ivf.search(np.ones((2, 16), np.float32), k=3)
    gen = TextGenerator(dimension=32, n_layers=2, n_heads=4, max_length=64, vocab_size=512, dtype=torch.float32,
                        kv_cache=None, eos_id=None, device="cpu")
    gen.generate(["a prompt"], max_new_tokens=3, use_kv=False)
    gen.generate(["a prompt"], max_new_tokens=3, use_kv=True)
    eng = ContinuousDecoder(gen, slots=2, step_bucket=2, window_us=0, spec_k=3, draft="trunk")
    try:
        eng.generate(["a prompt", "another prompt"], max_new_tokens=6)
    finally:
        eng.stop()
    assert profile.drain()
    stats = profile.profile_stats()
    for label in (
        "encoder.forward", "encoder.token_states", "encoder.packed", "cross_encoder.forward",
        "cross_encoder.packed", "ivf.search", "generator.decode", "generator.kv_decode",
        "generator.slot_prefill", "generator.slot_verify", "generator.slot_draft",
    ):
        assert stats[label]["samples"] >= 1 and stats[label]["device_s"] > 0, label


def test_profile_families_render_and_snapshot_column(serve_stack):
    _enc, _ce, _ivf, pipe = serve_stack
    pipe(QUERIES)
    assert profile.drain()
    body = "\n".join(observe.render_prometheus())
    assert 'pathway_profile_device_seconds_bucket{callable="serve.fused_ivf"' in body
    assert 'pathway_profile_samples_total{callable="rerank.stage2"}' in body
    assert 'pathway_profile_device_share{callable="serve.fused_ivf"}' in body
    assert 'pathway_profile_calls{callable="serve.fused_ivf"}' in body
    snap = observe.snapshot()
    row = snap["profile"]["serve.fused_ivf"]
    assert row["device_s"] > 0 and row["samples"] >= 1
    assert set(row) == set(ref_profile.profile_stats().get("serve.fused_ivf", row))


def test_reset_zeroes_the_window():
    fn = profile.wrap("test.reset", lambda x: torch.as_tensor(x))
    fn(np.ones(2))
    assert profile.profile_stats()["test.reset"]["device_s"] > 0
    profile.reset()
    row = profile.profile_stats()["test.reset"]
    assert row["calls"] == 0 and row["device_s"] == 0.0


def test_import_registers_no_profile_or_ledger_series():
    """Importing every module of the port creates no series of the
    operator plane and registers none of its providers: they appear on
    first use."""
    modules = sorted(
        "pathway_tpu_torch." + ".".join(f.relative_to(_ROOT / "pathway_tpu_torch").with_suffix("").parts)
        for f in (_ROOT / "pathway_tpu_torch").rglob("*.py")
        if f.name != "__init__.py"
    )
    script = textwrap.dedent(
        f"""
        import importlib
        for name in {modules!r}:
            importlib.import_module(name)
        from pathway_tpu_torch.observe import recorder
        names = set(recorder._hists) | set(recorder._counters) | set(recorder._gauges)
        bad = sorted(n for n in names if n.startswith(("pathway_profile_", "pathway_hbm_", "pathway_tuner_",
                                                        "pathway_donation_", "pathway_recompile_")))
        assert not bad, bad
        from pathway_tpu_torch.observe import hbm, profile
        from pathway_tpu_torch.ops import donation_guard
        mine = {{id(m._provider) for m in (hbm, profile, donation_guard)}}
        assert not [p for p in recorder._providers if id(p) in mine]
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=_ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr[-2000:]


def test_first_sampled_call_imports_nothing():
    """``wrap`` resolves the sampling path's fault gate: a fresh process's
    first sampled call imports no module (the import of ``robust`` cost
    that call 14-20 ms on the host of an NVIDIA H100 machine)."""
    script = textwrap.dedent(
        """
        import sys
        import torch
        from pathway_tpu_torch.observe import profile
        assert "pathway_tpu_torch.robust" not in sys.modules
        profile.set_sample(1.0)
        fn = profile.wrap("test.first_call", lambda: torch.ones(1))
        before = set(sys.modules)
        fn()
        assert set(sys.modules) == before, sorted(set(sys.modules) - before)
        assert profile.profile_stats()["test.first_call"]["samples"] == 1
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=_ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
