"""The port's two runtime tripwires against the reference's:

- the shape-census tripwire (``pathway_tpu_torch/ops/recompile_guard.py``):
  the cases of ``tests/test_recompile_guard.py``, and the port's encoder
  and packed cross-encoder census equal to the reference's signature
  set on the same inputs;
- the in-place-write tripwire (``pathway_tpu_torch/ops/donation_guard.py``),
  the port's counterpart of the reference's donation guard: the cases of
  ``tests/test_donation_guard.py`` rebuilt for snapshots and in-place
  writes, absorbs under serve with no violation, and the copies the port
  relies on, taken away by a monkeypatch, caught in strict mode.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from pathway_tpu_torch import observe
from pathway_tpu_torch.ops import donation_guard, ivf as ivf_mod
from pathway_tpu_torch.ops.recompile_guard import (
    RecompileBudgetExceeded,
    RecompileTripwire,
    RecompileWarning,
    guarded_jit,
    signature_of,
    strict_mode,
    trips,
)


# -- shape census -------------------------------------------------------------

def test_strict_mode_defaults_on_under_pytest():
    assert strict_mode()


def test_tripwire_fires_on_varying_shapes():
    @guarded_jit(limit=4)
    def score(x):
        return (x * 2.0).sum()

    with pytest.raises(RecompileBudgetExceeded, match="shape signatures"):
        for n in range(1, 32):
            score(torch.zeros((n, 8)))
    assert score.tripwire.tripped
    assert score.tripwire.signatures > 4
    assert trips()["test_tripwire_fires_on_varying_shapes.<locals>.score"] >= 1  # kept past the wrapper


def test_tripwire_warns_when_not_strict(monkeypatch):
    monkeypatch.setenv("PATHWAY_RECOMPILE_STRICT", "0")

    @guarded_jit(limit=2)
    def score(x):
        return x + 1

    with pytest.warns(RecompileWarning):
        for n in range(1, 8):
            score(torch.zeros((n,)))
    assert score.tripwire.signatures == 7


def test_stable_shapes_never_trip():
    @guarded_jit(limit=2)
    def score(x):
        return x * 3

    for _ in range(50):
        score(torch.zeros((16, 4)))
    assert score.tripwire.signatures == 1
    assert not score.tripwire.tripped


def test_signature_of_distinguishes_shape_dtype_and_statics():
    from pathway_tpu.ops.recompile_guard import signature_of as ref_signature_of

    a = np.zeros((4, 8), np.float32)
    assert signature_of(a) == signature_of(np.ones((4, 8), np.float32))
    assert signature_of(a) != signature_of(np.zeros((4, 9), np.float32))
    assert signature_of(a) != signature_of(np.zeros((4, 8), np.int32))
    assert signature_of(a, k=5) != signature_of(a, k=6)
    # a tensor and an array of one shape and dtype sign alike, as the reference signs arrays
    assert signature_of(torch.zeros((4, 8))) == signature_of(a) == ref_signature_of(a)
    assert signature_of([a, 3], k="x") == ref_signature_of([a, 3], k="x")


def test_observe_dedups_and_counts():
    tw = RecompileTripwire("t", limit=100)
    assert tw.observe((1, 2)) is True
    assert tw.observe((1, 2)) is False
    assert tw.signatures == 1


def test_tripwire_gauges_render():
    tw = RecompileTripwire("test.gauges", limit=7)
    tw.observe(("a",))
    body = "\n".join(observe.render_prometheus())
    labels = f'callable="test.gauges",id="{tw._observe_id}"'
    assert f"pathway_recompile_signatures{{{labels}}} 1" in body
    assert f"pathway_recompile_limit{{{labels}}} 7" in body
    assert f"pathway_recompile_tripped{{{labels}}} 0" in body


def test_bucketed_encoder_census_equals_the_reference():
    """The reference's discipline, held by the port's census: 20 ragged
    workloads through the plain and the packed path collapse to the same
    handful of signatures as the reference's compile keys."""
    from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
    from pathway_tpu_torch.models.encoder import SentenceEncoder

    kw = dict(dimension=64, n_layers=1, n_heads=2, max_length=32)
    ref = RefEncoder(**kw)
    enc = SentenceEncoder(dtype=torch.float32, device="cpu", **kw)
    texts = ["stream " * (1 + i % 7) for i in range(40)]
    for model in (ref, enc):
        for n in (1, 2, 3, 4, 5, 7, 9, 12, 15, 16, 17):
            model.encode(texts[:n])
        for n in (1, 3, 6, 10, 14, 18, 25, 33, 40):
            np.asarray(model.encode_packed_to_device(texts[:n]))
    assert not enc._tripwire.tripped
    assert enc._tripwire.signatures <= 12, enc._tripwire.signatures
    assert enc._tripwire._sigs == ref._tripwire._sigs


def test_bucketed_cross_encoder_packed_census_equals_the_reference():
    from pathway_tpu.models.cross_encoder import CrossEncoderModel as RefCrossEncoder
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel

    kw = dict(dimension=64, n_layers=1, n_heads=2, max_length=64)
    ref = RefCrossEncoder(**kw)
    ce = CrossEncoderModel(dtype=torch.float32, device="cpu", **kw)
    qs = ["what is a stream join"] * 24
    ds = ["docs " * (1 + i % 9) for i in range(24)]
    for model in (ref, ce):
        for n in (1, 2, 4, 6, 9, 13, 18, 24):
            model.predict(list(zip(qs[:n], ds[:n])))
    assert not ce._tripwire.tripped
    assert ce._tripwire.signatures <= 10, ce._tripwire.signatures
    assert ce._tripwire._sigs == ref._tripwire._sigs


def test_generator_census_feeds_its_tripwire(monkeypatch):
    from pathway_tpu_torch.models.generator import TextGenerator

    gen = TextGenerator(dimension=32, n_layers=1, n_heads=4, max_length=64, vocab_size=512, dtype=torch.float32,
                        kv_cache=None, eos_id=None, device="cpu")
    for n in (1, 2, 3, 5):
        gen.generate(["p"] * n, max_new_tokens=2)
    assert gen._tripwire.signatures == len(gen._fns) > 0
    gen._tripwire.limit = len(gen._fns)
    with pytest.raises(RecompileBudgetExceeded):
        gen.generate(["p"] * 17, max_new_tokens=2)  # a new batch bucket past the budget


# -- in-place writes against snapshots ------------------------------------------

@pytest.fixture
def armed(monkeypatch):
    """Arm the guard (strict under pytest) with clean counters."""
    monkeypatch.setenv("PATHWAY_DONATION_GUARD", "1")
    monkeypatch.delenv("PATHWAY_DONATION_GUARD_STRICT", raising=False)
    donation_guard._reset_for_tests()
    yield
    donation_guard._reset_for_tests()


def test_guard_off_is_passthrough(monkeypatch):
    monkeypatch.setenv("PATHWAY_DONATION_GUARD", "0")
    donation_guard._reset_for_tests()
    buf = torch.zeros(4)
    donation_guard.stamp("test.snap", buf)
    buf.add_(1)
    donation_guard.note_write("test.write", buf)
    assert donation_guard.check(buf) is None
    assert donation_guard.guard("test.use", buf) is True
    assert donation_guard.stats() == {"sites": [], "tracked": 0, "written": {}, "violations": {}}


def test_written_snapshot_is_site_attributed(armed):
    live = torch.zeros(8)
    snap = live  # a reference handed out without a copy
    donation_guard.stamp("test.snap", snap)
    assert donation_guard.check(snap) is None
    live.index_fill_(0, torch.tensor([1]), 5.0)
    donation_guard.note_write("test.absorb", live)
    assert donation_guard.check(snap) == "test.absorb"
    assert donation_guard.stats()["written"] == {"test.absorb": 1}


def test_use_of_a_written_snapshot_raises_strict(armed):
    live = np.zeros(16, np.uint64)
    donation_guard.stamp("test.snap", live)
    live[3] = 7
    donation_guard.note_write("test.absorb", live)
    with pytest.raises(donation_guard.DonationViolation) as exc:
        donation_guard.guard("test.serve", live)
    msg = str(exc.value)
    assert "test.absorb" in msg and "test.serve" in msg and "use-after-write" in msg
    assert donation_guard.stats()["violations"] == {"test.serve": 1}


def test_view_written_outside_the_recorded_sites_is_caught(armed):
    """torch's version counter, shared by a base and its views, catches
    an in-place write no site reported."""
    pool = torch.zeros((4, 8))
    block = pool[1, 2:6]  # a captured view instead of a copy
    donation_guard.stamp("test.capture", block)
    pool[1, 3] = 1.0
    with pytest.raises(donation_guard.DonationViolation, match="outside the recorded sites"):
        donation_guard.guard("test.join", block)


def test_production_mode_logs_counts_and_takes_the_copying_path(armed, monkeypatch):
    monkeypatch.setenv("PATHWAY_DONATION_GUARD_STRICT", "0")
    live = torch.zeros(4)
    donation_guard.stamp("test.snap", live)
    live.add_(1)
    donation_guard.note_write("test.absorb", live)
    assert donation_guard.guard("test.serve", live) is False  # the caller copies
    assert donation_guard.stats()["violations"] == {"test.serve": 1}


def test_copy_before_the_write_is_clean(armed):
    live = torch.zeros(4)
    snap = live.clone()
    donation_guard.stamp("test.snap", snap)
    live.add_(1)
    donation_guard.note_write("test.absorb", live)
    assert donation_guard.guard("test.serve", snap) is True
    assert donation_guard.stats()["violations"] == {}


def test_metric_families_render(armed):
    live = torch.zeros(2)
    donation_guard.note_write("test.scatter", live)
    body = "\n".join(observe.render_prometheus())
    assert 'pathway_donation_poisoned_total{site="test.scatter"} 1' in body
    assert 'pathway_donation_violations_total{site="test.scatter"} 0' in body


def _ivf_serve_stack():
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    enc = SentenceEncoder(dimension=16, n_layers=1, n_heads=2, max_length=16, vocab_size=256,
                          dtype=torch.float32, device="cpu")
    docs = [f"guard doc {i} about topic {i % 7}" for i in range(64)]
    index = IvfKnnIndex(16, n_clusters=4, n_probe=4, absorb_threshold=8, device="cpu")
    index.add(range(64), enc.encode(docs))
    index.build()
    return enc, index, FusedEncodeSearch(enc, index, k=5, embed_cache=None), docs


def _absorb(index, enc, start: int, n: int = 8) -> None:
    index.add(range(start, start + n), enc.encode([f"fresh row {i}" for i in range(start, start + n)]))
    t_end = time.monotonic() + 20.0
    while (index._absorbing or index._retraining) and time.monotonic() < t_end:
        time.sleep(0.01)
    assert not index._absorbing


def test_absorbs_under_serve_raise_no_violation(armed):
    enc, index, serve, docs = _ivf_serve_stack()
    absorbs0 = index.stats["absorbs"]
    for r in range(4):
        handle = serve.submit(docs[:3])  # its keys_by_slot is stamped at dispatch
        _absorb(index, enc, 1000 + 8 * r)
        assert len(handle()) == 3
    assert index.stats["absorbs"] > absorbs0
    stats = donation_guard.stats()
    assert stats["violations"] == {} and stats["written"].get("ivf.absorb", 0) > 0
    assert serve([f"fresh row {1000}"])[0][0][0] == 1000


def test_absorb_writing_the_served_slot_map_in_place_is_caught(armed, monkeypatch):
    enc, index, serve, docs = _ivf_serve_stack()
    monkeypatch.setattr(ivf_mod, "_keys_copy", lambda keys_by_slot: keys_by_slot)  # no copy-on-write
    handle = serve.submit(docs[:3])
    _absorb(index, enc, 2000)
    with pytest.raises(donation_guard.DonationViolation, match="ivf.absorb.*ivf.serve"):
        handle()


def test_warm_state_taken_in_without_its_copy_is_caught(armed, monkeypatch):
    """The copy ``load_warm_state`` makes of a snapshot (``_own_copy``)
    taken away: the in-place absorb then writes the caller's arrays, and
    the next use of that snapshot raises."""
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex

    enc, index, _serve, _docs = _ivf_serve_stack()
    state = index.warm_state()
    monkeypatch.setattr(ivf_mod, "_own_copy", lambda a: np.asarray(a, np.float32))
    restored = IvfKnnIndex(16, n_clusters=4, n_probe=4, absorb_threshold=8, device="cpu")
    restored.load_warm_state(state)
    bias0 = state["bias"].copy()
    _absorb(restored, enc, 3000)
    assert not np.array_equal(state["bias"], bias0)  # the absorb reached the snapshot
    again = IvfKnnIndex(16, n_clusters=4, n_probe=4, absorb_threshold=8, device="cpu")
    with pytest.raises(donation_guard.DonationViolation, match="ivf.absorb.*ivf.load_warm_state"):
        again.load_warm_state(state)


def test_warm_state_taken_in_with_its_copy_is_clean(armed):
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex

    enc, index, _serve, _docs = _ivf_serve_stack()
    state = index.warm_state()
    restored = IvfKnnIndex(16, n_clusters=4, n_probe=4, absorb_threshold=8, device="cpu")
    restored.load_warm_state(state)
    _absorb(restored, enc, 4000)
    IvfKnnIndex(16, n_clusters=4, n_probe=4, absorb_threshold=8, device="cpu").load_warm_state(state)
    assert donation_guard.stats()["violations"] == {}


def test_prefix_blocks_stay_intact_under_pool_writes(armed):
    """The engine's captured prefix blocks are copies of the slot pool,
    which every step writes in place: a warm join reads them clean."""
    from pathway_tpu_torch.cache import PrefixKVCache
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.serve import ContinuousDecoder

    gen = TextGenerator(dimension=32, n_layers=2, n_heads=4, max_length=64, vocab_size=512, dtype=torch.float32,
                        kv_cache=PrefixKVCache(block=4), eos_id=None, device="cpu")
    eng = ContinuousDecoder(gen, slots=2, step_bucket=2, window_us=0)
    prompt = "a shared system prompt for every request of this test "
    try:
        cold = eng.generate([prompt + "one"], max_new_tokens=4)
        warm = eng.generate([prompt + "one", prompt + "two"], max_new_tokens=4)
    finally:
        eng.stop()
    assert warm[0] == cold[0]
    stats = donation_guard.stats()
    assert stats["written"].get("decode.slot_pool", 0) > 0 and stats["violations"] == {}
    assert "decode.prefix_capture" in stats["sites"] and "generator.prefix_rows" in stats["sites"]
