"""The port's device-memory ledger (``pathway_tpu_torch/observe/hbm.py``)
against the reference (``pathway_tpu/observe/hbm.py``): the ledger over
the port's IVF and exact indexes, forward index, cache tiers, decoder
and modules equals each structure's own byte count (and the reference's
components), the watermark never recedes, the exhaustion ETA equals the
reference's on one synthetic growth series, a stale sample under the
``hbm.ledger`` fault, a raising registrant skipped, weak registration,
and the ``pathway_hbm_*`` families.  On the CPU ``device_bytes()`` is
None; the allocator delta is held in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from pathway_tpu.observe import hbm as ref_hbm
from pathway_tpu_torch import observe
from pathway_tpu_torch.observe import hbm
from pathway_tpu_torch.robust import inject


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _module_bytes(module) -> int:
    """Parameter and buffer bytes of a module, each storage once."""
    seen = {}
    for t in module.state_dict(keep_vars=True).values():
        seen[t.data_ptr()] = _nbytes(t)
    return sum(seen.values())


@pytest.fixture
def stack():
    from pathway_tpu_torch.cache import EmbeddingCache, PrefixKVCache
    from pathway_tpu_torch.index import ForwardIndex
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.serve import ContinuousDecoder

    hbm.reset()
    kw = dict(n_layers=1, n_heads=2, vocab_size=256, dtype=torch.float32, device="cpu")
    enc = SentenceEncoder(dimension=16, max_length=16, **kw)
    ce = CrossEncoderModel(dimension=16, max_length=32, **kw)
    gen = TextGenerator(dimension=32, n_layers=2, n_heads=4, max_length=64, vocab_size=512, dtype=torch.float32,
                        kv_cache=PrefixKVCache(block=4), eos_id=None, device="cpu")
    docs = [f"ledger doc {i} about topic {i % 5}" for i in range(40)]
    ivf = IvfKnnIndex(16, n_clusters=4, n_probe=4, absorb_threshold=1 << 20, device="cpu")
    ivf.add(range(40), enc.encode(docs))
    ivf.build()
    ivf.add([100, 101], enc.encode(["tail one", "tail two"]))
    ivf.search(enc.encode(["q"]), k=3)  # uploads the exact tail
    knn = DeviceKnnIndex(16, initial_capacity=64, device="cpu")
    knn.add(range(10), enc.encode(docs[:10]))
    fwd = ForwardIndex(enc, tokens_per_doc=4, initial_capacity=64)
    fwd.add(range(20), docs[:20])
    emb = EmbeddingCache(max_bytes=1 << 20, device="cpu")
    emb.put_row(b"k", torch.ones(16))
    dec = ContinuousDecoder(gen, slots=2, step_bucket=2, window_us=0)
    dec.generate(["a shared prompt prefix here"], max_new_tokens=3)
    yield dict(enc=enc, ce=ce, gen=gen, ivf=ivf, knn=knn, fwd=fwd, emb=emb, dec=dec)
    dec.stop()
    hbm.reset()


def test_ledger_equals_each_structures_own_bytes(stack):
    s = stack
    doc = hbm.sample()
    sub = doc["subsystems"]
    assert sub["ivf"] == s["ivf"].hbm_bytes()
    assert sub["ivf"]["tail"] == 2 * 16 * 4 and sub["ivf"]["resident"] == sum(
        _nbytes(t) for t in (s["ivf"]._slabs, s["ivf"]._bias, s["ivf"]._centroids))
    assert sub["knn"] == s["knn"].hbm_bytes() == {
        "matrix": _nbytes(s["knn"]._matrix),
        "planes": sum(_nbytes(t) for t in (s["knn"]._valid, s["knn"]._keys_hi, s["knn"]._keys_lo)),
    }
    assert sub["forward"] == {"rows": sum(_nbytes(t) for t in (s["fwd"]._tok, s["fwd"]._scales, s["fwd"]._nvalid))}
    assert sub["cache"]["embedding_rows"] == s["emb"]._tier.bytes == 64
    assert sub["cache"]["prefill_blocks"] == s["gen"].kv_cache._tier.bytes > 0
    assert sub["decode"] == s["dec"].hbm_components() == {
        "kv_pool": sum(_nbytes(t) for t in (s["dec"]._pk, s["dec"]._pv, s["dec"]._rngs))
    }
    assert sub["params"] == {
        "encoder": _module_bytes(s["enc"].module),
        "cross_encoder": _module_bytes(s["ce"].module),
        "generator": _module_bytes(s["gen"].module),
    }
    assert doc["total_bytes"] == sum(sum(parts.values()) for parts in sub.values())
    assert doc["device_bytes"] is None  # no card: the port has no live-array count
    res = doc["resources"]
    assert res["forward_rows"]["used"] == 20 and res["forward_rows"]["capacity"] == s["fwd"]._tok.shape[0]
    assert res["decode_slots"]["capacity"] == 2
    assert res["embedding_cache_bytes"] == {**res["embedding_cache_bytes"], "used": 64.0, "capacity": 1 << 20}
    assert set(res) == {"forward_rows", "decode_slots", "embedding_cache_bytes", "prefill_cache_bytes"}


def test_component_names_are_the_references():
    from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
    from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    rng = np.random.default_rng(0)
    rows = rng.normal(size=(64, 16)).astype(np.float32)
    for Port, Ref, kw in ((IvfKnnIndex, RefIvf, dict(n_clusters=4)), (DeviceKnnIndex, RefKnn, {})):
        port, ref = Port(16, device="cpu", **kw), Ref(16, **kw)
        port.add(range(64), rows)
        ref.add(range(64), rows)
        if kw:
            port.build()
            ref.build()
        assert set(port.hbm_bytes()) == set(ref.hbm_bytes())


def test_ledger_watermark_is_monotone():
    before = hbm.sample()
    assert before["watermark_bytes"] >= before["total_bytes"]
    w0 = before["watermark_bytes"]

    class Blob:
        def hbm_bytes(self):
            return 1 << 22

    blob = Blob()
    hbm.track("test_blob", blob)
    mid = hbm.sample()
    assert mid["watermark_bytes"] >= w0
    assert mid["subsystems"]["test_blob"]["total"] == 1 << 22
    w1 = mid["watermark_bytes"]
    del blob
    gc.collect()
    after = hbm.sample()
    assert "test_blob" not in after["subsystems"]
    assert after["watermark_bytes"] == w1


def test_exhaustion_eta_equals_the_reference_on_one_growth_series():
    class Pool:
        used = 0.0

    pools = (Pool(), Pool())
    mods = (hbm, ref_hbm)
    for mod, pool in zip(mods, pools):
        mod.track_resource("test_eta_pool", pool, lambda p: p.used, lambda p: 1000.0)
    # (t_s, used): idle, steady growth, a back-to-back pair inside the
    # EWMA's zero-dt guard, a burst, then a plateau
    series = [(0.0, 0.0), (1.0, 0.0), (2.0, 50.0), (3.0, 100.0), (3.01, 130.0), (4.0, 160.0), (4.5, 400.0),
              (6.0, 400.0), (9.0, 400.0), (9.2, 900.0)]
    try:
        for t_s, used in series:
            rows = []
            for mod, pool in zip(mods, pools):
                pool.used = used
                rows.append(mod._sample_resources(1000.0 + t_s)["test_eta_pool"])
            assert rows[0] == rows[1], (t_s, rows)
        assert rows[0]["growth_per_s"] > 0 and rows[0]["exhaustion_eta_s"] == pytest.approx(
            100.0 / rows[0]["growth_per_s"])
    finally:
        for mod, pool in zip(mods, pools):
            del pool
        gc.collect()
        for mod in mods:
            mod._growth.pop("test_eta_pool", None)


def test_stale_sample_under_the_fault_site():
    class Blob:
        nbytes = 4096

        def hbm_bytes(self):
            return self.nbytes

    blob = Blob()
    hbm.track("test_stale", blob)
    fresh = hbm.sample()
    assert fresh["stale"] is False and fresh["subsystems"]["test_stale"]["total"] == 4096
    dropped = observe.counter("pathway_hbm_samples_dropped_total")
    before = dropped.value
    blob.nbytes = 8192
    for mode in ("raise", "hang"):
        inject.arm("hbm.ledger", mode)
        try:
            stale = hbm.sample()
        finally:
            inject.disarm("hbm.ledger")
        assert stale["stale"] is True
        assert stale["subsystems"]["test_stale"]["total"] == 4096  # the last good sample
    assert dropped.value == before + 2
    assert hbm.sample()["subsystems"]["test_stale"]["total"] == 8192


def test_raising_registrant_is_skipped():
    class Broken:
        def hbm_bytes(self):
            raise RuntimeError("half torn down")

    class Fine:
        def hbm_bytes(self):
            return {"rows": 123}

    broken, fine = Broken(), Fine()
    hbm.track("test_broken", broken)
    hbm.track("test_fine", fine)
    hbm.track_resource("test_broken_res", broken, lambda o: 1 / 0, lambda o: 1.0)
    doc = hbm.sample()
    assert "test_broken" not in doc["subsystems"]
    assert doc["subsystems"]["test_fine"] == {"rows": 123}
    assert "test_broken_res" not in doc["resources"]
    body = "\n".join(observe.render_prometheus())
    assert 'pathway_hbm_bytes{component="rows",subsystem="test_fine"} 123' in body


def test_families_render_and_snapshot_column(stack):
    body = "\n".join(observe.render_prometheus())
    for line in (
        'pathway_hbm_bytes{component="resident",subsystem="ivf"}',
        'pathway_hbm_bytes{component="encoder",subsystem="params"}',
        'pathway_hbm_bytes{component="kv_pool",subsystem="decode"}',
        "pathway_hbm_total_bytes ",
        "pathway_hbm_watermark_bytes ",
        'pathway_hbm_resource_capacity{resource="decode_slots"} 2',
        'pathway_hbm_exhaustion_eta_seconds{resource="forward_rows"}',
    ):
        assert line in body, line
    assert "pathway_hbm_device_bytes" not in body  # None on the CPU: not rendered
    snap = observe.snapshot()
    assert snap["hbm"]["subsystems"]["ivf"] == stack["ivf"].hbm_bytes()
    assert hbm.ledger_stats() is hbm.ledger_stats()  # a fresh sample is reused


def test_collected_structure_leaves_the_ledger():
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    index = DeviceKnnIndex(32, initial_capacity=512, device="cpu")
    d0 = hbm.sample()["subsystems"]["knn"]["matrix"]
    assert d0 >= 512 * 32 * 4
    del index
    gc.collect()
    assert "knn" not in hbm.sample()["subsystems"] or hbm.sample()["subsystems"]["knn"]["matrix"] < d0
