"""Port parity: the IVF rescore and ``IvfKnnIndex`` of ``pathway_tpu_torch``
against the reference.

- ``ivf_rescore_reference`` (the plain version beside the CUDA kernel)
  against the Pallas kernel run in interpret mode and against the
  reference's XLA slab gather; f32 atol 1e-4 (summation order differs),
  and the -inf pattern must be identical.
- The port's own k-means + balanced layout must give the reference's
  ``slot_of_key`` on well-separated blobs (integers: exact).
- After ``load_warm_state(reference.warm_state())`` the port's search must
  return the reference's keys (hence slots: the slot maps are equal),
  allowing a swap only between scores tied within 1e-5; scores within
  1e-4.
- Absorb: after adds past a small ``absorb_threshold`` both packages
  place the tail in the same free slots (``slot_of_key``,
  ``keys_by_slot``, tail, ``live_mask`` and bias equal integer for
  integer), freed slots are reused alike, and a plan outdated by a build
  or by changed rows is handled alike.
"""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.ivf_pallas import ivf_rescore, rescore_shortlist as ref_rescore
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.ivf_rescore import ivf_rescore_reference, rescore_shortlist


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's default of one thread
    per core would crowd the timing-sensitive tests of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIE = 1e-5
SCORE_ATOL = 1e-4


def assert_same_ranking(want, got, tie=TIE, atol=SCORE_ATOL):
    """``want``/``got``: [(key, score), ...] rows sorted by score.  Keys
    must agree position by position, except between scores tied within
    ``tie`` (a tie may break either way)."""
    assert len(got) == len(want)
    ws = [s for _, s in want]
    for j, ((wk, wsc), (gk, gsc)) in enumerate(zip(want, got)):
        assert abs(wsc - gsc) <= atol, (j, wsc, gsc)
        if wk != gk:
            tied = any(
                abs(ws[i] - wsc) <= tie for i in (j - 1, j + 1) if 0 <= i < len(ws)
            )
            assert tied and abs(wsc - gsc) <= tie, (j, want, got)


def _rescore_case(B, p, C, M, d, seed=3, inf_frac=0.2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, d)).astype(np.float32)
    slabs = rng.normal(size=(C, M, d)).astype(np.float32)
    bias = np.where(rng.random((C, M)) < inf_frac, -np.inf, 0.0).astype(np.float32)
    if p == C:
        probe = np.stack([rng.permutation(C) for _ in range(B)]).astype(np.int32)
    else:
        probe = rng.integers(0, C, size=(B, p)).astype(np.int32)
    return probe, q, slabs, bias


def _assert_scores(got, want):
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(np.where(fin, got, 0.0), np.where(fin, want, 0.0), atol=SCORE_ATOL)


@pytest.mark.parametrize(
    "B,p,C,M,d",
    [
        (8, 4, 16, 128, 128),  # the Pallas kernel's own test shape
        (3, 5, 16, 128, 128),  # B not a multiple of 8
        (8, 16, 16, 128, 128),  # p = C
    ],
)
def test_plain_rescore_matches_pallas_interpret(B, p, C, M, d):
    probe, q, slabs, bias = _rescore_case(B, p, C, M, d)
    got = ivf_rescore_reference(
        torch.from_numpy(probe), torch.from_numpy(q), torch.from_numpy(slabs), torch.from_numpy(bias)
    ).numpy()
    # the Pallas kernel needs B % 8 == 0: pad as rescore_shortlist does
    B8 = ((B + 7) // 8) * 8
    pq = np.concatenate([q, np.zeros((B8 - B, d), np.float32)])
    pp = np.concatenate([probe, np.zeros((B8 - B, p), np.int32)])
    pallas = np.asarray(
        ivf_rescore(jnp.asarray(pp), jnp.asarray(pq), jnp.asarray(slabs), jnp.asarray(bias), interpret=True)
    )[:B]
    xla = np.asarray(
        ref_rescore(jnp.asarray(probe), jnp.asarray(q), jnp.asarray(slabs), jnp.asarray(bias), use_pallas=False)
    )
    assert got.shape == (B, p, M)
    _assert_scores(got, pallas)
    _assert_scores(got, xla)


@pytest.mark.parametrize("B,p,C,M,d", [(3, 7, 7, 200, 96), (5, 3, 9, 33, 99)])
def test_plain_rescore_odd_shapes_and_bf16(B, p, C, M, d):
    """M and d not multiples of 128, C not a multiple of 8, bf16 slabs
    (compared against the reference fed the same bf16 slabs)."""
    probe, q, slabs, bias = _rescore_case(B, p, C, M, d, seed=5)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        s_t = torch.from_numpy(slabs).to(tdt)
        got = rescore_shortlist(torch.from_numpy(probe), torch.from_numpy(q), s_t, torch.from_numpy(bias))
        want = ref_rescore(
            jnp.asarray(probe), jnp.asarray(q), jnp.asarray(slabs, jdt), jnp.asarray(bias), use_pallas=False
        )
        _assert_scores(got.numpy(), np.asarray(want))


def _blobs(n_blobs=16, per=128, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_blobs, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    data = np.repeat(centers, per, axis=0) + 0.05 * rng.normal(size=(n_blobs * per, dim)).astype(np.float32)
    keys = [int(k) for k in rng.permutation(10 * n_blobs * per)[: n_blobs * per] * 7919 + 3]
    return keys, data.astype(np.float32), rng


def test_port_build_gives_reference_slots():
    keys, data, _ = _blobs()
    ref = RefIvf(dimension=32, n_clusters=16, seed=1)
    ref.add(keys, data)
    ref.build()
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=1, device="cpu")
    port.add(keys, data)
    port.build()
    assert port._slot_of_key == ref._slot_of_key
    assert (port._M_pad, port._d_pad) == (ref._M_pad, ref._d_pad)
    np.testing.assert_array_equal(port._keys_by_slot, ref._keys_by_slot)
    np.testing.assert_array_equal(port._bias.numpy(), np.asarray(ref._bias))
    np.testing.assert_allclose(port._slabs.numpy(), np.asarray(ref._slabs), atol=1e-6)


def test_port_build_from_matrix_gives_reference_slots():
    keys, data, _ = _blobs(seed=2)
    ref = RefIvf(dimension=32, n_clusters=16, seed=4)
    ref.build_from_matrix(keys, jnp.asarray(data))
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=4, device="cpu")
    port.build_from_matrix(keys, torch.from_numpy(data))
    assert port._slot_of_key == ref._slot_of_key
    np.testing.assert_allclose(port._slabs.numpy(), np.asarray(ref._slabs), atol=1e-6)
    assert len(port) == len(ref) == len(keys)


@pytest.mark.parametrize("slab_dtype", ["f32", "bf16"])
def test_search_after_warm_state_matches_reference(slab_dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[slab_dtype]
    keys, data, rng = _blobs(seed=6)
    ref = RefIvf(dimension=32, n_clusters=16, seed=1, dtype=jdt)
    ref.add(keys, data)
    ref.build()
    # a few rows after the build ride the exact tail; one upsert, one removal
    fresh = rng.normal(size=(5, 32)).astype(np.float32)
    ref.add([1, 2, 3, 4, keys[0]], fresh)
    ref.remove([keys[1]])
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=1, dtype=tdt, device="cpu")
    port.load_warm_state(ref.warm_state())
    assert port._slot_of_key == ref._slot_of_key and len(port) == len(ref)
    queries = np.concatenate([data[::97] + 0.01, fresh[:2]])
    for n_probe in (None, 16):
        want = ref.search(queries, k=10, n_probe=n_probe)
        got = port.search(queries, k=10, n_probe=n_probe)
        for w, g in zip(want, got):
            assert_same_ranking(w, g)
    assert all(keys[1] not in {k for k, _ in row} for row in got)


# -- absorb ------------------------------------------------------------------


def _wait_absorbed(*indexes, timeout=60.0):
    deadline = time.monotonic() + timeout
    while any(ix._absorbing for ix in indexes):
        assert time.monotonic() < deadline, "absorb did not finish"
        time.sleep(0.01)


def _assert_same_layout(port, ref):
    """Slots, keys, tail, occupancy and bias equal integer for integer;
    slab rows equal to f32 rounding."""
    assert port._slot_of_key == ref._slot_of_key
    np.testing.assert_array_equal(port._keys_by_slot, ref._keys_by_slot)
    assert list(port._tail) == list(ref._tail)
    np.testing.assert_array_equal(port._live_mask, ref._live_mask)
    np.testing.assert_array_equal(port._bias.float().numpy(), np.asarray(ref._bias, np.float32))
    np.testing.assert_allclose(
        port._slabs.float().numpy(), np.asarray(ref._slabs, np.float32), atol=1e-6
    )


def _absorb_pair(seed, from_matrix=False, threshold=64, **kw):
    """A reference and a port index over the same blobs, built the same
    way, with a small absorb threshold."""
    keys, data, rng = _blobs(seed=seed)
    ref = RefIvf(dimension=32, n_clusters=16, seed=1, absorb_threshold=threshold, **kw)
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=1, absorb_threshold=threshold, device="cpu")
    if from_matrix:
        ref.build_from_matrix(keys, jnp.asarray(data))
        port.build_from_matrix(keys, torch.from_numpy(data))
    else:
        ref.add(keys, data)
        ref.build()
        port.add(keys, data)
        port.build()
    return ref, port, keys, data, rng


@pytest.mark.parametrize("from_matrix", [False, True])
def test_absorb_matches_reference(from_matrix):
    """Adds past ``absorb_threshold`` move the tail into free slots in both
    packages, with equal slots; searches then agree.  One batch lands near
    a single blob, so its cluster fills and the rest spill to their next
    preference."""
    ref, port, keys, data, rng = _absorb_pair(seed=8, from_matrix=from_matrix)
    near = data[::29][:70] + 0.02 * rng.normal(size=(70, 32)).astype(np.float32)
    crowd = data[5] + 0.02 * rng.normal(size=(200, 32)).astype(np.float32)
    upsert = rng.normal(size=(3, 32)).astype(np.float32)
    for batch_keys, batch in (
        ([10**9 + i for i in range(70)], near),
        ([2 * 10**9 + i for i in range(200)], crowd),
        (keys[:3], upsert),
    ):
        ref.add(batch_keys, batch)
        port.add(batch_keys, batch)
        _wait_absorbed(ref, port)
    assert port.stats["absorbs"] == ref.stats["absorbs"] >= 2
    assert port.stats["absorb_failures"] == ref.stats["absorb_failures"] == 0
    _assert_same_layout(port, ref)
    assert len(port._tail) < 64 and len(port) == len(ref)
    queries = np.concatenate([near[:10], crowd[:10], upsert, data[::211]])
    for n_probe in (None, 4, 16):
        for w, g in zip(ref.search(queries, k=10, n_probe=n_probe), port.search(queries, k=10, n_probe=n_probe)):
            assert_same_ranking(w, g)


def test_absorb_reuses_freed_slots_as_reference():
    """A removed row frees its slot (live mask cleared, absorb re-armed);
    the next absorb fills it exactly where the reference does."""
    ref, port, keys, data, rng = _absorb_pair(seed=9)
    gone = keys[::97][:12]
    ref.remove(gone)
    port.remove(gone)
    freed = sorted(ref_slot for ref_slot in np.flatnonzero(~ref._live_mask))
    np.testing.assert_array_equal(port._live_mask, ref._live_mask)
    fresh = data[::97][:12] + 0.01 * rng.normal(size=(12, 32)).astype(np.float32)
    more = data[1::33][:60] + 0.02 * rng.normal(size=(60, 32)).astype(np.float32)
    new_keys = [3 * 10**9 + i for i in range(72)]
    ref.add(new_keys, np.concatenate([fresh, more]))
    port.add(new_keys, np.concatenate([fresh, more]))
    _wait_absorbed(ref, port)
    _assert_same_layout(port, ref)
    reused = {port._slot_of_key[k] for k in new_keys if k in port._slot_of_key}
    assert reused & set(int(s) for s in freed), "no freed slot was reused"
    got = port.search(fresh, k=5)
    for w, g in zip(ref.search(fresh, k=5), got):
        assert_same_ranking(w, g)
    assert all(k not in {key for key, _ in row} for row in got for k in gone)


def test_absorb_plan_aborts_when_a_build_lands():
    """A plan made against one layout is dropped at commit when a build
    installed another in between (``_layout_gen``); the tail stays for the
    next absorb, in both packages alike."""
    results = []
    for make in ("ref", "port"):
        ref, port, keys, data, rng = _absorb_pair(seed=10, threshold=10**6)
        ix = ref if make == "ref" else port
        fresh = data[::50][:30] + 0.01 * rng.normal(size=(30, 32)).astype(np.float32)
        ix.add([4 * 10**9 + i for i in range(30)], fresh)
        with ix._lock:
            snap = ix._absorb_snapshot()
        plan = ix._plan_absorb(snap)
        assert plan["placed"].size == 30
        ix.build()  # a new layout: the plan's slots refer to the old one
        gen = ix.generation
        with ix._lock:
            ix._commit_absorb(snap, plan)
        assert ix.generation == gen and ix.stats["absorbs"] == 0
        results.append((dict(ix._slot_of_key), list(ix._tail)))
    assert results[0] == results[1]


def test_absorb_skips_rows_changed_during_plan():
    """Rows upserted or removed while the plan ran are dropped from the
    commit (vector identity check), the rest land as in the reference."""
    results = []
    for make in ("ref", "port"):
        ref, port, keys, data, rng = _absorb_pair(seed=11, threshold=10**6)
        ix = ref if make == "ref" else port
        fresh = data[::50][:30] + 0.01 * np.random.default_rng(3).normal(size=(30, 32)).astype(np.float32)
        new_keys = [5 * 10**9 + i for i in range(30)]
        ix.add(new_keys, fresh)
        with ix._lock:
            snap = ix._absorb_snapshot()
        plan = ix._plan_absorb(snap)
        ix.add(new_keys[:2], fresh[:2] * 0.5)  # upserted: stale
        ix.remove(new_keys[2:4])  # removed: stale
        with ix._lock:
            ix._commit_absorb(snap, plan)
        assert set(new_keys[:2]) <= set(ix._tail) and not set(new_keys[2:4]) & set(ix._slot_of_key)
        results.append((dict(ix._slot_of_key), list(ix._tail), np.array(ix._live_mask)))
    assert results[0][:2] == results[1][:2]
    np.testing.assert_array_equal(results[0][2], results[1][2])


def test_warm_state_carries_live_mask_and_absorbs_like_reference():
    """After ``load_warm_state`` the port absorbs from the reference's
    occupancy to the reference's slots."""
    ref, _, keys, data, rng = _absorb_pair(seed=12)
    ref.remove(keys[:5])
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=1, absorb_threshold=64, device="cpu")
    port.load_warm_state(ref.warm_state())
    np.testing.assert_array_equal(port._live_mask, ref._live_mask)
    fresh = data[::29][:70] + 0.01 * rng.normal(size=(70, 32)).astype(np.float32)
    new_keys = [6 * 10**9 + i for i in range(70)]
    ref.add(new_keys, fresh)
    port.add(new_keys, fresh)
    _wait_absorbed(ref, port)
    _assert_same_layout(port, ref)


def test_absorb_under_concurrent_writers_keeps_every_row():
    """Writer threads add, remove and re-add while background absorbs
    commit: no row is lost or duplicated (each live key sits in exactly
    one of the slots and the tail, the live mask counts the slots), and a
    search finds every live row."""
    keys, data, rng = _blobs(seed=13)
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=1, absorb_threshold=16, device="cpu")
    port.build_from_matrix(keys, torch.from_numpy(data))
    fresh = data[::4] + 0.01 * rng.normal(size=(512, 32)).astype(np.float32)
    n_writers = 8

    def writer(w):
        mine = list(range(7 * 10**9 + w * 64, 7 * 10**9 + (w + 1) * 64))
        for i in range(0, 64, 8):
            port.add(mine[i : i + 8], fresh[w * 64 + i : w * 64 + i + 8])
            if i % 16 == 8:
                port.remove(mine[i - 8 : i - 6])
                port.add(mine[i - 7 : i - 6], fresh[w * 64 + i - 7 : w * 64 + i - 6])  # re-added

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(n_writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        _wait_absorbed(port)
    finally:
        sys.setswitchinterval(switch)
    removed = {7 * 10**9 + w * 64 + i for w in range(n_writers) for i in range(0, 64, 16)}
    live = set(keys) | {7 * 10**9 + j for j in range(n_writers * 64)}
    live -= removed
    assert port.stats["absorbs"] >= 1 and port.stats["absorb_failures"] == 0
    assert set(port._slot_of_key) | set(port._tail) == live
    assert not set(port._slot_of_key) & set(port._tail)
    assert int(port._live_mask.sum()) == len(port._slot_of_key) and len(port) == len(live)
    assert all(port._keys_by_slot[s] == k for k, s in port._slot_of_key.items())
    query_keys = sorted(k for k in live if k >= 7 * 10**9)[::7]
    vecs = {7 * 10**9 + j: fresh[j] for j in range(n_writers * 64)}
    port.n_probe = 16
    got = port.search(np.stack([vecs[k] for k in query_keys]), k=1)
    assert [row[0][0] for row in got] == query_keys


# -- background retrain --------------------------------------------------------


def _wait_maintenance(*indexes, timeout=60.0):
    deadline = time.monotonic() + timeout
    while any(ix._absorbing or ix._retraining for ix in indexes):
        assert time.monotonic() < deadline, "background maintenance did not finish"
        time.sleep(0.01)


@pytest.mark.parametrize("threshold", [10**6, 64])
def test_background_retrain_matches_reference(threshold):
    """Host rows grown past ``rebuild_fraction`` of the build start a
    background retrain in both packages (racing an absorb when the tail
    also crosses ``absorb_threshold``); once both are done the layouts
    are equal integer for integer and searches agree."""
    ref, port, keys, data, rng = _absorb_pair(seed=14, threshold=threshold)
    fresh = data[::3] + 0.02 * rng.normal(size=(683, 32)).astype(np.float32)
    new_keys = [8 * 10**9 + i for i in range(len(fresh))]
    for ix in (ref, port):
        ix.add(new_keys, fresh)
    _wait_maintenance(ref, port)
    assert port.stats["retrains"] == ref.stats["retrains"] == 1
    assert port.stats["retrain_failures"] == ref.stats["retrain_failures"] == 0
    _assert_same_layout(port, ref)
    assert not port._tail and port._built_n == ref._built_n == len(keys) + len(fresh)
    queries = np.concatenate([fresh[::50], data[::211]])
    for w, g in zip(ref.search(queries, k=10, n_probe=4), port.search(queries, k=10, n_probe=4)):
        assert_same_ranking(w, g)
    assert port.stats["retrains"] == 1  # the search found nothing stale


def test_retrain_install_reconciles_changes_as_reference():
    """Rows upserted, removed or added while a layout trained off the
    lock are reconciled at install alike in both packages: stale keys
    masked out (-inf bias, live mask cleared) and kept in the tail when
    still present, keys the snapshot never saw left in the tail."""
    layouts = []
    for make in ("ref", "port"):
        ref, port, keys, data, _ = _absorb_pair(seed=15, threshold=10**6)
        ix = ref if make == "ref" else port
        with ix._lock:
            snapshot = dict(ix._rows)
        built = ix._train_layout(snapshot)
        ix.add(keys[:2], -data[:2])  # upserted meanwhile
        ix.remove(keys[2:4])
        ix.add([9 * 10**9], data[5:6] + 0.01)  # never in the snapshot
        stale_slots = [built["slot_of_key"][k] for k in keys[:4]]
        with ix._lock:
            ix._install(built, snapshot)
        assert list(ix._tail) == [keys[0], keys[1], 9 * 10**9]
        assert not set(keys[:4]) & set(ix._slot_of_key)
        assert not ix._live_mask[stale_slots].any()
        assert int(ix._live_mask.sum()) == len(ix._slot_of_key) == len(keys) - 4
        layouts.append(ix)
    _assert_same_layout(layouts[1], layouts[0])


def test_upsert_and_remove_during_background_retrain_reconciled():
    """Within the port (the reference's race test): a writer keeps
    removing one key and upserting another to the opposite vector while
    the background retrain runs; nothing resurrects, the upsert wins."""
    keys, data, _ = _blobs(seed=16)
    port = IvfKnnIndex(dimension=32, n_clusters=16, n_probe=16, seed=1, absorb_threshold=10**6, device="cpu")
    port.add(keys, data)
    port.build()
    extra = data[::2] + 0.05
    port.add([10**10 + i for i in range(len(extra))], extra)  # stale: retrain starts
    stop = threading.Event()

    def mutate():
        while not stop.is_set():
            port.remove([keys[7]])
            port.add([keys[9]], -data[9:10])
            time.sleep(0.0005)  # let the retrain thread take the lock between rounds

    writer = threading.Thread(target=mutate, daemon=True)
    writer.start()
    try:
        _wait_maintenance(port)
    finally:
        stop.set()
        writer.join(timeout=10)
    assert not writer.is_alive()
    assert port.stats["retrains"] == 1 and port.stats["retrain_failures"] == 0
    assert all(key != keys[7] for key, _ in port.search(data[7:8], k=3)[0])
    assert port.search(-data[9:10], k=1)[0][0][0] == keys[9]


def test_build_from_matrix_never_retrains_like_reference():
    ref, port, keys, data, rng = _absorb_pair(seed=17, from_matrix=True, threshold=10**6)
    fresh = data[::2] + 0.02 * rng.normal(size=(1024, 32)).astype(np.float32)
    for ix in (ref, port):
        ix.add([11 * 10**9 + i for i in range(len(fresh))], fresh)
        ix.maybe_retrain_async()
        assert not ix._retraining and ix.stats["retrains"] == 0
    _assert_same_layout(port, ref)


def test_port_warm_state_loads_into_reference():
    """``warm_state()`` of the port (after an absorb and a removal) in
    the reference's format: the reference serves the same keys from it."""
    ref, port, keys, data, rng = _absorb_pair(seed=18)
    fresh = data[::29][:70] + 0.01 * rng.normal(size=(70, 32)).astype(np.float32)
    port.add([12 * 10**9 + i for i in range(70)], fresh)
    _wait_absorbed(port)
    port.remove(keys[:3])
    restored = RefIvf(dimension=32, n_clusters=16, seed=1)
    restored.load_warm_state(port.warm_state())
    _assert_same_layout(port, restored)
    queries = np.concatenate([fresh[:10], data[::97]])
    for w, g in zip(restored.search(queries, k=10), port.search(queries, k=10)):
        assert_same_ranking(w, g)


# -- the filtered search surface ---------------------------------------------------


def _filtered_pair(kind, metric):
    from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    keys, data, rng = _blobs(seed=21)
    if kind == "exact":
        ref, port = RefKnn(32, metric=metric, initial_capacity=4096), DeviceKnnIndex(
            32, metric=metric, initial_capacity=4096, device="cpu"
        )
        ref.add(keys, data)
        port.add(keys, data)
    else:
        ref = RefIvf(dimension=32, n_clusters=16, seed=1, metric=metric)
        ref.add(keys, data)
        ref.build()
        ref.add([5, 6, 7], rng.normal(size=(3, 32)).astype(np.float32))  # an exact tail
        port = IvfKnnIndex(dimension=32, n_clusters=16, seed=1, metric=metric, device="cpu")
        port.load_warm_state(ref.warm_state())
    return ref, port, keys, data


@pytest.mark.parametrize("kind,metric", [("exact", "cos"), ("exact", "l2sq"), ("exact", "dot"), ("ivf", "cos")])
def test_search_oversampled_matches_reference(kind, metric):
    """Filtered search by over-sampling: a rare filter widens past the
    first round (and past the probed clusters of an IVF); the rows equal
    the reference's."""
    ref, port, keys, data = _filtered_pair(kind, metric)
    queries = data[::211] + 0.01
    for accept in (lambda k: k % 2 == 0, lambda k: k % 97 == 0, lambda k: False):
        for k, oversample, rounds in ((5, 4, 3), (10, 2, 1), (3, 1, 5)):
            want = ref.search_oversampled(queries, k, accept, oversample=oversample, max_rounds=rounds)
            got = port.search_oversampled(queries, k, accept, oversample=oversample, max_rounds=rounds)
            assert [len(r) for r in got] == [len(r) for r in want]
            for w, g in zip(want, got):
                assert_same_ranking(w, g)
                assert all(accept(key) for key, _ in g)


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
def test_scores_to_distances_matches_reference(metric):
    ref, port, _, data = _filtered_pair("exact", metric)
    rng = np.random.default_rng(4)
    scores = rng.normal(size=(3, 5)).astype(np.float32)
    norms = np.linalg.norm(data[:3], axis=1)
    np.testing.assert_array_equal(port.scores_to_distances(scores, norms), ref.scores_to_distances(scores, norms))


def test_score_flops_fraction_matches_reference():
    ref, port, _, _ = _filtered_pair("ivf", "cos")
    empty = IvfKnnIndex(dimension=32, device="cpu")
    assert empty.score_flops_fraction() == RefIvf(dimension=32).score_flops_fraction() == 1.0
    for n_probe in (None, 3, 16, 40):
        ref.n_probe = port.n_probe = n_probe
        assert port.score_flops_fraction() == ref.score_flops_fraction()
    assert 0.0 < port.score_flops_fraction() <= 1.0 + 16 * port._M_pad / len(port)
