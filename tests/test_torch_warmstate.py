"""Port parity of durable warm state on the CPU: ``WarmStateManager``,
the CRC framing and the backends of ``pathway_tpu_torch`` against
``pathway_tpu``.

- ``frame`` gives the same bytes in both packages and ``scan`` agrees
  on intact, torn and corrupt blobs;
- cross-restore both ways: a snapshot of the IVF index, the forward
  index and the result and embedding caches written by one package's
  manager is copied blob by blob into the other's backend and restored;
  the restored stack serves the writer's rows (keys in order, scores
  within 1e-4, the two encoders' f32 rounding) and its caches hold the
  writer's entries exactly;
- a port replica restored warm serves bit-identically to the port
  writer (``torch.equal`` on the stage-1 device outputs, equal rows);
- the reference's corruption and cadence cases (CRC with fallback to
  the older snapshot, truncation, install mismatch, missing manifest,
  empty backend, prune, manual interval, single-process agreement, the
  snapshot and restore fault sites) give equal ``RestoreReport`` fields
  and equal counter deltas in both packages.
"""

import numpy as np
import pytest
import torch

from pathway_tpu import observe as ref_observe
from pathway_tpu.cache import EmbeddingCache as RefEmbeddingCache
from pathway_tpu.cache import ResultCache as RefResultCache
from pathway_tpu.index import ForwardIndex as RefForward
from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.persistence import framing as ref_framing
from pathway_tpu.persistence.backends import MemoryBackend as RefMemoryBackend
from pathway_tpu.robust import inject as ref_inject
from pathway_tpu.serve.warmstate import WarmStateManager as RefManager
from pathway_tpu_torch import observe
from pathway_tpu_torch.cache import EmbeddingCache, ResultCache
from pathway_tpu_torch.index import ForwardIndex
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.parallel import distributed as dist
from pathway_tpu_torch.persistence import FileBackend, MemoryBackend, frame, frame_all, scan
from pathway_tpu_torch.robust import Deadline, inject
from pathway_tpu_torch.serve import RestoreReport, WarmStateManager

from .test_torch_forward import T_DOC, corpus, encoders
from .test_torch_ivf import assert_same_ranking

DOCS = {i: t for i, t in enumerate(corpus(36, seed=21, lo=3, hi=20))}
QUERIES = [" ".join(DOCS[i].split()[::2]) for i in (4, 11, 30)]
_KINDS = ("injected", "manifest", "missing", "crc", "truncated", "unpickle", "install")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarmed():
    inject.disarm()
    ref_inject.disarm()
    yield
    inject.disarm()
    ref_inject.disarm()


@pytest.fixture(scope="module")
def pair():
    ref_enc, enc = encoders()
    keys = sorted(DOCS)
    return ref_enc, enc, keys, ref_enc.encode([DOCS[k] for k in keys])


# one package per entry: the classes a scenario builds
SIDES = {
    "ref": dict(obs=ref_observe, inject=ref_inject, manager=RefManager, backend=RefMemoryBackend, ivf=RefIvf,
                forward=RefForward, result=RefResultCache, embed=RefEmbeddingCache),
    "port": dict(obs=observe, inject=inject, manager=WarmStateManager, backend=MemoryBackend,
                 ivf=lambda **kw: IvfKnnIndex(device="cpu", **kw), forward=ForwardIndex, result=ResultCache,
                 embed=lambda: EmbeddingCache(device="cpu")),
}
IVF = dict(dimension=32, metric="cos", n_clusters=4, n_probe=4)


def _ivf(side, pair, n=None):
    _ref_enc, _enc, keys, vecs = pair
    index = SIDES[side]["ivf"](**IVF)
    n = n or len(keys)
    index.add(keys[:n], vecs[:n])
    index.build()
    return index


# -- framing ------------------------------------------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 9472, 70_001])
def test_frame_bytes_equal_reference(size):
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert frame(payload) == ref_framing.frame(payload)


def _blobs():
    a, b, c = frame(b"first chunk"), frame(b"second" * 100), frame(b"")
    whole = a + b + c
    flipped = bytearray(whole)
    flipped[len(a) + 20] ^= 0xFF
    return {
        "intact": whole,
        "torn_header": whole + b"\x05\x00",
        "torn_payload": whole[:-3] + frame(b"tail")[:10],
        "corrupt_middle": bytes(flipped),
        "empty": b"",
        "garbage": b"\xff" * 13,
    }


@pytest.mark.parametrize("case", sorted(_blobs()))
def test_scan_agrees_with_reference(case):
    blob = _blobs()[case]
    got, want = scan(blob), ref_framing.scan(blob)
    assert got == want
    assert got[1] == (case in ("intact", "empty"))


@pytest.mark.parametrize("corrupt", [None, 0, 5, 8])
def test_bulk_framing_matches_reference(corrupt):
    """Nine 1 MiB chunks: past the size where the CRCs run on several
    threads; a flipped byte in chunk ``corrupt`` ends the valid prefix
    there in both packages."""
    rng = np.random.default_rng(7)
    chunks = [rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes() for _ in range(9)]
    blob = frame_all([memoryview(c) for c in chunks])
    assert blob == b"".join(ref_framing.frame(c) for c in chunks)
    if corrupt is not None:
        flipped = bytearray(blob)
        flipped[corrupt * (8 + (1 << 20)) + 8 + 1234] ^= 0x5A
        blob = bytes(flipped)
    got, want = scan(blob), ref_framing.scan(blob)
    assert got == want and len(got[0]) == (9 if corrupt is None else corrupt)


# -- cross-restore between the packages -----------------------------------------------------


def _stack(side, pair):
    """One package's serve stack: IVF, forward index, result and
    embedding caches, with entries in both caches."""
    ref_enc, enc, keys, _vecs = pair
    c = SIDES[side]
    encoder = ref_enc if side == "ref" else enc
    fwd = c["forward"](encoder, tokens_per_doc=T_DOC, initial_capacity=64)
    fwd.add(keys, [DOCS[k] for k in keys])
    rc = c["result"]()
    rc.put_row("warm q", 3, 5, [(1, 0.5), (2, 0.25)])
    rc.put_row("other q", 4, 5, [(7, 0.125)])
    emb = c["embed"]()
    for i in range(3):
        row = np.arange(32, dtype=np.float32) * (i + 1)
        emb.put_row(b"space\x00row%d" % i, row if side == "ref" else torch.from_numpy(row))
    return {"ivf": _ivf(side, pair), "forward": fwd, "result_cache": rc, "embedding_cache": emb}


def _copy_backend(src, dst):
    for key in src.list_keys(""):
        dst.put(key, src.get(key))


def _serve_rows(side, pair, ivf):
    ref_enc, enc, _keys, _vecs = pair
    if side == "ref":
        return RefServe(ref_enc, ivf, k=5, embed_cache=None)(QUERIES)
    return FusedEncodeSearch(enc, ivf, k=5)(QUERIES)


def _gather(side, pair, fwd):
    ref_enc, enc, keys, _vecs = pair
    encoder = ref_enc if side == "ref" else enc
    qtok, qmask, _n = encoder.encode_token_states(QUERIES[:1])
    done, missing = fwd.gather_submit(qtok, qmask, [keys[:12]], k_out=8)
    scores, perm = done()
    return np.asarray(scores), np.asarray(perm), missing


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_cross_restore_serves_the_writers_rows(pair, writer, reader):
    src = _stack(writer, pair)
    wc, rc_ = SIDES[writer], SIDES[reader]
    w_backend = wc["backend"]()
    assert wc["manager"](w_backend, name="cross", components=src).snapshot() is not None
    r_backend = rc_["backend"]()
    _copy_backend(w_backend, r_backend)
    ref_enc, enc, _keys, _vecs = pair
    dst = {
        "ivf": rc_["ivf"](**IVF),
        "forward": rc_["forward"](ref_enc if reader == "ref" else enc, tokens_per_doc=T_DOC, initial_capacity=64),
        "result_cache": rc_["result"](),
        "embedding_cache": rc_["embed"](),
    }
    report = rc_["manager"](r_backend, name="cross", components=dst).restore()
    assert report.restored and report.reasons == ()
    assert report.sections == {s: "restored" for s in dst}
    assert report.generations == {"ivf": src["ivf"].generation, "forward": src["forward"].generation}
    assert dst["ivf"].generation == src["ivf"].generation and dst["ivf"]._slot_of_key == src["ivf"]._slot_of_key
    for w, g in zip(_serve_rows(writer, pair, src["ivf"]), _serve_rows(reader, pair, dst["ivf"])):
        assert_same_ranking(list(w), list(g))
    w_scores, w_perm, w_missing = _gather(writer, pair, src["forward"])
    r_scores, r_perm, r_missing = _gather(reader, pair, dst["forward"])
    np.testing.assert_array_equal(r_perm, w_perm)
    np.testing.assert_allclose(r_scores, w_scores, atol=1e-4)
    assert r_missing == w_missing
    assert dst["result_cache"].get_rows([("warm q", 3)], 5) == [[(1, 0.5), (2, 0.25)]]
    assert dst["result_cache"].get_rows([("other q", 4)], 5) == [[(7, 0.125)]]
    for i in range(3):
        got = dst["embedding_cache"]._tier.get(b"space\x00row%d" % i)
        np.testing.assert_array_equal(np.asarray(got), np.arange(32, dtype=np.float32) * (i + 1))
    if reader == "port":
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"


def test_port_warm_restore_serves_bit_identically(pair, tmp_path):
    _ref_enc, enc, keys, _vecs = pair
    src = _stack("port", pair)
    src["ivf"].add([9001, 9002], enc.encode(["a fresh tail row", "another tail row"]))  # rows in the tail too
    backend = FileBackend(str(tmp_path / "store"))
    WarmStateManager(backend, name="bit", components=src, chunk_bytes=4096).snapshot()
    dst = {
        "ivf": IvfKnnIndex(device="cpu", **IVF),
        "forward": ForwardIndex(enc, tokens_per_doc=T_DOC, initial_capacity=64),
        "result_cache": ResultCache(),
        "embedding_cache": EmbeddingCache(device="cpu"),
    }
    report = WarmStateManager(FileBackend(str(tmp_path / "store")), name="bit", components=dst).restore()
    assert report.restored
    serve_w, serve_r = FusedEncodeSearch(enc, src["ivf"], k=5), FusedEncodeSearch(enc, dst["ivf"], k=5)
    assert [list(r) for r in serve_w(QUERIES)] == [list(r) for r in serve_r(QUERIES)]
    z = torch.nn.functional.normalize(enc.encode_to_device(QUERIES), dim=1)
    outs = []
    for ivf in (src["ivf"], dst["ivf"]):
        with ivf._lock:
            tail, tail_dev = ivf._tail_snapshot_device()
            outs.append((tail, ivf._search_device(z, 5, ivf.probe_count(), tail_dev, serve=True)))
    assert outs[0][0] == outs[1][0] == [9001, 9002]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    w, r = _gather("port", pair, src["forward"]), _gather("port", pair, dst["forward"])
    assert np.array_equal(w[0], r[0]) and np.array_equal(w[1], r[1])
    assert len(dst["embedding_cache"]) == 3 and len(dst["result_cache"]._tier) == 2


def test_warm_entries_keep_lru_order_and_restart_ttl():
    rc = ResultCache(ttl_s=60.0)
    for i in range(4):
        rc.put_row(f"q{i}", 1, 5, [(i, 1.0)])
    rc.get_rows([("q0", 1)], 5)  # q0 becomes the newest
    entries = rc._tier.warm_entries()
    assert [k[0] for k, _v, _n in entries] == ["q1", "q2", "q3", "q0"]
    again = ResultCache(max_entries=3)
    assert again.load_warm_state(rc.warm_state()) == 4
    assert [k[0] for k, _v, _n in again._tier.warm_entries()] == ["q2", "q3", "q0"]  # q1 evicted first
    with pytest.raises(ValueError):
        again.load_warm_state({"kind": "embedding_cache", "entries": []})


# -- corruption and cadence, held to the reference ---------------------------------------------


def _counts(obs):
    out = {k: obs.counter("pathway_warmstate_restore_failures_total", kind=k).value for k in _KINDS}
    for outcome in ("warm", "cold"):
        out[outcome] = obs.counter("pathway_warmstate_restores_total", outcome=outcome).value
    out["snapshots"] = obs.counter("pathway_warmstate_snapshots_total").value
    out["skipped"] = obs.counter("pathway_warmstate_snapshot_skipped_total").value
    out["degraded"] = obs.counter("pathway_dist_degraded_total", site="broadcast").value
    return out


def _report(r):
    return (r.restored, r.snapshot, r.generations, r.sections, r.reasons)


def _section_key(mgr, section):
    return f"{mgr._snap_prefix(mgr._list_seqs()[-1])}/{section}"


def _scenario(side, name, pair):
    c = SIDES[side]
    make_ivf = lambda n=None: _ivf(side, pair, n)  # noqa: E731
    backend = c["backend"]()
    if name == "crc_fallback":
        writer = make_ivf()
        mgr = c["manager"](backend, name=name, components={"ivf": writer}, keep=4)
        older, newer = mgr.snapshot(), mgr.snapshot()
        key = _section_key(mgr, "ivf")
        blob = bytearray(backend.get(key))
        blob[len(blob) // 2] ^= 0xFF
        backend.put(key, bytes(blob))
        replica = c["ivf"](**IVF)
        report = c["manager"](backend, name=name, components={"ivf": replica}).restore()
        return _report(report), older != newer, replica.generation == writer.generation
    if name == "truncated":
        mgr = c["manager"](backend, name=name, components={"ivf": make_ivf()})
        mgr.snapshot()
        key = _section_key(mgr, "ivf")
        backend.put(key, backend.get(key)[:-7])
        replica = c["ivf"](**IVF)
        return _report(c["manager"](backend, name=name, components={"ivf": replica}).restore()), len(replica)
    if name == "short_chunks":  # a whole chunk lost: the count check catches it
        mgr = c["manager"](backend, name=name, components={"ivf": make_ivf()}, chunk_bytes=4096)
        mgr.snapshot()
        key = _section_key(mgr, "ivf")
        payloads, _ok = ref_framing.scan(backend.get(key))
        backend.put(key, b"".join(ref_framing.frame(p) for p in payloads[:-1]))
        replica = c["ivf"](**IVF)
        return _report(c["manager"](backend, name=name, components={"ivf": replica}).restore()), len(replica)
    if name == "unpickle":
        mgr = c["manager"](backend, name=name, components={"ivf": make_ivf()}, chunk_bytes=1 << 30)
        mgr.snapshot()
        key = _section_key(mgr, "ivf")
        n = len(ref_framing.scan(backend.get(key))[0][0])
        backend.put(key, ref_framing.frame(b"\x80\x05not a pickle".ljust(n, b"\x00")))
        replica = c["ivf"](**IVF)
        return _report(c["manager"](backend, name=name, components={"ivf": replica}).restore()), len(replica)
    if name == "install_mismatch":
        c["manager"](backend, name=name, components={"ivf": make_ivf()}).snapshot()
        wrong = c["ivf"](**{**IVF, "dimension": 16})
        return _report(c["manager"](backend, name=name, components={"ivf": wrong}).restore()), len(wrong)
    if name == "missing_section":
        c["manager"](backend, name=name, components={"ivf": make_ivf()}).snapshot()
        rc = c["result"]()
        report = c["manager"](backend, name=name, components={"ivf": c["ivf"](**IVF), "result_cache": rc}).restore()
        return (_report(report),)
    if name == "missing_manifest":
        mgr = c["manager"](backend, name=name, components={"ivf": make_ivf()})
        prefix = mgr.snapshot()
        backend.delete(f"{prefix}/MANIFEST")
        return (_report(c["manager"](backend, name=name, components={"ivf": c["ivf"](**IVF)}).restore()),)
    if name == "empty_backend":
        return (_report(c["manager"](backend, name=name, components={"ivf": make_ivf(4)}).restore()),)
    if name == "prune":
        mgr = c["manager"](backend, name=name, components={"ivf": make_ivf(4)}, keep=2)
        prefixes = [mgr.snapshot() for _ in range(4)]
        seqs = mgr._list_seqs()
        live = backend.list_keys(mgr._root() + "/")
        return prefixes, seqs, live, mgr.stats
    if name == "manual_interval":
        mgr = c["manager"](backend, name=name, components={"ivf": make_ivf(4)}, interval_s=0)
        first = mgr.maybe_snapshot()
        return first, mgr.snapshot(), mgr.stats
    if name == "cadence":
        mgr = c["manager"](backend, name=name, components={"ivf": make_ivf(4)}, interval_s=3600)
        return mgr.maybe_snapshot(), mgr.maybe_snapshot(), mgr.stats
    if name == "snapshot_fault":
        mgr = c["manager"](backend, name=name, components={"ivf": make_ivf(4)})
        with c["inject"].armed("warmstate.snapshot", "raise", times=1):
            skipped = mgr.snapshot()
        return skipped, mgr.snapshot(), mgr.stats
    if name == "restore_fault":
        c["manager"](backend, name=name, components={"ivf": make_ivf(4)}).snapshot()
        replica = c["ivf"](**IVF)
        with c["inject"].armed("warmstate.restore", "raise", times=1):
            faulted = c["manager"](backend, name=name, components={"ivf": replica}).restore()
        return _report(faulted), len(replica)
    if name == "agreement":
        mgr = c["manager"](backend, name=name)
        return mgr.agree_generation(7, tag="t0"), mgr.agree_generation([3, 4], tag="t1")
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "crc_fallback", "truncated", "short_chunks", "unpickle", "install_mismatch", "missing_section",
    "missing_manifest", "empty_backend", "prune", "manual_interval", "cadence", "snapshot_fault",
    "restore_fault", "agreement",
])
def test_corruption_and_cadence_as_reference(pair, name):
    got = {}
    for side in ("ref", "port"):
        before = _counts(SIDES[side]["obs"])
        out = _scenario(side, name, pair)
        after = _counts(SIDES[side]["obs"])
        got[side] = (out, {k: after[k] - before[k] for k in before})
    assert got["port"] == got["ref"]
    out, deltas = got["port"]
    expect = {
        "crc_fallback": ("crc", 1, True),
        "truncated": ("crc", 1, False),
        "short_chunks": ("truncated", 1, False),
        "unpickle": ("unpickle", 1, False),
        "install_mismatch": ("install", 1, False),
        "missing_section": ("missing", 1, False),
    }
    if name in expect:
        kind, n, restored = expect[name]
        assert deltas[kind] == n and out[0][0] is restored
        assert deltas["warm" if restored else "cold"] == 1
        if not restored:
            assert out[0][4] == ("warm_restore_failed",)
            if len(out) > 1:
                assert out[1] == 0  # nothing installed into the replica
    if name in ("missing_manifest", "empty_backend"):
        assert out[0] == (False, None, {}, {}, ()) and deltas["cold"] == 1 and deltas["manifest"] == 0


def test_restore_report_is_exported():
    r = RestoreReport(False, None, {}, {}, ())
    assert (r.restored, r.snapshot, r.generations, r.sections, r.reasons) == (False, None, {}, {}, ())


def test_broadcast_fault_flags_local_agreement():
    deg = observe.counter("pathway_dist_degraded_total", site="broadcast")
    before = deg.value
    assert dist.is_coordinator() and dist.broadcast_obj(5, name="t") == 5
    mgr = WarmStateManager(MemoryBackend(), name="agree-fault")
    # the local value, as the reference's broadcast_obj (tests/test_robust.py:1691):
    # on the coordinator that is its own generation, so agreement holds
    with inject.armed("dist.broadcast", "raise", times=1):
        assert dist.broadcast_obj(42, name="bc-raise") == 42
    with inject.armed("dist.broadcast", "hang", hang_s=30.0):
        assert mgr.agree_generation(9, tag="t2", deadline=Deadline.after_ms(0.0)) == (9, True)
    assert deg.value == before + 2


def test_file_backend_is_atomic_and_confined(tmp_path):
    b = FileBackend(str(tmp_path))
    b.put("a/b/c", b"one")
    b.put("a/b/c", b"two")
    assert b.get("a/b/c") == b"two" and b.get("missing") is None
    assert b.list_keys("a/") == ["a/b/c"] and not any(p.name.endswith(".tmp") for p in tmp_path.rglob("*"))
    b.delete("a/b/c")
    b.delete("a/b/c")
    assert b.list_keys() == []
    with pytest.raises(ValueError):
        b.put("../escape", b"x")


def test_file_backend_maps_blobs_for_restore(tmp_path):
    """``get_view`` (the restore's read) maps the file: the same bytes as
    ``get``, None for a missing key, empty for an empty blob; the memory
    backend's view is of its bytes."""
    b = FileBackend(str(tmp_path))
    b.put("a/b", b"payload")
    b.put("empty", b"")
    assert bytes(b.get_view("a/b")) == b.get("a/b") == b"payload"
    assert b.get_view("missing") is None and bytes(b.get_view("empty")) == b""
    m = MemoryBackend()
    m.put("k", b"xyz")
    assert bytes(m.get_view("k")) == b"xyz" and m.get_view("nope") is None


def test_view_stream_copies_large_reads_on_threads():
    """A read of at least 8 MB from ``ViewStream`` is copied on several
    threads: the bytes equal the joined views whatever the boundaries,
    and a large array pickled across 1 MB chunks unpickles equal."""
    import io
    import pickle

    from pathway_tpu_torch.persistence.framing import ViewStream

    rng = np.random.default_rng(11)
    blob = rng.integers(0, 256, 12_345_679, dtype=np.uint8).tobytes()
    cuts = [0, 1, 1 << 20, (1 << 20) + 7, 3 << 20, 3 << 20, 9_000_001, len(blob)]
    views = [memoryview(blob)[a:b] for a, b in zip(cuts, cuts[1:])]
    stream = ViewStream(views)
    head = bytearray(9 << 20)
    assert stream.readinto(head) == len(head) and bytes(head) == blob[: len(head)]
    small = bytearray(5)
    assert stream.readinto(small) == 5 and bytes(small) == blob[len(head) : len(head) + 5]
    rest = bytearray(len(blob))
    n = stream.readinto(rest)
    assert n == len(blob) - len(head) - 5 and bytes(rest[:n]) == blob[len(head) + 5 :]
    assert stream.readinto(bytearray(4)) == 0

    state = {"a": rng.standard_normal(3_000_000).astype(np.float32), "rows": {i: np.full(3, i) for i in range(5)}}
    payload = memoryview(pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL))
    chunks = [payload[o : o + (1 << 20)] for o in range(0, len(payload), 1 << 20)]
    got = pickle.load(io.BufferedReader(ViewStream(chunks), 1 << 20))
    assert np.array_equal(got["a"], state["a"]) and all(np.array_equal(got["rows"][i], state["rows"][i]) for i in range(5))


@pytest.mark.parametrize("gc_on", [True, False])
def test_restore_pauses_the_collector_and_puts_it_back(gc_on):
    """The decode and install run with the cyclic collector paused; the
    restore leaves it as it found it."""
    import gc

    class Probe:
        seen = None

        def warm_state(self):
            return {"generation": 1, "rows": list(range(10))}

        def load_warm_state(self, state):
            Probe.seen = gc.isenabled()

    backend = MemoryBackend()
    assert WarmStateManager(backend, name="gc", components={"p": Probe()}).snapshot() is not None
    was = gc.isenabled()
    try:
        gc.enable() if gc_on else gc.disable()
        report = WarmStateManager(backend, name="gc", components={"p": Probe()}).restore()
        assert report.restored and Probe.seen is False and gc.isenabled() is gc_on
    finally:
        gc.enable() if was else gc.disable()
