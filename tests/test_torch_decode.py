"""The port's continuous decode engine (``pathway_tpu_torch/serve/
decode.py``) and solo decode paths on the CPU, held to the reference's
invariants within the port alone: every request decoded through the
engine emits exactly the tokens of a solo ``generate`` at the same seed
(whatever its join order, batch-mates, slot, prefix-cache state or
speculation), a freed slot never leaks its occupant's K/V, every
admitted ticket resolves, and a fault degrades only the request it hits.

Also the port's own hazards, where its in-place tensors differ from the
reference's functional arrays: pad rows of a join never touch a slot, a
captured prefix block is a copy, a trunk draft never writes the pool, a
retried step starts from the state before the failure, and finished
rows are masked rather than skipped without changing a token or a
captured block.  Comparisons are exact (token ids, or tensors bit for
bit) at a tiny f32 model: d 32, 2 layers, max_len 64, vocab 512."""

import threading
import time

import numpy as np
import pytest
import torch

from pathway_tpu_torch import observe
from pathway_tpu_torch.cache import PrefixKVCache
from pathway_tpu_torch.models.generator import (
    TextGenerator,
    decode_draft_layers,
    decode_draft_source,
    decode_kv_quant,
    decode_spec_k,
    decode_step_bucket,
)
from pathway_tpu_torch.ops import dispatch_counter
from pathway_tpu_torch.robust import Deadline, inject
from pathway_tpu_torch.serve import ContinuousDecoder, DecodeResult
from pathway_tpu_torch.serve.decode import decode_slots

PROMPTS = [
    "hello world",
    "the quick brown fox jumps over",
    "alpha beta gamma delta",
    "continuous batching decode engine",
    "one more prompt to decode",
    "short",
    "retrieval augmented generation serving",
    "slot pool join leave",
]
_SHARED = (
    "system prompt answer strictly from the retrieved context "
    "chunk one about dataflow chunk two about serving "
)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.setenv("PATHWAY_RETRY_BASE_MS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    inject.disarm()
    torch.set_num_threads(n)


def make_generator(**kw):
    args = dict(
        dimension=32, n_layers=2, n_heads=4, max_length=64, vocab_size=512, kv_cache=None,
        eos_id=None, dtype=torch.float32, device="cpu",
    )
    args.update(kw)
    return TextGenerator(**args)


@pytest.fixture(scope="module")
def gen():
    return make_generator()


def ids_of(rendered):
    return [int(t.strip("<>")) for t in str(rendered).split()]


def solo(gen, p, **kw):
    return gen.generate([p], **kw)[0]


# -- token identity -----------------------------------------------------------------


def test_staggered_joins_token_identical_to_solo_greedy(gen):
    eng = ContinuousDecoder(gen, slots=3, step_bucket=4, name="t-dec-1")
    try:
        tickets = []
        for i, p in enumerate(PROMPTS):
            tickets.append(eng.submit(p, max_new_tokens=4 + (i % 4)))
            if i in (2, 5):
                time.sleep(0.03)
        got = [t() for t in tickets]
    finally:
        eng.stop()
    for i, p in enumerate(PROMPTS):
        assert got[i] == solo(gen, p, max_new_tokens=4 + (i % 4), use_kv=False), (i, p)
        assert not got[i].degraded
    assert eng.pool_stats["finished"] == len(PROMPTS)


def test_sampled_decode_identical_to_solo_across_seeds_and_temps(gen):
    eng = ContinuousDecoder(gen, slots=4, step_bucket=3, name="t-dec-2")
    cases = [(p, 0.7 + 0.1 * (i % 3), i) for i, p in enumerate(PROMPTS)]
    try:
        got = [t() for t in [eng.submit(p, max_new_tokens=6, temperature=t, seed=s) for p, t, s in cases]]
    finally:
        eng.stop()
    for out, (p, t, s) in zip(got, cases):
        assert out == solo(gen, p, max_new_tokens=6, temperature=t, seed=s, use_kv=False)
        assert out == solo(gen, p, max_new_tokens=6, temperature=t, seed=s, use_kv=True)


def test_admission_order_does_not_change_tokens(gen):
    for order in (list(range(6)), [3, 0, 5, 1, 4, 2]):
        eng = ContinuousDecoder(gen, slots=2, step_bucket=4, name="t-dec-3")
        try:
            tickets = {i: eng.submit(PROMPTS[i], max_new_tokens=5, temperature=0.9, seed=i) for i in order}
            got = {i: tickets[i]() for i in order}
        finally:
            eng.stop()
        for i in order:
            assert got[i] == solo(gen, PROMPTS[i], max_new_tokens=5, temperature=0.9, seed=i), (order, i)


def test_concurrent_submitters_all_token_identical(gen):
    eng = ContinuousDecoder(gen, slots=4, step_bucket=4, name="t-dec-4")
    results, errors = {}, []
    barrier = threading.Barrier(4)

    def worker(t):
        try:
            barrier.wait(timeout=10)
            for i in range(t, len(PROMPTS), 4):
                results[i] = eng.submit(PROMPTS[i], max_new_tokens=6, seed=i, temperature=0.5 * (i % 2))()
        except Exception as exc:  # pragma: no cover - reported below
            errors.append(repr(exc))

    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        eng.stop()
    assert not errors, errors
    for i, p in enumerate(PROMPTS):
        assert results[i] == solo(gen, p, max_new_tokens=6, seed=i, temperature=0.5 * (i % 2))


@pytest.mark.parametrize("spec_k", [3, 4])
def test_spec_token_identity_matrix_greedy_and_sampled(gen, spec_k):
    cases = [(p, 0.0 if i % 2 == 0 else 0.7 + 0.1 * (i % 3), i) for i, p in enumerate(PROMPTS)]
    eng = ContinuousDecoder(gen, slots=3, step_bucket=4, name=f"t-spec{spec_k}", spec_k=spec_k)
    try:
        tickets = []
        for i, (p, t, s) in enumerate(cases):
            tickets.append(eng.submit(p, max_new_tokens=8, temperature=t, seed=s))
            if i in (2, 5):
                time.sleep(0.02)
        got = [t() for t in tickets]
    finally:
        eng.stop()
    for out, (p, t, s) in zip(got, cases):
        assert out == solo(gen, p, max_new_tokens=8, temperature=t, seed=s, use_kv=False)
    assert eng.pool_stats["spec_rounds"] > 0 and eng.pool_stats["spec_fallbacks"] == 0


# -- slot reuse ------------------------------------------------------------------------


@pytest.mark.parametrize("spec_k", [0, 4])
def test_slot_reuse_after_eos_never_aliases_prior_kv(gen, spec_k):
    eos = ids_of(solo(gen, "hello world", max_new_tokens=10))[1]
    eng = ContinuousDecoder(gen, slots=1, step_bucket=4, name="t-dec-5", spec_k=spec_k)
    seq = ["hello world", "the quick brown fox jumps over", "short", "hello world"]
    try:
        outs = [eng.submit(p, max_new_tokens=10, eos_id=eos)() for p in seq]
    finally:
        eng.stop()
    for out, p in zip(outs, seq):
        assert out == solo(gen, p, max_new_tokens=10, use_kv=False, eos_id=eos), p
    assert eng.pool_stats["finished"] == len(seq)


def test_queued_request_takes_slot_freed_by_eos_leave(gen):
    eos = ids_of(solo(gen, "hello world", max_new_tokens=12))[1]
    eng = ContinuousDecoder(gen, slots=1, step_bucket=2, name="t-dec-6")
    try:
        t_short = eng.submit("hello world", max_new_tokens=12, eos_id=eos)
        t_long = eng.submit("the quick brown fox jumps over", max_new_tokens=6)
        short, long_ = t_short(), t_long()
    finally:
        eng.stop()
    assert short == solo(gen, "hello world", max_new_tokens=12, eos_id=eos)
    assert long_ == solo(gen, "the quick brown fox jumps over", max_new_tokens=6)
    assert eng.pool_stats["steps"] < 12 + 6  # the EOS leave freed the slot mid-budget


def test_eos_inside_verify_chunk_frees_slot_and_accounting_matches(gen):
    eos = ids_of(solo(gen, "hello world", max_new_tokens=12))[2]
    counts = {}
    for spec_k in (0, 4):
        eng = ContinuousDecoder(gen, slots=1, step_bucket=2, name=f"t-eosv{spec_k}", spec_k=spec_k)
        try:
            t_short = eng.submit("hello world", max_new_tokens=12, eos_id=eos)
            t_long = eng.submit("the quick brown fox jumps over", max_new_tokens=6)
            short, long_ = t_short(), t_long()
        finally:
            eng.stop()
        assert short == solo(gen, "hello world", max_new_tokens=12, eos_id=eos)
        assert long_ == solo(gen, "the quick brown fox jumps over", max_new_tokens=6)
        assert eng.pool_stats["finished"] == 2
        counts[spec_k] = eng.pool_stats["tokens_decode"]
        if spec_k:
            assert eng.pool_stats["spec_rounds"] > 0
    assert counts[0] == counts[4]


# -- prefix cache ------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant,spec_k", [("bf16", 0), ("bf16", 3), ("int8", 0)])
def test_prefix_warm_join_bit_identical_to_cold(kv_quant, spec_k):
    kv = PrefixKVCache(block=8)
    g = make_generator(max_length=96, kv_cache=kv)
    p1, p2 = _SHARED + "what is incremental computation", _SHARED + "how does the scheduler coalesce"
    eng = ContinuousDecoder(g, slots=2, step_bucket=4, name="t-warm", kv_quant=kv_quant, spec_k=spec_k)
    try:
        cold = eng.submit(p2, max_new_tokens=5)()
        kv.clear()
        kv.stats_tokens.update(reused=0, computed=0)
        eng.submit(p1, max_new_tokens=5)()
        assert kv.stats_tokens["reused"] == 0
        warm = eng.submit(p2, max_new_tokens=5)()
    finally:
        eng.stop()
    assert str(warm) == str(cold) and kv.stats_tokens["reused"] > 0
    if kv_quant == "bf16":
        assert warm == solo(g, p2, max_new_tokens=5, use_kv=False)


def test_prefix_capture_is_a_copy_later_writes_never_reach_it():
    """The pool is written in place: a captured block must be a copy, or
    the next request in the same slot would rewrite the cached K/V."""
    kv = PrefixKVCache(block=8)
    g = make_generator(max_length=96, kv_cache=kv)
    p1 = _SHARED + "what is incremental computation"
    eng = ContinuousDecoder(g, slots=1, step_bucket=4, name="t-capture")
    try:
        eng.submit(p1, max_new_tokens=4)()
        ids, mask = g.tokenizer.encode_batch([p1], max_length=92)
        _, blocks, _ = kv.match(ids[0], int(mask.sum()))
        assert blocks
        snap = [(k.clone(), v.clone()) for k, v in blocks]
        for p in PROMPTS[:3]:  # overwrite slot 0 again and again
            eng.submit(p, max_new_tokens=8)()
    finally:
        eng.stop()
    for (k, v), (k0, v0) in zip(blocks, snap):
        assert torch.equal(k, k0) and torch.equal(v, v0)
        assert k.data_ptr() != eng._pk.data_ptr()


def test_finished_rows_are_masked_tokens_and_captured_blocks_unchanged():
    """Rows that finished keep computing (masked, no device predicate):
    the tokens and the prompt blocks the cache captures equal those of
    the same batch decoded without an EOS, cut at the EOS."""
    runs = {}
    for eos in (None, "set"):
        kv = PrefixKVCache(block=8)
        g = make_generator(max_length=96, kv_cache=kv)
        prompts = [_SHARED + "what is incremental computation", _SHARED + "a second question here"]
        if eos == "set":
            eos = ids_of(runs[None][0][0])[1]
        out = g.generate(prompts, max_new_tokens=10, eos_id=eos)
        ids, mask = g.tokenizer.encode_batch(prompts[:1], max_length=86)
        _, blocks, _ = kv.match(ids[0], int(mask.sum()))
        runs[eos] = (out, blocks, eos)
    base, base_blocks, _ = runs[None]
    (cut, cut_blocks, eos) = [v for k, v in runs.items() if k is not None][0]
    for full, got in zip(base, cut):
        toks = ids_of(full)
        want = toks[: toks.index(eos) + 1] if eos in toks else toks
        assert ids_of(got) == want
    assert len(cut_blocks) == len(base_blocks) > 0
    for (k0, v0), (k1, v1) in zip(base_blocks, cut_blocks):
        assert torch.equal(k0, k1) and torch.equal(v0, v1)


# -- the port's in-place hazards -----------------------------------------------------------


def test_pad_rows_of_a_join_never_touch_a_slot(gen):
    S, T = 4, 32
    cfg = gen.config
    pool_k = torch.randn(S, cfg.n_layers, T, 4, 8)
    pool_v = torch.randn(S, cfg.n_layers, T, 4, 8)
    before_k, before_v = pool_k.clone(), pool_v.clone()
    fn = gen._slot_prefill_fn(S, T, 4, 16, 0)  # a join batch of 4 with 2 real rows
    ids, mask = gen.tokenizer.encode_batch(PROMPTS[:2], max_length=16, pad_to=16)
    suffix = torch.zeros(4, 16, dtype=torch.int64)
    suffix[:2] = torch.from_numpy(ids.astype(np.int64))
    n_len = torch.tensor([int(mask[0].sum()), int(mask[1].sum()), 0, 0])
    toks, _ = fn(pool_k, pool_v, torch.tensor([2, 0]), suffix, n_len, None, None,
                 torch.zeros(4, 2, dtype=torch.int64), torch.zeros(4), True)
    for s in (1, 3):  # not joined: bit for bit as before
        assert torch.equal(pool_k[s], before_k[s]) and torch.equal(pool_v[s], before_v[s])
    assert not torch.equal(pool_k[2], before_k[2])
    # the joined rows' first tokens are the solo decode's
    for j, p in enumerate(PROMPTS[:2]):
        assert int(toks[j]) == ids_of(solo(gen, p, max_new_tokens=1))[0]


def test_trunk_draft_never_writes_the_pool(gen):
    S, T = 3, 32
    cfg = gen.config
    pool_k = torch.randn(S, cfg.n_layers, T, 4, 8)
    pool_v = torch.randn(S, cfg.n_layers, T, 4, 8)
    before_k, before_v = pool_k.clone(), pool_v.clone()
    fn = gen._slot_draft_fn(S, T, 4, 1)
    drafts = fn(pool_k, pool_v, torch.tensor([5, 6, 7]), torch.tensor([3, 9, 0]), torch.tensor([True, True, False]))
    assert drafts.shape == (S, 4)
    assert torch.equal(pool_k, before_k) and torch.equal(pool_v, before_v)


def test_step_fault_retries_from_the_state_before_the_failure(gen):
    """A step chunk that fails once is retried: sampled tokens equal the
    solo ones, so the keys and host state moved only after success."""
    eng = ContinuousDecoder(gen, slots=2, step_bucket=3, name="t-retry")
    try:
        inject.arm("generator.step", times=1)
        outs = [eng.submit(p, max_new_tokens=7, temperature=0.8, seed=i) for i, p in enumerate(PROMPTS[:2])]
        outs = [t() for t in outs]
        assert inject.fired_count("generator.step") == 1
    finally:
        eng.stop()
    for i, (out, p) in enumerate(zip(outs, PROMPTS[:2])):
        assert out == solo(gen, p, max_new_tokens=7, temperature=0.8, seed=i) and not out.degraded


def test_generator_dispatch_fault_retries_to_the_same_tokens(gen):
    want = gen.generate(PROMPTS[:3], max_new_tokens=6, temperature=0.7, seed=5)
    for use_kv in (True, False):
        with inject.armed("generator.dispatch", times=1):
            assert gen.generate(PROMPTS[:3], max_new_tokens=6, temperature=0.7, seed=5, use_kv=use_kv) == want


# -- faults degrade only the affected request -------------------------------------------------


def test_prefill_fault_degrades_only_the_joining_request(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=4, name="t-prefill-fault")
    try:
        with inject.armed("generator.prefill", times=3):  # the whole retry budget
            bad = eng.submit("hello world", max_new_tokens=4)()
        good = eng.submit("alpha beta gamma delta", max_new_tokens=4)()
    finally:
        eng.stop()
    assert bad == "" and bad.degraded == ("extractive_answer",)
    assert good == solo(gen, "alpha beta gamma delta", max_new_tokens=4) and not good.degraded
    assert eng.pool_stats["evicted"] == 1 and len(eng._free) == 2


def test_step_fault_evicts_in_flight_with_their_tokens_so_far(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=2, name="t-step-fault")
    try:
        with inject.armed("generator.step", times=3):
            bad = eng.submit("hello world", max_new_tokens=8)()
        good = eng.submit("hello world", max_new_tokens=8)()
    finally:
        eng.stop()
    full = solo(gen, "hello world", max_new_tokens=8)
    assert bad.degraded and bad.meta["partial"] and ids_of(full)[: len(ids_of(bad))] == ids_of(bad)
    assert good == full and not good.degraded


def test_verify_fault_falls_back_to_the_plain_chunk_token_identical(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=2, name="t-verify-fault", spec_k=3)
    try:
        with inject.armed("generator.verify", times=3):
            outs = [t() for t in [eng.submit(p, max_new_tokens=6, seed=i) for i, p in enumerate(PROMPTS[:2])]]
    finally:
        eng.stop()
    assert eng.pool_stats["spec_fallbacks"] >= 1
    for i, (out, p) in enumerate(zip(outs, PROMPTS[:2])):
        assert out == solo(gen, p, max_new_tokens=6, seed=i) and not out.degraded


def test_slot_free_fault_quarantines_and_exhaustion_serves_solo(gen):
    eng = ContinuousDecoder(gen, slots=1, step_bucket=4, name="t-quarantine")
    try:
        with inject.armed("generator.slot_free", times=1):
            first = eng.submit("hello world", max_new_tokens=4)()
        assert eng.pool_stats["quarantined"] == 1 and eng._free == []
        # no slot left: the queue serves solo, token-identical
        rest = [t() for t in [eng.submit(p, max_new_tokens=4) for p in PROMPTS[1:4]]]
    finally:
        eng.stop()
    assert first == solo(gen, "hello world", max_new_tokens=4)
    for p, out in zip(PROMPTS[1:4], rest):
        assert out == solo(gen, p, max_new_tokens=4)
    assert eng.pool_stats["finished"] == 1  # the rest never took a slot


# -- policy: budgets, deadlines, drain, kv_width ---------------------------------------------------


def test_legacy_eos_early_exit_skips_budget_token_identical(monkeypatch):
    monkeypatch.setenv("PATHWAY_DECODE_STEP_BUCKET", "4")
    g = make_generator()
    prompts = ["hello world", "hello world"]
    base = g.generate(prompts, max_new_tokens=16, use_kv=False)
    assert g.last_decode_steps == 16
    toks = ids_of(base[0])
    eos = toks[2]
    out = g.generate(prompts, max_new_tokens=16, use_kv=False, eos_id=eos)
    assert g.last_decode_steps < 16
    assert ids_of(out[0]) == toks[: toks.index(eos) + 1]
    assert g.generate(prompts, max_new_tokens=16, use_kv=True, eos_id=eos) == out


def test_eos_rejects_pad_token(gen):
    with pytest.raises(ValueError):
        gen.generate(["x"], max_new_tokens=4, eos_id=gen.tokenizer.PAD)
    with pytest.raises(ValueError):
        make_generator(eos_id=0)


def test_legacy_chunked_decode_never_overruns_budget(monkeypatch):
    monkeypatch.setenv("PATHWAY_DECODE_STEP_BUCKET", "4")
    g = make_generator()
    base = g.generate(["hello world"], max_new_tokens=10, use_kv=False)[0]
    out = g.generate(["hello world"], max_new_tokens=10, use_kv=False, eos_id=511)
    assert g.last_decode_steps == 10 and out[0] == base


def test_oversized_budget_resolves_degraded_never_hangs(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=4, name="t-oversized")
    try:
        bad = eng.submit("hello", max_new_tokens=gen.config.max_len + 8).result(timeout=30)
        assert bad == "" and bad.degraded
        assert eng.submit("hello world", max_new_tokens=4)() == solo(gen, "hello world", max_new_tokens=4)
    finally:
        eng.stop()


def test_tight_deadline_preempts_to_solo(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=4, name="t-deadline")
    try:
        out = eng.submit("hello world", max_new_tokens=4, deadline=Deadline(0.000001))()
        assert out == solo(gen, "hello world", max_new_tokens=4, use_kv=False)
        assert eng.stats["solo"] >= 1
    finally:
        eng.stop()


def test_stop_drains_every_admitted_ticket(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=4, name="t-drain")
    tickets = [eng.submit(p, max_new_tokens=5, seed=i) for i, p in enumerate(PROMPTS)]
    eng.stop()
    for i, (t, p) in enumerate(zip(tickets, PROMPTS)):
        assert t() == solo(gen, p, max_new_tokens=5, seed=i)
    assert eng.submit("post stop", max_new_tokens=3)() == solo(gen, "post stop", max_new_tokens=3)


def test_request_wider_than_kv_width_serves_solo(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=4, kv_width=24, name="t-width")
    try:
        out = eng.submit(PROMPTS[1], max_new_tokens=12)()  # 16 prompt + 12 > 24
        fits = eng.submit("short", max_new_tokens=4)()
    finally:
        eng.stop()
    assert out == solo(gen, PROMPTS[1], max_new_tokens=12) and not out.degraded
    # only the request that fits took a slot
    assert fits == solo(gen, "short", max_new_tokens=4) and eng.pool_stats["finished"] == 1


# -- counts: dispatches, shapes, bytes -------------------------------------------------------


def test_dispatch_budget_per_chunk_and_per_round(gen):
    for spec_k in (0, 4):
        eng = ContinuousDecoder(gen, slots=2, step_bucket=4, name=f"t-budget{spec_k}", spec_k=spec_k)
        try:
            with dispatch_counter.DispatchCounter() as counter:
                for t in [eng.submit(p, max_new_tokens=9) for p in PROMPTS[:3]]:
                    t()
        finally:
            eng.stop()
        by = {}
        for ev in counter.events:
            by[ev] = by.get(ev, 0) + 1
        st = eng.pool_stats
        plain = st["chunks"] - st["spec_rounds"]
        assert by.get(("dispatch", "decode_step"), 0) == by.get(("fetch", "decode_step"), 0) == plain
        spec = sum(by.get((k, t), 0) for k in ("dispatch",) for t in ("decode_draft", "decode_verify"))
        fetch = sum(by.get((k, t), 0) for k in ("fetch",) for t in ("decode_draft", "decode_verify"))
        assert spec <= 2 * st["spec_rounds"] and fetch <= 2 * st["spec_rounds"]
        assert by.get(("dispatch", "decode_verify"), 0) == st["spec_rounds"]
        assert by.get(("dispatch", "decode_prefill"), 0) == by.get(("fetch", "decode_prefill"), 0) >= 1
        if spec_k:
            assert st["spec_rounds"] > 0


def test_slot_step_census_is_one_shape_per_engine():
    g = make_generator()
    eng = ContinuousDecoder(g, slots=2, step_bucket=4, name="t-census", spec_k=3)
    try:
        for i, p in enumerate(PROMPTS):
            eng.submit(p, max_new_tokens=3 + (i % 3))()
    finally:
        eng.stop()
    kinds = {}
    for k in g._fns:
        kinds.setdefault(k[0], set()).add(k)
    assert len(kinds.get("slot_verify", ())) == 1 and len(kinds.get("slot_draft", ())) <= 1
    assert len(kinds.get("slot_step", ())) <= 1 and len(kinds["slot_prefill"]) <= 8


def test_row_kernel_wrappers_never_fall_back_off_the_cpu():
    """On the CPU the wrappers take the plain versions; any other device
    gets the kernel or an error, never the plain version."""
    from pathway_tpu_torch.ops.decode_rows import layer_norm_rows, tied_readout

    w, b = torch.ones(8), torch.zeros(8)
    x = torch.randn(3, 8)
    assert layer_norm_rows(x, w, b, torch.float32).shape == (3, 8)
    before = (layer_norm_rows.launches, tied_readout.launches)
    with pytest.raises(ValueError):
        layer_norm_rows(x.to("meta"), w.to("meta"), b.to("meta"), torch.float32)
    with pytest.raises(ValueError):
        tied_readout(x.to("meta"), torch.randn(16, 8, device="meta"))
    assert (layer_norm_rows.launches, tied_readout.launches) == before


def test_int8_pool_halves_bytes_and_shows_scales(gen):
    bf = ContinuousDecoder(gen, slots=4, step_bucket=4, name="t-bf-bytes", autostart=False)
    i8 = ContinuousDecoder(gen, slots=8, step_bucket=4, name="t-i8-bytes", autostart=False, kv_quant="int8")
    try:
        c_bf, c_i8 = bf.hbm_components(), i8.hbm_components()
        # f32 model: 8 int8 slots take a quarter of 4 f32 slots' K/V bytes
        assert c_bf["kv_pool"] - bf._rngs.nbytes == 2 * (c_i8["kv_pool"] - i8._rngs.nbytes)
        assert c_i8["kv_scales"] == 2 * 2 * 4 * 8 * 4 and "kv_scales" not in c_bf
        assert i8._pk.dtype == torch.int8
    finally:
        bf.stop()
        i8.stop()


def test_int8_decode_deterministic_and_spec_invariant():
    outs = {}
    for spec_k in (0, 3):
        g = make_generator()
        eng = ContinuousDecoder(g, slots=3, step_bucket=4, name=f"t-i8-{spec_k}", kv_quant="int8", spec_k=spec_k)
        try:
            outs[spec_k] = [str(o) for o in eng.generate(PROMPTS[:6], max_new_tokens=8, seed=1)]
        finally:
            eng.stop()
    assert outs[0] == outs[3]


# -- speculative drafting -------------------------------------------------------------------------


def test_ngram_miner_prefers_longest_suffix_match():
    mine = ContinuousDecoder._mine_ngram
    assert mine([7, 8, 9, 1, 2, 7, 8, 9], 2) == [1, 2]
    assert mine([5, 1, 5, 2, 5], 3) == [2, 5]
    assert mine([1, 2, 3, 4], 2) == []
    assert mine([], 2) == []
    assert len(mine([3, 3, 3, 3, 3, 3], 2)) <= 2


def test_suffix_corpus_drafts_repeat_requests_wholesale(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=4, spec_k=8, name="t-corpus")
    try:
        want = solo(gen, "corpus repeat probe", max_new_tokens=12)
        assert eng._suffix_idx == {}
        cold = eng.submit("corpus repeat probe", max_new_tokens=12)()
        st_cold = dict(eng.pool_stats)
        assert eng._suffix_idx
        warm = eng.submit("corpus repeat probe", max_new_tokens=12)()
        st_warm = eng.pool_stats
    finally:
        eng.stop()
    assert str(cold) == want == str(warm)
    assert st_warm["spec_rounds"] - st_cold["spec_rounds"] < st_cold["spec_rounds"]
    assert st_warm["draft_accepted"] - st_cold["draft_accepted"] >= st_cold["draft_accepted"] + 4


def test_suffix_corpus_first_occurrence_wins_within_stream(gen):
    eng = ContinuousDecoder(gen, slots=1, step_bucket=2, spec_k=4, autostart=False, name="t-corpus2")

    class _St:
        prompt_ids = [7, 9]
        tokens = [5, 5, 5, 3, 5, 8]

    eng._remember(_St())
    assert eng._mine_corpus([1, 9, 5], 4) == [5, 5, 3, 5]
    assert eng._mine_corpus([9, 5, 5], 3) == [5, 3, 5]
    assert eng._mine_corpus([42, 43, 44], 3) == []
    eng.stop()


# -- knobs, results, observability ---------------------------------------------------------------------


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("PATHWAY_DECODE_SLOTS", "5")
    monkeypatch.setenv("PATHWAY_DECODE_STEP_BUCKET", "3")
    monkeypatch.setenv("PATHWAY_DECODE_SPEC_K", "6")
    monkeypatch.setenv("PATHWAY_DECODE_KV_QUANT", "int8")
    monkeypatch.setenv("PATHWAY_DECODE_DRAFT", "ngram")
    monkeypatch.setenv("PATHWAY_DECODE_DRAFT_LAYERS", "1")
    assert decode_slots() == 5 and decode_step_bucket() == 3
    assert decode_spec_k() == 6 and decode_kv_quant() == "int8"
    assert decode_draft_source() == "ngram" and decode_draft_layers(4) == 1
    eng = ContinuousDecoder(make_generator(), name="t-env", autostart=False)
    assert eng.slots == 5 and eng.chunk == 3 and eng.spec_k == 6 and eng.kv_quant == "int8"
    assert eng.draft_source == "ngram" and eng._draft_layers == 1
    eng.stop()
    for name, raw in (("SLOTS", "junk"), ("SPEC_K", "junk"), ("KV_QUANT", "fp4"), ("DRAFT", "oracle"),
                      ("DRAFT_LAYERS", "0")):
        monkeypatch.setenv(f"PATHWAY_DECODE_{name}", raw)
    assert decode_slots() == 8 and decode_spec_k() == 0 and decode_kv_quant() == "bf16"
    assert decode_draft_source() == "auto" and decode_draft_layers(4) == 2 and decode_draft_layers(1) == 1


def test_decode_result_is_a_str_with_flags():
    r = DecodeResult("<1> <2>", degraded=("extractive_answer",) * 2, meta={"tokens": 2})
    assert r == "<1> <2>" and isinstance(r, str)
    assert r.degraded == ("extractive_answer",)
    assert r.meta["degraded_reasons"] == ["extractive_answer"]
    assert not r.ok and DecodeResult("x").ok


def test_generator_metrics_on_the_port_recorder(gen):
    eng = ContinuousDecoder(gen, slots=2, step_bucket=4, name="t-obs", spec_k=4)
    kv = PrefixKVCache(block=8)
    kv.note_prefill(reused=3, computed=5)
    try:
        for p in PROMPTS[:4]:
            eng.submit(p, max_new_tokens=6)()
        text = "\n".join(observe.render_prometheus())
    finally:
        eng.stop()
    for needle in (
        'pathway_generator_slots{generator="t-obs"} 2',
        'pathway_generator_tokens_total{generator="t-obs",phase="decode"}',
        'pathway_generator_tokens_total{generator="t-obs",phase="prefill"}',
        'pathway_generator_requests_total{generator="t-obs",outcome="finished"} 4',
        'pathway_generator_draft_acceptance_rate{generator="t-obs"}',
        'pathway_generator_draft_source_total{generator="t-obs",source="ngram"}',
        "pathway_generator_queue_wait_seconds_bucket",
        'pathway_generator_phase_seconds_bucket{phase="prefill"',
        "pathway_generator_ttlt_seconds_bucket",
        "pathway_generator_draft_accepted_tokens_bucket",
        'kind="reused",tier="generator_kv"} 3',
    ):
        assert needle in text, needle


def test_decode_traces_link_rider_to_step_batches(gen, monkeypatch):
    from pathway_tpu_torch.observe import trace

    created = []
    orig = trace.start_trace

    def capture(*a, **k):
        ctx = orig(*a, **k)
        if ctx is not None:
            created.append(ctx)
        return ctx

    monkeypatch.setattr(trace, "start_trace", capture)
    eng = ContinuousDecoder(gen, slots=2, step_bucket=4, name="t-trace")
    try:
        out = eng.submit("hello world", max_new_tokens=6)()
    finally:
        eng.stop()
    assert out and not out.degraded
    reqs = [c for c in created if c.name == "generate.request"]
    batches = [c for c in created if c.name == "decode.batch"]
    assert reqs and batches
    names = [s[2] for s in reqs[0].spans]
    assert "decode.prefill" in names and "decode.step" in names and "decode" in names
    assert reqs[0].links and set(reqs[0].links) <= {b.trace_id for b in batches}
