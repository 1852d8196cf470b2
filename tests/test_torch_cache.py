"""The port's serve cache tiers (``pathway_tpu_torch/cache/``) against
the reference's: the same put/get/TTL/budget sequence gives the same
hits, misses and eviction order in a bare ``CacheTier``, the result tier
and the embedding tier (torch ``[d]`` rows charged the bytes of the
reference's ``[d]`` rows); the key functions agree; fault sites degrade
to a miss or a dropped entry."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.cache import CacheTier as RefTier
from pathway_tpu.cache import EmbeddingCache as RefEmbeddingCache
from pathway_tpu.cache import ResultCache as RefResultCache
from pathway_tpu.cache import keys as ref_keys
from pathway_tpu_torch.cache import CacheTier, EmbeddingCache, ResultCache, keys, live_tiers
from pathway_tpu_torch.robust import inject

_STATS = ("hits", "misses", "insertions", "evictions", "expirations", "corrupt", "failures")


def _ops(seed=0, n=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        key = f"k{int(rng.integers(0, 24))}"
        if r < 0.45:
            out.append(("put", key, int(rng.integers(16, 400))))
        elif r < 0.9:
            out.append(("get", key, 0))
        elif r < 0.95:
            out.append(("tick", "", float(rng.integers(1, 6))))
        else:
            out.append(("discard", key, 0))
    return out


def _run_tier(tier, ops, now):
    trail = []
    for op, key, arg in ops:
        if op == "put":
            trail.append(tier.put(key, f"v-{key}-{arg}", nbytes=arg))
        elif op == "get":
            trail.append(tier.get(key))
        elif op == "tick":
            now[0] += arg
        else:
            tier.discard(key)
        trail.append((list(tier._entries), tier.bytes))
    return trail, {s: tier.stats[s] for s in _STATS}


@pytest.mark.parametrize("seed,budget,ttl,max_entries", [(0, 2000, None, None), (1, 900, 7.0, None), (2, 5000, 3.0, 9)])
def test_tier_sequence_matches_reference(seed, budget, ttl, max_entries, monkeypatch):
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    ops = _ops(seed)
    want = _run_tier(RefTier("result", budget, ttl_s=ttl, max_entries=max_entries), ops, now)
    now[0] = 100.0
    got = _run_tier(CacheTier("result", budget, ttl_s=ttl, max_entries=max_entries), ops, now)
    assert got == want
    assert got[1]["evictions"] > 0 and got[1]["hits"] > 0


def test_result_tier_matches_reference(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    rng = np.random.default_rng(4)
    trails = []
    for cls in (RefResultCache, ResultCache):
        now[0] = 0.0
        cache = cls(max_bytes=2_000, ttl_s=30.0)
        trail = []
        for step in range(120):
            text, gen, k = f"q{int(rng.integers(0, 10))}", int(rng.integers(0, 3)), int(rng.choice([5, 10]))
            if step % 3 == 0:
                row = [(int(x), float(s)) for x, s in zip(rng.integers(0, 1 << 40, 6), rng.random(6))]
                trail.append(cache.put_row(text, gen, k, row))
            else:
                trail.append(cache.get_rows([(text, gen), ("q0", 0)], k))
            if step % 40 == 39:
                now[0] += 31.0  # past the TTL
            trail.append(list(cache._tier._entries))
        trails.append((trail, dict(cache.stats)))
        rng = np.random.default_rng(4)
    assert trails[0] == trails[1]
    # a row mutated in place fails its fingerprint: a miss, never a wrong row
    cache = ResultCache(max_bytes=10_000)
    cache.put_row("q", 1, 5, [(1, 0.5)])
    cache._tier._entries[("q", 1, 5)].value[0] = (2, 0.5)
    assert cache.get_rows([("q", 1)], 5) is None and cache.stats["corrupt"] == 1


def test_embedding_tier_charges_and_evicts_like_reference():
    d = 32
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 500, size=(12, 10)).astype(np.int32)
    mask = (np.arange(10)[None, :] < rng.integers(3, 11, size=(12, 1))).astype(np.int32)
    ids = ids * mask
    rows = rng.normal(size=(12, d)).astype(np.float32)
    trails = []
    for cls, make in ((RefEmbeddingCache, jnp.asarray), (EmbeddingCache, torch.from_numpy)):
        cache = cls(max_bytes=5 * d * 4)  # five rows
        trail = []
        for batch in ((0, 1, 2, 3), (2, 3, 4, 5, 6), (0, 7, 8), (3, 9, 10, 11, 0)):
            b = np.asarray(batch)
            got, misses, row_keys = cache.lookup_rows(ids[b], mask[b], len(b), space="serve:cos")
            for j in misses:
                cache.put_row(row_keys[j], make(rows[b[j]].copy()))
            trail.append((misses, [k for k in cache._tier._entries], cache._tier.bytes))
        trails.append((trail, dict(cache.stats)))
    assert trails[0] == trails[1]
    # a hit returns the stored row; the pad tail does not change the key
    cache = EmbeddingCache(max_bytes=1 << 20)
    key = cache.row_key(ids[0], mask[0], "serve:cos")
    wide_ids = np.concatenate([ids[0], np.zeros(6, np.int32)])
    wide_mask = np.concatenate([mask[0], np.zeros(6, np.int32)])
    assert key == cache.row_key(wide_ids, wide_mask, "serve:cos") != cache.row_key(ids[0], mask[0], "plain")
    row = torch.arange(d, dtype=torch.float32)
    assert cache.put_row(key, row) and cache._tier.bytes == d * 4
    got, misses, _ = cache.lookup_rows(wide_ids[None], wide_mask[None], 1, space="serve:cos")
    assert misses == [] and got[0] is row


def test_keys_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        ids = rng.integers(0, 4096, size=16).astype(np.int32)
        mask = (np.arange(16) < rng.integers(1, 17)).astype(np.int32)
        assert keys.token_ids_key(ids, mask) == ref_keys.token_ids_key(ids, mask)
    for gen in (0, 7, [1, 2], (3, 4, 5)):
        assert keys.query_key("q", gen) == ref_keys.query_key("q", gen)
        assert keys.result_key("q", gen, 9) == ref_keys.result_key("q", gen, 9)


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_fault_sites_degrade_to_miss_and_drop(mode):
    from pathway_tpu_torch.robust import Deadline

    tier = CacheTier("result", 10_000)
    assert tier.put("a", "v")
    with inject.armed("cache.get", mode, hang_s=5.0):
        assert tier.get("a", deadline=Deadline(0.05)) is None
    with inject.armed("cache.put", mode, hang_s=5.0):
        assert not tier.put("b", "v", deadline=Deadline(0.05))
    assert tier.get("a") == "v" and "b" not in tier
    assert tier.stats["failures"] == 2


def test_live_tiers_and_disabled_budget():
    tier = CacheTier("embedding", 0)
    assert tier in live_tiers()
    assert not tier.put("a", "v") and len(tier) == 0
    assert not CacheTier("result", 10).put("big", "v", nbytes=11)
