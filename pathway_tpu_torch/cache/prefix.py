"""Tier 2: generator prefix/KV reuse (counterpart of
``pathway_tpu/cache/prefix.py``).

Under causal attention a token's K/V depends only on the tokens at or
before it, so the K/V of a shared prompt prefix is a function of its
token ids and can be computed once.  Prompt ids are cut into blocks of
``cache.kv_block`` tokens; each block's K and V ``[n_layers, block, H,
hd]`` (tensors on the generator's device, never fetched) are stored
under the hash chain of ``cache/keys.py``, so no entry can be reused
under another prefix.  Lookup walks the chain to the first miss; the
generator prefills only the rest.

Only full blocks of real tokens are cached, and at least one real token
is always left for the prefill (the first decode logits come from the
last prompt position's hidden state, which a block does not carry).
The tier is the port's ``CacheTier("generator_kv")``; reused and
computed prefill tokens render as ``pathway_cache_prefill_tokens_total``
on the port's recorder.  The tier's bytes are on the device-memory
ledger (``prefill_blocks``, with the budget as the capacity resource
``prefill_cache_bytes``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from .. import config, observe
from ..observe import hbm
from .keys import block_chain_keys
from .store import CacheTier, cache_enabled

__all__ = ["PrefixKVCache", "prefix_kv_cache_from_env"]


class PrefixKVCache:
    def __init__(
        self,
        block: Optional[int] = None,
        max_bytes: Optional[int] = None,
        ttl_s: Optional[float] = None,
    ):
        if block is None:
            block = config.get("cache.kv_block")
        if max_bytes is None:
            max_bytes = config.get("cache.kv_bytes")
        if ttl_s is None:
            ttl = config.get("cache.kv_ttl_s")
            ttl_s = ttl if ttl > 0 else None
        self.block = max(1, int(block))
        self._tier = CacheTier("generator_kv", max_bytes=max_bytes, ttl_s=ttl_s)
        # prompt tokens served from cached K/V vs tokens the prefill ran
        self.stats_tokens = {"reused": 0, "computed": 0}
        observe.register_provider(self)
        # the blocks are device tensors: the tier's bytes are device bytes
        hbm.track("cache", self, lambda c: {"prefill_blocks": c._tier.bytes})
        hbm.track_resource("prefill_cache_bytes", self, lambda c: c._tier.bytes, lambda c: c._tier.max_bytes)

    @property
    def stats(self):
        return self._tier.stats

    def __len__(self) -> int:
        return len(self._tier)

    def clear(self) -> None:
        self._tier.clear()

    def cacheable_blocks(self, n_real: int) -> int:
        """Full real blocks of a prompt of ``n_real`` tokens, one fewer
        when the prompt ends on a block boundary."""
        n_blocks = n_real // self.block
        if n_blocks and n_blocks * self.block == n_real:
            n_blocks -= 1
        return n_blocks

    def bucket_tokens(self, n_matched: int) -> int:
        """A matched token count rounded down to a power-of-two block
        multiple: the prefix split is a shape of every decode path, and
        this keeps it to O(log) values."""
        bucket = 0
        step = self.block
        while step <= int(n_matched):
            bucket = step
            step *= 2
        return bucket

    def match(self, ids_row: np.ndarray, n_real: int, deadline=None) -> Tuple[int, List[Any], List[bytes]]:
        """``(n_tokens, blocks, keys)``: the matched token count (a block
        multiple), the cached block values in order, and the chain keys
        of every cacheable block (the capture stores the tail under
        them)."""
        keys = block_chain_keys(ids_row, self.cacheable_blocks(int(n_real)), self.block)
        blocks: List[Any] = []
        for key in keys:
            value = self._tier.get(key, deadline=deadline)
            if value is None:
                break
            blocks.append(value)
        return len(blocks) * self.block, blocks, keys

    def admit(self, keys: List[bytes], n_matched_blocks: int, get_block: Callable[[int], Any], deadline=None) -> int:
        """Store the blocks past the matched prefix; ``get_block(j)``
        returns block j's ``(k, v)``.  Returns how many were admitted."""
        admitted = 0
        for j in range(n_matched_blocks, len(keys)):
            try:
                value = get_block(j)
            except Exception:  # noqa: BLE001 - a failed capture is a miss later
                self._tier._count("failures")
                break
            nbytes = sum(int(getattr(part, "nbytes", 64)) for part in value)
            if self._tier.put(keys[j], value, nbytes=nbytes, deadline=deadline):
                admitted += 1
        return admitted

    def note_prefill(self, reused: int, computed: int) -> None:
        self.stats_tokens["reused"] += int(reused)
        self.stats_tokens["computed"] += int(computed)

    def observe_metrics(self):
        for kind, value in self.stats_tokens.items():
            yield ("counter", "pathway_cache_prefill_tokens_total", {**self._tier.labels, "kind": kind}, value)


def prefix_kv_cache_from_env() -> Optional[PrefixKVCache]:
    """The generator's default tier: on unless ``PATHWAY_CACHE=0`` or
    ``PATHWAY_CACHE_KV=0``."""
    if not cache_enabled() or not config.get("cache.kv"):
        return None
    return PrefixKVCache()
