"""TextGenerator — the causal LM of the RAG path (counterpart of
``pathway_tpu/models/generator.py``): the solo decode paths and the four
slot-pool programs of the continuous engine (``serve/decode.py``).

- ``generate(..., use_kv=True)`` (the default, ``generator.kv``): one
  prefill of the prompt suffix (the leading blocks come from the prefix
  cache when it holds them) into ``[B, L, T, H, hd]`` buffers with
  ``T = P + L_sfx + steps``, then single-token steps against them;
- ``generate(..., use_kv=False)``: the legacy full re-attend, the parity
  oracle, in ``decode.step_bucket`` chunks when an EOS is set, so the
  call returns once every row has finished.

Both go through ``retry_call("generator.dispatch")``, sample with the
reference's threefry chains (``models/prng.py``: one split per emitted
token, so a lane's tokens never depend on its batch-mates), read the
weight-tied logits ``h.float() @ tok_embed.float().T`` through
``ops/decode_rows.tied_readout``, and mask finished rows to PAD instead
of skipping work on a device predicate: the greedy gate is decided on
the host from the temperatures, and a call fetches its tokens once (the
legacy path once per chunk).

The slot programs (``_slot_prefill_fn``, ``_slot_step_fn``,
``_slot_verify_fn``, ``_slot_draft_fn``) are plain functions on tensors
that write the pool in place.  Each records the reference's shape key in
``_fns`` (a census of the shapes the engine used, not a compile cache),
so the bucketing contract can be tested.  The trunk draft rolls forward
on a copy of the pool's first ``D`` layers: the real pool is never
written by a draft.

Weights: the port's seeded init from ``seed`` (the distributions of the
Flax init, not its numbers), or the reference's tree through
``params=`` (``generator_params_from_flax``).  Checkpoints and the HBM
ledger are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import config, observe
from ..device import DEFAULT_DTYPE, resolve_device, to_host, upload
from ..ops import dispatch_counter
from ..ops.decode_rows import tied_readout
from ..robust import retry_call
from . import prng
from .encoder import _bucket
from .params import generator_params_from_flax, init_encoder_
from .tokenizer import HashTokenizer
from .transformer import TransformerConfig, TransformerEncoder, kv_forward, resolve_heads

__all__ = [
    "TextGenerator",
    "decode_draft_layers",
    "decode_draft_source",
    "decode_kv_quant",
    "decode_spec_k",
    "decode_step_bucket",
    "eos_id_from_env",
]

_H_READY = observe.histogram("pathway_serve_model_seconds", model="generator")
_UNSET = object()


def decode_step_bucket() -> int:
    """Decode steps one chunk advances (``decode.step_bucket``), shared
    by the legacy EOS-chunked decode and the continuous engine."""
    return config.get("decode.step_bucket")


def decode_spec_k() -> int:
    """Speculation depth (``decode.spec_k``, 0 = off): positions one
    verify scores per slot, 1 committed + up to ``k - 1`` drafted."""
    return config.get("decode.spec_k")


def decode_kv_quant() -> str:
    """Slot-pool K/V storage (``decode.kv_quant``): ``bf16`` or ``int8``."""
    return config.get("decode.kv_quant")


def decode_draft_source() -> str:
    """Draft source (``decode.draft``): ``auto`` (n-grams, then the
    reduced-layer trunk), ``ngram`` or ``trunk``."""
    return config.get("decode.draft")


def decode_draft_layers(n_layers: int) -> int:
    """Draft-trunk depth (``decode.draft_layers``; 0 = half the trunk,
    at least 1, at most ``n_layers``)."""
    d = config.get("decode.draft_layers")
    if d <= 0:
        d = max(1, n_layers // 2)
    return min(d, n_layers)


def eos_id_from_env() -> Optional[int]:
    """``generator.eos`` as a token id; unset, ``0``, ``none`` or ``off``
    (or not a number) means no EOS handling."""
    raw = config.get("generator.eos").strip()
    if not raw or raw in ("0", "none", "off"):
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def _sample_lanes(logits: torch.Tensor, temps: torch.Tensor, keys: torch.Tensor, greedy_only: bool):
    """Per-lane next tokens of ``logits [B, V]``: argmax where the lane's
    temperature is <= 0, else a draw from the lane's own key after one
    split.  ``greedy_only`` (every temperature <= 0, known on the host)
    skips the draw and leaves the keys.  Returns ``(keys', tokens)``."""
    greedy = torch.argmax(logits, dim=-1)
    if greedy_only:
        return keys, greedy
    pairs = prng.split(keys)
    drawn = prng.categorical(pairs[:, 1], logits / torch.clamp(temps, min=1e-4)[:, None])
    return pairs[:, 0], torch.where(temps <= 0.0, greedy, drawn)


class TextGenerator:
    def __init__(
        self,
        model: str = "pathway-mini-lm",
        dimension: int = 256,
        n_layers: int = 4,
        n_heads: int = 4,
        max_length: int = 256,
        vocab_size: int = 32768,
        seed: int = 2,
        dtype: torch.dtype = DEFAULT_DTYPE,
        kv_cache: Any = "env",
        eos_id: Any = "env",
        device=None,
        params: Optional[Mapping[str, Any]] = None,
    ):
        self.device = resolve_device(device)
        self.name = model
        self.config = TransformerConfig(
            vocab_size=vocab_size,
            d_model=dimension,
            n_heads=resolve_heads(dimension, n_heads),
            n_layers=n_layers,
            d_ff=dimension * 4,
            max_len=max_length,
            dtype=dtype,
            pool="none",
            causal=True,
        )
        self.tokenizer = HashTokenizer(vocab_size=vocab_size, max_length=max_length)
        module = TransformerEncoder(self.config)
        if params is None:
            init_encoder_(module, torch.Generator().manual_seed(seed))
        else:
            module.load_state_dict(generator_params_from_flax(params, self.config))
        self.module = module.to(self.device).eval().requires_grad_(False)
        # the weight-tied readout table (f32 parameters)
        self._table = self.module.tok_embed.weight
        if eos_id == "env":
            eos_id = eos_id_from_env()
        if eos_id is not None and int(eos_id) == self.tokenizer.PAD:
            raise ValueError("eos_id must differ from the PAD token id")
        self.eos_id = None if eos_id is None else int(eos_id)
        self.last_decode_steps = 0
        self._lock = threading.Lock()
        # shape census: reference shape key -> times used
        self._fns: Dict[tuple, int] = {}
        self._kv_scales = None
        if kv_cache == "env":
            from ..cache import prefix_kv_cache_from_env

            kv_cache = prefix_kv_cache_from_env()
        self.kv_cache = kv_cache
        self._use_kv = config.get("generator.kv")

    def _census(self, key: tuple) -> None:
        with self._lock:
            self._fns[key] = self._fns.get(key, 0) + 1

    # -- legacy full re-attend decode (parity oracle) -------------------------
    @torch.no_grad()
    def _decode_chunk(self, ids, mask, pos, temperature: float, rng, fin, eos: int, steps: int):
        """``steps`` single-token iterations of the full re-attend over
        ``ids`` / ``mask`` ``[B, L]``; functional (a retry starts from
        the same state): returns ``(tokens [B, steps], ids, mask, pos,
        rng, fin)``.  Finished rows are frozen and emit PAD; the row that
        emits EOS still writes and advances once."""
        B = ids.shape[0]
        rows = torch.arange(B, device=ids.device)
        PAD = self.tokenizer.PAD
        out = []
        for _ in range(steps):
            hidden = self.module(ids, mask, pool="none")
            last = tied_readout(hidden[rows, pos - 1], self._table)
            nxt = torch.argmax(last, dim=-1)
            if temperature > 0.0:
                pair = prng.split(rng)
                rng = pair[0]
                t = torch.full((), max(temperature, 1e-4), dtype=torch.float32, device=ids.device)
                nxt = prng.categorical(pair[1], last / t)
            nxt = torch.where(fin, PAD, nxt)
            ids_w = ids.clone()
            ids_w[rows, pos] = nxt.to(ids.dtype)
            mask_w = mask.clone()
            mask_w[rows, pos] = 1
            keep = fin[:, None]
            ids = torch.where(keep, ids, ids_w)
            mask = torch.where(keep, mask, mask_w)
            pos = torch.where(fin, pos, pos + 1)
            fin = fin | (nxt == eos)
            out.append(nxt)
        return torch.stack(out, dim=1), ids, mask, pos, rng, fin

    # -- KV-cache decode -------------------------------------------------------
    @torch.no_grad()
    def _kv_run(self, B, L_sfx, P, steps, suffix_ids, n_lens, prefix_k, prefix_v, temperature, rng, eos, fin):
        """Prefill + decode of ``steps`` tokens against width
        ``T = P + L_sfx + steps`` buffers: returns ``(tokens [B, steps],
        k_buf, v_buf)``.  Builds its buffers anew, so a retry repeats
        it exactly."""
        cfg = self.config
        dev = self.device
        H = cfg.n_heads
        hd = cfg.d_model // H
        T = P + L_sfx + steps
        kbuf = torch.zeros((B, cfg.n_layers, T, H, hd), dtype=cfg.dtype, device=dev)
        vbuf = torch.zeros_like(kbuf)
        if P:
            kbuf[:, :, :P] = prefix_k.to(cfg.dtype)
            vbuf[:, :, :P] = prefix_v.to(cfg.dtype)
        positions = (P + torch.arange(L_sfx, device=dev))[None, :].expand(B, L_sfx)
        write_pos = torch.full((B,), P, dtype=torch.int64, device=dev)
        hidden, kbuf, vbuf = kv_forward(self.module, suffix_ids, positions, kbuf, vbuf, write_pos, positions)
        rows = torch.arange(B, device=dev)
        last = tied_readout(hidden[rows, torch.clamp(n_lens - 1 - P, min=0)], self._table)
        pos = n_lens
        PAD = self.tokenizer.PAD
        t = torch.full((), max(temperature, 1e-4), dtype=torch.float32, device=dev)
        toks = []
        for s in range(steps):
            nxt = torch.argmax(last, dim=-1)
            if temperature > 0.0:
                pair = prng.split(rng)
                rng = pair[0]
                nxt = prng.categorical(pair[1], last / t)
            nxt = torch.where(fin, PAD, nxt)
            fin_next = fin | (nxt == eos)
            toks.append(nxt)
            if s + 1 < steps:  # the last step's logits would never be read
                h1, kbuf, vbuf = kv_forward(self.module, nxt[:, None], pos[:, None], kbuf, vbuf, pos, pos[:, None])
                last = tied_readout(h1[:, 0], self._table)
            pos = torch.where(fin, pos, pos + 1)
            fin = fin_next
        return torch.stack(toks, dim=1), kbuf, vbuf

    def _cached_prefix(self, ids: np.ndarray, n_lens: np.ndarray, n: int):
        """Per-row longest cached block chain, batched at the row minimum
        and rounded down to a power-of-two block multiple (the split
        point takes O(log) values).  Returns ``(P, matches)``."""
        matches = [self.kv_cache.match(ids[i], int(n_lens[i])) for i in range(n)]
        P = min((m[0] for m in matches), default=0)
        return self.kv_cache.bucket_tokens(P), matches

    def _prefix_rows(self, matches, rows: int, P: int):
        """``[rows, L, P, H, hd]`` K and V of the matched prefixes (zeros
        for rows past ``len(matches)``)."""
        cfg = self.config
        H = cfg.n_heads
        hd = cfg.d_model // H
        n_pblk = P // self.kv_cache.block
        zero = torch.zeros((cfg.n_layers, P, H, hd), dtype=cfg.dtype, device=self.device)
        ks, vs = [], []
        for i in range(rows):
            if i < len(matches):
                blocks = matches[i][1][:n_pblk]
                ks.append(torch.cat([blk[0] for blk in blocks], dim=1).to(cfg.dtype))
                vs.append(torch.cat([blk[1] for blk in blocks], dim=1).to(cfg.dtype))
            else:
                ks.append(zero)
                vs.append(zero)
        return torch.stack(ks), torch.stack(vs)

    def _generate_kv(self, prompts, max_new_tokens, temperature, seed, eos=None) -> List[str]:
        cfg = self.config
        n = len(prompts)
        b = _bucket(n)
        texts = [str(p) for p in prompts] + [""] * (b - n)
        ids, mask = self.tokenizer.encode_batch(texts, max_length=cfg.max_len - max_new_tokens)
        n_lens = mask.sum(axis=1).astype(np.int64)
        P, matches = (0, [])
        if self.kv_cache is not None:
            P, matches = self._cached_prefix(ids, n_lens, n)
        L_sfx = ids.shape[1] - P
        if P:
            prefix_k, prefix_v = self._prefix_rows(matches, b, P)
        else:
            prefix_k = prefix_v = None
        self._census(("kv", b, L_sfx, P, max_new_tokens))
        dev = self.device
        fin0 = np.arange(b) >= n if eos is not None else np.zeros(b, bool)
        t0 = time.perf_counter_ns()
        observe.record_occupancy("generator", n, b)
        dispatch_counter.record_dispatch("generator")
        toks, kbuf, vbuf = retry_call(
            "generator.dispatch",
            self._kv_run,
            b, L_sfx, P, max_new_tokens,
            upload(ids[:, P:].astype(np.int64), dev),
            upload(n_lens, dev),
            prefix_k, prefix_v, float(temperature),
            upload(prng.key(seed), dev),
            -1 if eos is None else int(eos),
            upload(fin0, dev),
        )
        dispatch_counter.record_fetch("generator")
        toks = to_host(toks)()[:n]
        self.last_decode_steps = max_new_tokens
        _H_READY.observe_ns(time.perf_counter_ns() - t0)
        if self.kv_cache is not None:
            # capture the prompt's uncached full blocks: copies, so no later
            # write to the buffers can reach a cached block
            blk = self.kv_cache.block
            for i in range(n):
                matched, _blocks, chain = matches[i]
                self.kv_cache.admit(
                    chain,
                    matched // blk,
                    lambda j, row=i: (
                        kbuf[row, :, j * blk : (j + 1) * blk].clone(),
                        vbuf[row, :, j * blk : (j + 1) * blk].clone(),
                    ),
                )
                self.kv_cache.note_prefill(reused=P, computed=int(n_lens[i]) - P)
        return [self.render_tokens(row) for row in toks]

    def render_tokens(self, row: Sequence[int]) -> str:
        """``<id> <id> ...`` of the non-PAD tokens: the one rendering of
        every decode path, so outputs compare as strings."""
        return " ".join(f"<{int(t)}>" for t in row if int(t) != self.tokenizer.PAD)

    def generate(
        self,
        prompts: Sequence[str],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
        use_kv: Optional[bool] = None,
        eos_id: Any = _UNSET,
    ) -> List[str]:
        """Up to ``max_new_tokens`` per prompt.  ``use_kv`` picks the
        decode path (None = ``generator.kv``); both emit the same tokens.
        ``eos_id`` (default: the instance's) finishes a row when emitted:
        later tokens are PAD, and the legacy path returns as soon as every
        row has finished."""
        if not prompts:
            return []
        eos = self.eos_id if eos_id is _UNSET else eos_id
        if eos is not None and int(eos) == self.tokenizer.PAD:
            raise ValueError("eos_id must differ from the PAD token id")
        if use_kv if use_kv is not None else self._use_kv:
            return self._generate_kv(prompts, max_new_tokens, temperature, seed, eos=eos)
        n = len(prompts)
        b = _bucket(n)
        texts = [str(p) for p in prompts] + [""] * (b - n)
        ids, mask = self.tokenizer.encode_batch(texts, max_length=self.config.max_len - max_new_tokens)
        pad = np.zeros((b, max_new_tokens), np.int32)
        ids_full = np.concatenate([ids, pad], axis=1).astype(np.int64)
        mask_full = np.concatenate([mask, pad], axis=1).astype(np.int64)
        chunk = max_new_tokens if eos is None else min(max_new_tokens, decode_step_bucket())
        dev = self.device
        t0 = time.perf_counter_ns()
        observe.record_occupancy("generator", n, b)
        state = (
            upload(ids_full, dev),
            upload(mask_full, dev),
            upload(mask.sum(axis=1).astype(np.int64), dev),
            upload(prng.key(seed), dev),
            upload(np.arange(b) >= n if eos is not None else np.zeros(b, bool), dev),
        )
        eos_v = -1 if eos is None else int(eos)
        out_chunks: List[np.ndarray] = []
        steps_run = 0
        while steps_run < max_new_tokens:
            # the tail chunk is sized to the remaining budget: never more
            # steps than max_new_tokens
            c = min(chunk, max_new_tokens - steps_run)
            self._census((b, ids_full.shape[1], c))
            ids_d, mask_d, pos_d, rng, fin = state
            dispatch_counter.record_dispatch("generator")
            toks_c, ids_d, mask_d, pos_d, rng, fin = retry_call(
                "generator.dispatch", self._decode_chunk,
                ids_d, mask_d, pos_d, float(temperature), rng, fin, eos_v, c,
            )
            state = (ids_d, mask_d, pos_d, rng, fin)
            # one fetch per chunk: the tokens and the finished mask together
            dispatch_counter.record_fetch("generator")
            host = to_host(torch.cat([toks_c, fin[:, None].long()], dim=1))()
            out_chunks.append(host[:, :c])
            steps_run += c
            if eos is not None and bool(host[:, c].all()):
                break
        self.last_decode_steps = steps_run
        toks = np.concatenate(out_chunks, axis=1)[:n, :max_new_tokens]
        _H_READY.observe_ns(time.perf_counter_ns() - t0)
        return [self.render_tokens(row) for row in toks]

    def __call__(self, prompts: Sequence[str], **kwargs) -> List[str]:
        return self.generate(prompts, **kwargs)

    # -- continuous-decode slot pool (serve/decode.py) --------------------------
    def kv_pool_scales(self):
        """Per-(layer, head, channel) int8 K/V scales ``[L, H, hd]`` of
        this generator's parameters (``ops/kv_quant.py``), computed once."""
        if self._kv_scales is None:
            from ..ops.kv_quant import kv_pool_scales

            scales = kv_pool_scales(self.module.state_dict(), self.config.n_layers, self.config.n_heads)
            with self._lock:
                if self._kv_scales is None:
                    self._kv_scales = scales
        return self._kv_scales

    def _slot_prefill_fn(self, S: int, T: int, B: int, L_sfx: int, P: int, quant: bool = False):
        """JOIN of ``B`` rows (bucketed; pad rows last) into a ``[S, L, T,
        H, hd]`` pool: ``(pool_k, pool_v, slots, suffix_ids [B, L_sfx],
        n_len [B], prefix_k, prefix_v, rngs [B, 2], temps [B],
        greedy_only, k_scales=None, v_scales=None) -> (first_tokens [B],
        rngs')``.  Prefills each row's suffix (cached prefix blocks at
        positions [0, P)) into fresh width-``T`` buffers, samples each
        row's first token from its own chain, and writes the real rows
        over their slots (``slots`` lists only the real rows: pad rows
        are dropped on the host, as the reference's out-of-bounds
        scatter drops them).  int8: the prefix rows are (re)quantized,
        idempotently."""
        self._census(("slot_prefill_q" if quant else "slot_prefill", S, T, B, L_sfx, P))
        cfg = self.config
        H = cfg.n_heads
        hd = cfg.d_model // H

        @torch.no_grad()
        def prefill(pool_k, pool_v, slots, suffix_ids, n_len, prefix_k, prefix_v, rngs, temps, greedy_only,
                    k_scales=None, v_scales=None):
            from ..ops.kv_quant import quantize_kv

            dev = pool_k.device
            kbuf = torch.zeros((B, cfg.n_layers, T, H, hd), dtype=pool_k.dtype, device=dev)
            vbuf = torch.zeros_like(kbuf)
            if P:
                kbuf[:, :, :P] = quantize_kv(prefix_k, k_scales) if quant else prefix_k.to(cfg.dtype)
                vbuf[:, :, :P] = quantize_kv(prefix_v, v_scales) if quant else prefix_v.to(cfg.dtype)
            positions = (P + torch.arange(L_sfx, device=dev))[None, :].expand(B, L_sfx)
            write_pos = torch.full((B,), P, dtype=torch.int64, device=dev)
            hidden, kbuf, vbuf = kv_forward(
                self.module, suffix_ids, positions, kbuf, vbuf, write_pos, positions, k_scales, v_scales
            )
            rows = torch.arange(B, device=dev)
            last0 = tied_readout(hidden[rows, torch.clamp(n_len - 1 - P, min=0)], self._table)
            rngs, toks = _sample_lanes(last0, temps, rngs, greedy_only)
            n_real = slots.shape[0]
            pool_k[slots] = kbuf[:n_real]
            pool_v[slots] = vbuf[:n_real]
            return toks, rngs

        return prefill

    def _slot_step_fn(self, S: int, T: int, chunk: int, quant: bool = False):
        """Decode-step CHUNK over the whole pool: ``(pool_k, pool_v, tok
        [S], pos [S], active [S], left [S], rngs [S, 2], temps [S], eos
        [S], greedy_only, k_scales=None, v_scales=None) -> (rngs',
        emitted [chunk, S])``.  Each step forwards every slot's current
        token one position (inactive lanes' K/V bit-frozen), samples per
        lane from the lane's own chain, emits -1 for inactive lanes and
        retires lanes at their EOS or budget."""
        self._census(("slot_step_q" if quant else "slot_step", S, T, chunk))

        @torch.no_grad()
        def run(pool_k, pool_v, tok, pos, active, left, rngs, temps, eos, greedy_only, k_scales=None, v_scales=None):
            emitted = []
            for _ in range(chunk):
                live = active & (left > 0)
                h, pool_k, pool_v = kv_forward(
                    self.module, tok[:, None], pos[:, None], pool_k, pool_v, pos, pos[:, None],
                    k_scales, v_scales, active=live,
                )
                logits = tied_readout(h[:, 0], self._table)
                rngs2, nxt = _sample_lanes(logits, temps, rngs, greedy_only)
                emitted.append(torch.where(live, nxt, -1))
                active = live & (nxt != eos)
                pos = torch.where(live, pos + 1, pos)
                left = torch.where(live, left - 1, left)
                tok = torch.where(live, nxt, tok)
                # a retired lane's chain stays where its last token left it
                rngs = torch.where(live[:, None], rngs2, rngs)
            return rngs, torch.stack(emitted)

        return run

    def _slot_verify_fn(self, S: int, T: int, k: int, quant: bool = False):
        """Speculative VERIFY over the pool in one forward of ``Ln = k``:
        ``(pool_k, pool_v, toks [S, k], pos, active, left, rngs, temps,
        eos, greedy_only, k_scales=None, v_scales=None) -> (rngs',
        emitted [k, S])``.  ``toks[:, 0]`` is each lane's last token and
        ``toks[:, 1:]`` its drafts; the scan over the ``k`` positions
        replays the plain step's sampling (one split per emitted token)
        and accepts while the draw equals the next forwarded token; the
        first disagreeing draw is still emitted, later positions emit -1.
        Rejected positions' K/V are unreachable: the next dispatch writes
        position ``pos`` before anything attends it."""
        self._census(("slot_verify_q" if quant else "slot_verify", S, T, k))

        @torch.no_grad()
        def run(pool_k, pool_v, toks, pos, active, left, rngs, temps, eos, greedy_only, k_scales=None, v_scales=None):
            dev = pool_k.device
            live0 = active & (left > 0)
            positions = pos[:, None] + torch.arange(k, device=dev)[None, :]
            h, pool_k, pool_v = kv_forward(
                self.module, toks, positions, pool_k, pool_v, pos, positions, k_scales, v_scales, active=live0
            )
            logits = tied_readout(h, self._table)  # [S, k, V]
            follow = torch.cat([toks[:, 1:], torch.full((S, 1), -1, dtype=toks.dtype, device=dev)], dim=1)
            acc, left_c = live0, left
            emitted = []
            for i in range(k):
                live = acc & (left_c > 0)
                rngs2, nxt = _sample_lanes(logits[:, i], temps, rngs, greedy_only)
                emitted.append(torch.where(live, nxt, -1))
                acc = live & (nxt != eos) & (nxt == follow[:, i])
                left_c = torch.where(live, left_c - 1, left_c)
                rngs = torch.where(live[:, None], rngs2, rngs)
            return rngs, torch.stack(emitted)

        return run

    def _slot_draft_fn(self, S: int, T: int, k_draft: int, D: int, quant: bool = False):
        """Reduced-layer TRUNK draft: ``(pool_k, pool_v, tok [S], pos
        [S], active [S], k_scales=None, v_scales=None) -> drafts [S,
        k_draft]``, ``k_draft`` greedy tokens from the first ``D`` blocks
        (plus ``final_ln``) of the same parameters, rolled forward on a
        COPY of the pool's first ``D`` layers."""
        self._census(("slot_draft_q" if quant else "slot_draft", S, T, k_draft, D))

        @torch.no_grad()
        def run(pool_k, pool_v, tok, pos, active, k_scales=None, v_scales=None):
            pk = pool_k[:, :D].clone()
            pv = pool_v[:, :D].clone()
            ks = None if k_scales is None else k_scales[:D]
            vs = None if v_scales is None else v_scales[:D]
            out = []
            for _ in range(k_draft):
                h, pk, pv = kv_forward(
                    self.module, tok[:, None], pos[:, None], pk, pv, pos, pos[:, None], ks, vs,
                    active=active, layers=D,
                )
                tok = torch.argmax(tied_readout(h[:, 0], self._table), dim=-1)
                pos = torch.where(active, pos + 1, pos)
                out.append(tok)
            return torch.stack(out, dim=1)

        return run
