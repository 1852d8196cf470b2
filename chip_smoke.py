#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathway_tpu_torch/``) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit from ``nvidia-smi``;
2. build of every CUDA kernel from ``pathway_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the card, at edge
   shapes (B = 1, B not a multiple of 8, B = 130, p = C, all probes on one
   cluster, duplicate and out-of-range probes, M and d not multiples of
   128, d = 99, M = 33, bf16 slabs, ~20% -inf bias rows), two launches
   bitwise equal, and no device-to-host sync in the wrapper;
4. the main path at full width: ``SentenceEncoder`` (384 wide, 6 layers,
   6 heads, d_ff 1536, max_length 128, vocab 32768, bf16, seeded init)
   encodes 65,536 synthetic documents; seeded unit vectors made on the
   card fill the index to 1,000,000 x 384; the exact ``DeviceKnnIndex``
   and ``IvfKnnIndex.build_from_matrix`` are built over that matrix; the
   rescore kernels are held against their plain version and timed at the
   main-path shape (the probes of a real query batch), over the f32 slabs
   and a bf16 copy;
5. serve: ``FusedEncodeSearch`` over both indexes answers batches of 64
   queries (encoded documents); checks exact self-hit 1.0, prints IVF
   recall@10 at the default probe and p50 latencies, and checks that the
   IVF serve launched the rescore kernel; then, on an index of the
   65,536 encoded documents alone, IVF at full probe must return the
   exact top-10;
6. absorb: 4,096 freshly encoded documents added to the 1M IVF index
   move into free slab slots in the background (in-place slab and bias
   writes; rows whose preferred clusters are full stay in the tail), and
   a full-probe IVF serve of 64 absorbed documents must rank each one's
   own key first;
7. retrain: a host-row ``IvfKnnIndex`` of 32,768 encoded documents is
   built, then 8,256 more are added (past ``rebuild_fraction`` = 0.25):
   the background retrain must install a new layout of all 41,024 rows,
   and a full-probe serve must rank each of 64 newly added documents
   first;
8. rerank: a ``ForwardIndex`` (16 pooled rows per document, int8)
   ingests the 65,536 encoded documents; a ``CrossEncoderModel`` (256
   wide, 4 layers, 4 heads, d_ff 1024, max_length 256, vocab 32768, bf16,
   seeded init) scores pairs; three ``RetrieveRerankPipeline`` over
   ``FusedEncodeSearch`` on the 1M IVF index (16 queries per call, 32
   candidates, k = 10): MaxSim only, MaxSim -> cross-encoder over the top
   10, cross-encoder only.  Checked: a MaxSim serve is 2 dispatches + 2
   fetches with no degraded flag; its MaxSim scores equal a NumPy
   recomputation from the fetched query token states and the
   dequantized forward rows within 1e-4; the packed cross-encoder scores
   equal ``predict(..., packed=False)`` within 3e-2 (bf16); every rerank
   call launches the rescore kernel once, and the kernel agrees with its
   plain version on the queries and probes of one 16-query rerank call.  Printed: p50 / p90 per mode,
   stage-2 ms per mode, device ms of the MaxSim step and of the packed
   cross-encoder forward, missing-document counts and known-item MRR.

The card's name and power limit, then the JSON record of the kernels,
then ``{"ok": true, "device": {...}}`` are the last three lines.
Without CUDA, or without the package beside it, the script fails before
printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 1_000_000
N_DOCS = 65_536
DIM = 384
BATCH = 64
K = 10
N_BATCHES = 110  # p90 of batch latency keeps 11 samples beyond it
ENCODE_CHUNK = 256
SEED = 0
DEVICE = "cuda"
RETRAIN_BASE = 32_768  # phase 7: host rows of the build
RETRAIN_GROW = 8_256  # > rebuild_fraction (0.25) of the build: a retrain
RR_QUERIES = 16  # phase 8: queries per rerank call
RR_CANDIDATES = 32
RR_CALLS = 50  # timed calls per mode
FWD_CHUNK = 1024  # forward-index ingest batch
CE_ATOL = 3e-2  # packed vs unpacked cross-encoder, bf16

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
KERNEL_ATOL = 1e-3  # f32 sums in another order than the plain einsum

_WORDS = (
    "stream join window index vector query tensor kernel shard replica commit "
    "offset snapshot schema tokenizer encoder cluster probe slab rescore latency "
    "batch device host cache ingest update serve table column row key value "
    "graph operator reducer universe persistence connector kafka postgres "
    "delta lake parquet json csv http rest grpc socket buffer queue topic "
    "partition leader follower epoch term vote log segment compaction merge "
    "sort filter project select group aggregate sum count mean max min "
    "sliding tumbling session watermark late event time processing exactly "
    "once at least retry backoff deadline circuit breaker fallback degrade "
    "memory bandwidth flops tensorcore warp block grid thread stride tile "
    "matrix embedding attention softmax layer norm residual gelu projection "
    "retrieval rerank document passage answer question context prompt model "
    "train infer serve deploy monitor trace metric histogram counter gauge"
).split()


def log(msg: str) -> None:
    print(msg, flush=True)


def corpus(n: int, seed: int = SEED):
    """Deterministic synthetic documents: 8-60 words from a built-in list
    plus a unique id token."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 61, size=n)
    picks = rng.integers(0, len(_WORDS), size=int(lens.sum()))
    out, pos = [], 0
    for i, n_words in enumerate(lens.tolist()):
        out.append(" ".join(_WORDS[j] for j in picks[pos : pos + n_words].tolist()) + f" doc{i}")
        pos += n_words
    return out


def keys_for(n: int):
    """Distinct 64-bit keys that use both int32 key planes."""
    return (np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)).tolist()


def timed_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after 2 warmups, each
    run between its own pair of CUDA events; ``flush`` (a buffer larger
    than L2) is rewritten before each run so the run starts with L2 cold."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in times]))


def compare_rescore(rescore, plain, probe, q, slabs, bias) -> float:
    """Kernel vs plain version on the same inputs: identical -inf pattern,
    finite values within KERNEL_ATOL.  Returns the max abs error."""
    got = rescore(probe, q, slabs, bias)
    want = plain(probe, q, slabs, bias)
    torch.cuda.synchronize()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("rescore kernel: -inf pattern differs from the plain version")
    fin = torch.isfinite(want)
    if not bool(torch.isfinite(got[fin]).all()):
        raise AssertionError("rescore kernel: non-finite value where the plain version is finite")
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err > KERNEL_ATOL:
        raise AssertionError(f"rescore kernel: max abs err {err} > {KERNEL_ATOL}")
    return err


def rescore_edge_cases(rescore, plain, dev) -> float:
    """The kernel against its plain version at edge shapes: B not a
    multiple of 8, B = 1, B = 130 (more queries on a cluster than one pass
    takes), p = C, every probe on one cluster, duplicate probes in a row,
    out-of-range ids (clamped, as the reference's gather does), M, d, C
    off the TPU tiling, d = 99 (the non-TMA path) in both slab types,
    M = 33, bf16 at the main-path widths.  Each shape also runs twice and
    must give bitwise-equal output."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for B, p, C, M, d, dtype, probes in (
        (3, 5, 16, 128, 128, torch.float32, "random"),  # B not a multiple of 8
        (8, 16, 16, 128, 128, torch.float32, "perm"),  # p = C
        (1, 6, 40, 256, 384, torch.float32, "random"),  # B = 1
        (130, 8, 12, 96, 64, torch.float32, "random"),  # several query passes per cluster
        (64, 1, 9, 128, 384, torch.float32, "one"),  # every probe on one cluster
        (7, 6, 11, 96, 128, torch.bfloat16, "dup"),  # duplicate probes in a row
        (5, 4, 8, 64, 96, torch.float32, "oob"),  # ids outside [0, C)
        (5, 7, 7, 200, 96, torch.float32, "random"),  # M, d, C off the TPU tiling
        (5, 7, 7, 200, 96, torch.bfloat16, "random"),  # bf16 slabs
        (4, 3, 9, 33, 99, torch.float32, "random"),  # d = 99: rows not 16-byte aligned
        (4, 3, 9, 33, 99, torch.bfloat16, "random"),
        (6, 4, 10, 33, 128, torch.float32, "random"),  # M = 33 through TMA
        (64, 69, 300, 256, 384, torch.bfloat16, "random"),  # main-path widths, bf16
    ):
        q = torch.randn(B, d, generator=gen, device=dev)
        slabs = torch.randn(C, M, d, generator=gen, device=dev).to(dtype)
        bias = torch.where(
            torch.rand(C, M, generator=gen, device=dev) < 0.2,
            torch.tensor(float("-inf"), device=dev),
            torch.tensor(0.0, device=dev),
        )
        if probes == "perm":
            probe = torch.stack([torch.randperm(C, generator=gen, device=dev) for _ in range(B)])
        elif probes == "one":
            probe = torch.full((B, p), C // 2, device=dev)
        elif probes == "dup":
            probe = torch.randint(0, C, (B, p // 2), generator=gen, device=dev).repeat_interleave(2, dim=1)
        elif probes == "oob":
            probe = torch.randint(-3, C + 3, (B, p), generator=gen, device=dev)
        else:
            probe = torch.randint(0, C, (B, p), generator=gen, device=dev)
        probe = probe.to(torch.int32)
        err = compare_rescore(
            rescore, lambda pr, *a: plain(pr.clamp(0, C - 1), *a), probe, q, slabs, bias
        )
        again = [rescore(probe, q, slabs, bias) for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(again[0].view(torch.int32), again[1].view(torch.int32)):
            raise AssertionError(f"rescore kernel: two launches differ at B={B} p={p} C={C} M={M} d={d}")
        log(
            f"kernel ivf_rescore vs plain B={B} p={p} C={C} M={M} d={d} {dtype} probes={probes}: "
            f"max_abs_err={err:.3e}, two launches bitwise equal"
        )
        worst = max(worst, err)
    # the wrapper makes no device-to-host sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        rescore(probe, q, slabs, bias)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("kernel ivf_rescore: no device-to-host sync under torch.cuda.set_sync_debug_mode('error')")
    return worst


def kernel_time(fn, reps: int):
    """Device time of ``fn``'s kernels alone, without the gaps between
    them (``torch.profiler``): (ms per call, kernel launches per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    return total_us / 1e3 / reps, sum(e.count for e in events) / reps


def same_ranking(want, got, tie=1e-5, atol=1e-4) -> bool:
    """Rows of (key, score): keys equal position by position except
    between scores tied within ``tie``."""
    if len(want) != len(got):
        return False
    ws = [s for _, s in want]
    for j, ((wk, wsc), (gk, gsc)) in enumerate(zip(want, got)):
        if abs(wsc - gsc) > atol:
            return False
        if wk != gk:
            tied = any(abs(ws[i] - wsc) <= tie for i in (j - 1, j + 1) if 0 <= i < len(ws))
            if not (tied and abs(wsc - gsc) <= tie):
                return False
    return True


def pipelined_qps(serve, batches, depth: int = 4) -> float:
    """Queries per second with ``depth`` batches submitted ahead of the
    one being completed (the device queue stays fed)."""
    pending = []
    t = time.perf_counter()
    for texts in batches:
        pending.append(serve.submit(texts))
        if len(pending) > depth:
            pending.pop(0)()
    while pending:
        pending.pop(0)()
    return len(batches) * BATCH / (time.perf_counter() - t)


def host_breakdown(serve, batches) -> str:
    """Mean time per batch of the serve path's first two steps, each run
    alone and synchronized: host tokenize + pad, and the encoder trunk
    forward (host launch + device).  Stage 1 and the completion take the
    rest of a serve's latency."""
    enc = serve.encoder
    t = time.perf_counter()
    toks = [enc.tokenizer.encode_batch(texts) for texts in batches]
    tok_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    dev_toks = [(torch.from_numpy(i).to(enc.device), torch.from_numpy(m).to(enc.device)) for i, m in toks]
    enc.forward(*dev_toks[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for ids, mask in dev_toks:
        enc.forward(ids, mask)
        torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    L = [i.shape[1] for i, _ in toks]
    return f"tokenize {tok_ms:.3f} ms/batch, encoder forward {fwd_ms:.3f} ms/batch (L {min(L)}-{max(L)})"


def profile_serve(serve, batches) -> str:
    """Where one serve batch's time goes: wall time per batch (host
    clock), device kernel time per batch and its share of the wall, and
    the kernels with the most device time (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    serve(batches[0])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for texts in batches:
            serve(texts)
        wall_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0.0) for e in events}
    busy_ms = sum(dev_us.values()) / 1e3 / len(batches)
    if busy_ms == 0:
        return f"wall {wall_ms:.3f} ms/batch; device time not measured (no CUDA events traced)"
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    parts = "; ".join(f"{k[:60]} {v / 1e3 / len(batches):.3f} ms" for k, v in top)
    return (
        f"wall {wall_ms:.3f} ms/batch, device kernels {busy_ms:.3f} ms/batch "
        f"({100 * busy_ms / wall_ms:.1f}% busy); top: {parts}"
    )


def wait_maintenance(index, timeout_s: float = 180.0) -> float:
    """Wait for an IVF index's background absorb and retrain threads;
    returns the seconds waited."""
    t0 = time.perf_counter()
    while index._absorbing or index._retraining:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"background maintenance still running after {timeout_s} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def retrain_phase(encoder, docs, doc_vecs, keys, tag: str) -> None:
    """A host-row IVF index grown past ``rebuild_fraction`` retrains in
    the background; a full-probe serve then finds the new rows."""
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    n_all = RETRAIN_BASE + RETRAIN_GROW
    vecs = doc_vecs[:n_all].float().cpu().numpy()
    index = IvfKnnIndex(DIM, metric="cos")
    t0 = time.perf_counter()
    index.add(keys[:RETRAIN_BASE], vecs[:RETRAIN_BASE])
    index.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    C0 = index._centroids.shape[0]
    t0 = time.perf_counter()
    index.add(keys[RETRAIN_BASE:n_all], vecs[RETRAIN_BASE:])
    wait_maintenance(index)
    retrain_s = time.perf_counter() - t0
    st = index.stats
    if st["retrains"] != 1 or st["retrain_failures"] or index._built_n != n_all or index._tail:
        raise AssertionError(f"retrain: stats {st}, built_n {index._built_n}, tail {len(index._tail)}")
    C = index._centroids.shape[0]
    index.n_probe = C
    rows = list(range(RETRAIN_BASE, n_all, RETRAIN_GROW // BATCH))[:BATCH]
    got = FusedEncodeSearch(encoder, index, k=K)([docs[i] for i in rows])
    found = sum(1 for row, i in zip(got, rows) if row and row[0][0] == keys[i])
    log(
        f"retrain: host-row IVF of {RETRAIN_BASE} encoded docs built in {build_s:.3f} s (C={C0}); "
        f"{RETRAIN_GROW} more added past rebuild_fraction={index.rebuild_fraction}: background retrain "
        f"installed a {n_all}-row layout (C={C}) {retrain_s:.3f} s after the add, absorbs {st['absorbs']}; "
        f"full-probe serve ranks the added key first on {found}/{len(rows)} rows {tag}"
    )
    if found != len(rows):
        raise AssertionError(f"after the retrain a full-probe serve found {found}/{len(rows)} added keys")


def rerank_phase(encoder, ivf, docs, keys, tag: str):
    """Forward-index ingest, then the three rerank modes over the 1M IVF
    index; returns the rescore launches of the timed rerank calls and the
    rescore kernel's max abs error against its plain version at this
    path's shape."""
    from pathway_tpu_torch.index import ForwardIndex
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
    from pathway_tpu_torch.ops import dispatch_counter
    from pathway_tpu_torch.ops.ivf_rescore import ivf_rescore_reference, rescore_shortlist
    from pathway_tpu_torch.ops.knn import _bucket
    from pathway_tpu_torch.ops.maxsim import maxsim_scores_host, maxsim_topk
    from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    dev = torch.device(DEVICE)
    fwd = ForwardIndex(encoder, tokens_per_doc=16, quant="int8")
    t0 = time.perf_counter()
    for i in range(0, N_DOCS, FWD_CHUNK):
        fwd.add(keys[i : i + FWD_CHUNK], docs[i : i + FWD_CHUNK])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if len(fwd) != N_DOCS:
        raise AssertionError(f"forward index holds {len(fwd)} of {N_DOCS} docs")
    log(
        f"forward index: {N_DOCS} docs ingested in {ingest_s:.2f} s ({N_DOCS / ingest_s:.0f} docs/s incl. "
        f"host tokenize + encode), T'={fwd.tokens_per_doc} int8, {fwd.hbm_bytes() / 1e6:.1f} MB on the card "
        f"(capacity {fwd._capacity}), compression {fwd.compression_ratio():.2f}x, "
        f"audit |MaxSim f32 - int8| {fwd._quant_abs_err:.5f} {tag}"
    )
    ce = CrossEncoderModel(
        dimension=256, n_layers=4, n_heads=4, max_length=256, vocab_size=32768,
        seed=SEED + 1, dtype=torch.bfloat16,
    )
    doc_text = dict(zip(keys[:N_DOCS], docs))

    def retriever():
        return FusedEncodeSearch(encoder, ivf, k=RR_CANDIDATES)

    modes = {
        "maxsim": RetrieveRerankPipeline(
            retriever(), doc_text=doc_text, k=K, candidates=RR_CANDIDATES, forward_index=fwd
        ),
        "cascade": RetrieveRerankPipeline(
            retriever(), ce, doc_text, k=K, candidates=RR_CANDIDATES, forward_index=fwd, cascade=K
        ),
        "cross_encoder": RetrieveRerankPipeline(retriever(), ce, doc_text, k=K, candidates=RR_CANDIDATES),
    }
    # known-item queries: every other word of an indexed document
    n_q = RR_CALLS * RR_QUERIES
    targets = [(i * 9973 + 1) % N_DOCS for i in range(n_q)]
    calls = [
        [" ".join(docs[t].split()[::2]) for t in targets[c * RR_QUERIES : (c + 1) * RR_QUERIES]]
        for c in range(RR_CALLS)
    ]
    for pipe in modes.values():
        pipe(calls[0])  # warm

    # the main path, counted: every rerank call launches the rescore kernel once
    rescore_shortlist.launches = 0
    lat = {name: [] for name in modes}
    mrr = {name: 0.0 for name in modes}
    missing = {name: [0, 0] for name in modes}  # forward_missing, missing_docs
    for c, qs in enumerate(calls):
        for name, pipe in modes.items():
            before = rescore_shortlist.launches
            t = time.perf_counter()
            got = pipe(qs)
            lat[name].append((time.perf_counter() - t) * 1e3)
            if rescore_shortlist.launches != before + 1:
                raise AssertionError(f"{name}: {rescore_shortlist.launches - before} rescore launches in one call")
            if len(got) != RR_QUERIES or any(len(r) != K for r in got):
                raise AssertionError(f"{name}: rerank returned the wrong shape")
            if not all(np.isfinite(s) for r in got for _, s in r) or got.degraded:
                raise AssertionError(f"{name}: non-finite score or degraded {got.degraded}")
            missing[name][0] += len(got.meta.get("forward_missing", ()))
            missing[name][1] += len(got.meta.get("missing_docs", ()))
            for row, target in zip(got, targets[c * RR_QUERIES :]):
                ranked = [key for key, _ in row]
                if keys[target] in ranked:
                    mrr[name] += 1.0 / (ranked.index(keys[target]) + 1)
    rr_launches = rescore_shortlist.launches
    if rr_launches != len(modes) * RR_CALLS:
        raise AssertionError(f"rerank calls launched the rescore kernel {rr_launches} times")

    # the rescore kernel at this path's own shape, against its plain
    # version: the queries and probes of one 16-query stage-1 call, made
    # by the retriever's own steps (outside the counted window)
    stage1 = modes["maxsim"].retriever
    ids, mask = encoder.tokenizer.encode_batch(calls[0])
    pad = np.zeros((_bucket(len(ids)) - len(ids), ids.shape[1]), ids.dtype)
    with torch.no_grad():
        z, _ = stage1._embed(np.concatenate([ids, pad]), np.concatenate([mask, pad]))
        probe = torch.topk(z @ ivf._centroids.t(), ivf.probe_count(), dim=1).indices.to(torch.int32)
        zq = torch.nn.functional.pad(z, (0, ivf._d_pad - z.shape[1])).contiguous()
        rr_args = (probe, zq, ivf._slabs, ivf._bias)
        rescore_err = compare_rescore(rescore_shortlist, ivf_rescore_reference, *rr_args)
        flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        rr_kernel_ms = timed_ms(lambda: rescore_shortlist(*rr_args), reps=20, flush=flush)
        del flush
    log(
        f"kernel ivf_rescore vs plain at the rerank stage-1 shape B={probe.shape[0]} p={probe.shape[1]} "
        f"C={ivf._centroids.shape[0]} M={ivf._M_pad} d={zq.shape[1]} f32 slabs, "
        f"{int(torch.unique(probe).numel())} distinct clusters probed: max_abs_err={rescore_err:.3e}, "
        f"kernel {rr_kernel_ms:.4f} ms {tag}"
    )

    # stage 2 alone: the cascade after a completed stage 1 (host clock)
    stage2 = {}
    for name, pipe in modes.items():
        times = []
        for qs in calls[:20]:
            first = pipe.retriever.submit(qs, RR_CANDIDATES)
            hits = first()
            t = time.perf_counter()
            done = pipe._submit_chain(
                qs, hits, K, query_tokens=first.query_tokens, query_mask=first.query_mask
            )
            done()
            times.append((time.perf_counter() - t) * 1e3)
        stage2[name] = float(np.percentile(times, 50))

    # checks: the 2 + 2 budget, MaxSim against NumPy, packed CE against unpacked
    qs = calls[1]
    with dispatch_counter.DispatchCounter() as counter:
        got = modes["maxsim"](qs)
    if (counter.dispatches, counter.fetches) != (2, 2) or got.degraded:
        raise AssertionError(f"MaxSim serve: {counter.events}, degraded {got.degraded}")
    handle = modes["maxsim"].submit(qs)
    got = handle()
    qtok = handle._stage1.query_tokens.cpu().numpy()
    qmask = handle._stage1.query_mask
    tok = fwd._tok.float().cpu().numpy()
    scales = fwd._scales.cpu().numpy()
    nvalid = fwd._nvalid.cpu().numpy()
    maxsim_err, checked = 0.0, 0
    for qi, row in enumerate(got):
        for key, score in row:
            slot = fwd._slot_of_key.get(key)
            if slot is None:
                continue  # backfilled with its stage-1 score
            want = maxsim_scores_host(qtok[qi], qmask[qi], (tok[slot] * scales[slot])[None], nvalid[slot : slot + 1])[0]
            maxsim_err = max(maxsim_err, abs(score - float(want)))
            checked += 1
    if checked == 0 or maxsim_err > 1e-4:
        raise AssertionError(f"MaxSim vs NumPy: max abs err {maxsim_err} over {checked} scores")
    got = modes["cross_encoder"](qs)
    pairs = [(q, doc_text.get(key, "")) for q, row in zip(qs, got) for key, _ in row]
    unpacked = ce.predict(pairs, packed=False)
    packed = np.asarray([s for row in got for _, s in row], np.float32)
    ce_err = float(np.abs(packed - unpacked).max())
    if ce_err > CE_ATOL:
        raise AssertionError(f"packed cross-encoder vs unpacked: max abs err {ce_err} > {CE_ATOL}")

    # device time of the two stage-2 steps at this run's shapes (CUDA events)
    first = modes["maxsim"].retriever.submit(qs, RR_CANDIDATES)
    hits = first()
    slots = np.full((first.query_tokens.shape[0], RR_CANDIDATES), -1, np.int32)
    for qi, row in enumerate(hits):
        for j, (key, _) in enumerate(row[:RR_CANDIDATES]):
            slots[qi, j] = fwd._slot_of_key.get(key, -1)
    slots_dev = torch.from_numpy(slots).to(dev)
    qmask_dev = torch.from_numpy(first.query_mask.astype(np.float32)).to(dev)
    Lq = first.query_tokens.shape[1]
    with torch.no_grad():
        maxsim_ms = timed_ms(
            lambda: maxsim_topk(first.query_tokens, qmask_dev, fwd._tok, fwd._scales, fwd._nvalid, slots_dev, K, True),
            reps=50,
        )
        ce_pairs = [(q, doc_text.get(key, "")) for q, row in zip(qs, hits) for key, _ in row[:RR_CANDIDATES]]
        ids, segs, pos, S, _ = ce.packed_inputs(ce_pairs)
        ce_ms = timed_ms(lambda: ce.packed_forward(ids, segs, pos, S), reps=20)
        maxsim_kernel_ms, maxsim_kernels = kernel_time(
            lambda: maxsim_topk(first.query_tokens, qmask_dev, fwd._tok, fwd._scales, fwd._nvalid, slots_dev, K, True),
            reps=20,
        )
        ce_kernel_ms, ce_kernels = kernel_time(lambda: ce.packed_forward(ids, segs, pos, S), reps=5)
    n_cand = int((slots >= 0).sum())
    maxsim_bytes = n_cand * (16 * DIM + DIM * 4 + 4) + first.query_tokens.numel() * 4
    maxsim_flops = 2 * slots.size * Lq * 16 * DIM
    real_tokens = int((segs > 0).sum())
    log(
        f"rerank {RR_CALLS} calls x {RR_QUERIES} queries per mode over the 1M IVF index, {RR_CANDIDATES} "
        f"candidates, k={K}, closed loop (host clock, submit to result) {tag}: "
        + "; ".join(
            f"{name} p50 {np.percentile(v, 50):.3f} ms p90 {np.percentile(v, 90):.3f} ms, stage 2 alone "
            f"p50 {stage2[name]:.3f} ms, known-item MRR {mrr[name] / n_q:.4f}, forward_missing {missing[name][0]}, "
            f"missing_docs {missing[name][1]}"
            for name, v in lat.items()
        )
        + f"; rescore launches {rr_launches} (1 per call)"
    )
    log(
        f"rerank checks {tag}: MaxSim serve 2 dispatches + 2 fetches; MaxSim vs NumPy max abs err "
        f"{maxsim_err:.3e} over {checked} scores; packed vs unpacked cross-encoder max abs err {ce_err:.3e} "
        f"over {len(pairs)} pairs"
    )
    log(
        f"stage-2 device time {tag}: MaxSim step (gather + dequantize + MaxSim + top-k, B={slots.shape[0]} "
        f"Kc={RR_CANDIDATES} Lq={Lq} T'=16 d={DIM}, {n_cand} resident candidates, {maxsim_bytes / 1e6:.3f} MB, "
        f"{maxsim_flops / 1e9:.3f} GFLOP) {maxsim_ms:.4f} ms between CUDA events, its kernels alone "
        f"{maxsim_kernel_ms:.4f} ms in {maxsim_kernels:.0f} launches; packed cross-encoder forward "
        f"({len(ce_pairs)} pairs in {ids.shape[0]} rows x {ids.shape[1]} tokens, {S} segments per row, "
        f"{real_tokens} real tokens) {ce_ms:.4f} ms between CUDA events, its kernels alone "
        f"{ce_kernel_ms:.4f} ms in {ce_kernels:.0f} launches"
    )
    for name, pipe in modes.items():
        log(f"profile rerank {name} {tag}: " + profile_serve(pipe, calls[:3]))
    return rr_launches, rescore_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pathway_tpu_torch.kernels.build import build_all
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import ivf_rescore_reference, rescore_shortlist
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    tag = f"[{smi}]"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build_all()
    log(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s")

    # -- 3. kernel vs plain at edge shapes ------------------------------------
    worst_err = rescore_edge_cases(rescore_shortlist, ivf_rescore_reference, dev)

    # -- 4. main path at full width ------------------------------------------
    t0 = time.perf_counter()
    encoder = SentenceEncoder(
        dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768,
        seed=SEED, dtype=torch.bfloat16,
    )
    docs = corpus(N_DOCS)
    t_tok = time.perf_counter()
    doc_vecs = torch.cat(
        [encoder.encode_to_device(docs[i : i + ENCODE_CHUNK]) for i in range(0, N_DOCS, ENCODE_CHUNK)]
    )
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t_tok
    n_rand = N_ROWS - N_DOCS
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rand_vecs = torch.randn(n_rand, DIM, generator=gen, device=dev)
    rand_vecs /= torch.linalg.vector_norm(rand_vecs, dim=1, keepdim=True)
    log(
        f"index rows: {N_DOCS} encoded docs + {n_rand} seeded unit vectors = {N_ROWS} x {DIM}; "
        f"encode {N_DOCS} docs {t_enc:.2f} s ({N_DOCS / t_enc:.0f} docs/s incl. host tokenize) {tag}"
    )
    keys = keys_for(N_ROWS)
    exact = DeviceKnnIndex(DIM, metric="cos", initial_capacity=N_ROWS)
    exact.add_from_device(keys[:N_DOCS], doc_vecs)
    exact.add_from_device(keys[N_DOCS:], rand_vecs)
    del rand_vecs
    torch.cuda.synchronize()
    t_ivf = time.perf_counter()
    ivf = IvfKnnIndex(DIM, metric="cos")
    ivf.build_from_matrix(keys, exact._matrix[:N_ROWS])
    torch.cuda.synchronize()
    C = ivf._centroids.shape[0]
    p = ivf.probe_count()
    M = ivf._M_pad
    log(
        f"exact index {len(exact)} rows; IVF build {time.perf_counter() - t_ivf:.2f} s: "
        f"C={C} C_pad={ivf._slabs.shape[0]} M_pad={M} d_pad={ivf._d_pad} n_probe={p} "
        f"slabs {ivf._slabs.numel() * ivf._slabs.element_size() / 1e9:.2f} GB; "
        f"main-path setup {time.perf_counter() - t0:.2f} s {tag}"
    )
    if len(exact) != N_ROWS or len(ivf) != N_ROWS:
        raise AssertionError(f"index sizes {len(exact)}, {len(ivf)} != {N_ROWS}")

    # the rescore kernel at the main-path shape: a real batch's probes
    qidx = [(i * 9973) % N_DOCS for i in range(N_BATCHES * BATCH)]
    batches = [[docs[j] for j in qidx[b * BATCH : (b + 1) * BATCH]] for b in range(N_BATCHES)]
    with torch.no_grad():
        z = encoder.encode_to_device(batches[0])
        probe = torch.topk(z @ ivf._centroids.t(), p, dim=1).indices.to(torch.int32)
        q = z.contiguous()
        args = (probe, q, ivf._slabs, ivf._bias)
        worst_err = max(worst_err, compare_rescore(rescore_shortlist, ivf_rescore_reference, *args))
        flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        kernel_ms = timed_ms(lambda: rescore_shortlist(*args), reps=20, flush=flush)
        plain_ms = timed_ms(lambda: ivf_rescore_reference(*args), reps=5, flush=flush)
        pl = probe.long()
        d_pad = ivf._d_pad
        qcol = q.reshape(BATCH, -1, 1)

        def gather_baddbmm():
            rows_ = ivf._slabs[pl].reshape(BATCH, p * M, d_pad)
            return torch.baddbmm(ivf._bias[pl].reshape(BATCH, p * M, 1), rows_, qcol)

        rows = ivf._slabs[pl].reshape(BATCH, p * M, d_pad)
        bias_g = ivf._bias[pl].reshape(BATCH, p * M, 1)
        library_ms = timed_ms(lambda: torch.baddbmm(bias_g, rows, qcol), reps=5, flush=flush)
        del rows, bias_g
        library_gather_ms = timed_ms(gather_baddbmm, reps=5, flush=flush)
        # the same probes over bf16 slabs (a bf16 copy of the index's slabs)
        slabs16 = ivf._slabs.to(torch.bfloat16)
        args16 = (probe, q, slabs16, ivf._bias)
        worst_err = max(worst_err, compare_rescore(rescore_shortlist, ivf_rescore_reference, *args16))
        bf16_ms = timed_ms(lambda: rescore_shortlist(*args16), reps=20, flush=flush)
        bf16_plain_ms = timed_ms(lambda: ivf_rescore_reference(*args16), reps=5, flush=flush)
        del slabs16, args16, flush
    distinct = int(torch.unique(probe).numel())
    n_ops = 2 * BATCH * p * M * d_pad
    io_bytes = q.numel() * 4 + probe.numel() * 4 + BATCH * p * M * 4  # q, probe, out

    def bound(elem: int):
        """(bound ms, what bounds it, bytes): each probed slab and its bias
        row read once, q and probe read once, the output written once;
        f32 FLOPs at the f32 rate outside the tensor cores."""
        n_bytes = distinct * M * (d_pad * elem + 4) + io_bytes
        t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", n_bytes

    bound_ms, bound_by, n_bytes = bound(4)
    bf16_bound_ms, bf16_bound_by, bf16_bytes = bound(2)
    log(
        f"ivf_rescore at main-path shape B={BATCH} p={p} M={M} d={d_pad}, "
        f"{distinct} distinct clusters probed ({n_ops / 1e9:.3f} GFLOP): f32 slabs ({n_bytes / 1e9:.3f} GB) "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, baddbmm over slabs gathered beforehand "
        f"(gather not timed) {library_ms:.4f} ms, gather + baddbmm {library_gather_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); bf16 slabs ({bf16_bytes / 1e9:.3f} GB) kernel {bf16_ms:.4f} ms, "
        f"plain {bf16_plain_ms:.4f} ms, bound {bf16_bound_ms:.4f} ms ({bf16_bound_by}) {tag}"
    )

    # -- 5. serve: the main path, counted --------------------------------------
    serve_exact = FusedEncodeSearch(encoder, exact, k=K)
    serve_ivf = FusedEncodeSearch(encoder, ivf, k=K)
    rescore_shortlist.launches = 0
    lat = {"exact": [], "ivf": []}
    self_hits = recall_hits = 0
    for b, texts in enumerate(batches):
        t = time.perf_counter()
        got_exact = serve_exact(texts)
        lat["exact"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        got_ivf = serve_ivf(texts)
        lat["ivf"].append((time.perf_counter() - t) * 1e3)
        want_keys = [keys[j] for j in qidx[b * BATCH : (b + 1) * BATCH]]
        self_hits += sum(1 for row, key in zip(got_exact, want_keys) if row and row[0][0] == key)
        recall_hits += sum(
            len({k for k, _ in e} & {k for k, _ in v}) for e, v in zip(got_exact, got_ivf)
        )
        for rows_ in (got_exact, got_ivf):
            if len(rows_) != BATCH or any(len(r) != K for r in rows_):
                raise AssertionError("serve returned the wrong shape")
            if not all(np.isfinite(s) for r in rows_ for _, s in r):
                raise AssertionError("serve returned a non-finite score")
    launches = rescore_shortlist.launches
    n_q = N_BATCHES * BATCH
    self_hit = self_hits / n_q
    recall = recall_hits / (K * n_q)
    pct = {
        name: (float(np.percentile(v, 50)), float(np.percentile(v, 90))) for name, v in lat.items()
    }
    log(
        f"serve {N_BATCHES} batches x {BATCH} queries, k={K}, closed loop, one batch in flight "
        f"(host clock from submit to result, first batch included) {tag}: "
        f"exact p50 {pct['exact'][0]:.3f} ms p90 {pct['exact'][1]:.3f} ms; "
        f"IVF p50 {pct['ivf'][0]:.3f} ms p90 {pct['ivf'][1]:.3f} ms; "
        f"self-hit {self_hit:.4f} of {n_q}; IVF recall@10 vs exact {recall:.4f} at n_probe={p}; "
        f"rescore launches {launches}"
    )
    if self_hit != 1.0:
        misses = [
            (key, row[:3])
            for b, texts in enumerate(batches[:1])
            for row, key in zip(serve_exact(texts), [keys[j] for j in qidx[:BATCH]])
            if not row or row[0][0] != key
        ]
        raise AssertionError(f"exact self-hit rate {self_hit} != 1.0; first batch misses {misses[:5]}")
    if launches < N_BATCHES:
        raise AssertionError(f"IVF serve launched the rescore kernel {launches} times")

    log(f"serve steps alone {tag}: " + host_breakdown(serve_exact, batches[:50]))
    for name, serve in (("exact", serve_exact), ("ivf", serve_ivf)):
        qps = pipelined_qps(serve, batches[:100])
        log(f"pipelined {name} serve, 4 batches in flight {tag}: {qps:.1f} queries/s")
        log(f"profile {name} serve {tag}: " + profile_serve(serve, batches[:3]))

    # full probe on the encoded docs alone: IVF top-10 == exact top-10
    small_exact = DeviceKnnIndex(DIM, metric="cos", initial_capacity=N_DOCS)
    small_exact.add_from_device(keys[:N_DOCS], doc_vecs)
    small_ivf = IvfKnnIndex(DIM, metric="cos")
    small_ivf.build_from_matrix(keys[:N_DOCS], small_exact._matrix[:N_DOCS])
    small_ivf.n_probe = small_ivf._centroids.shape[0]
    want = FusedEncodeSearch(encoder, small_exact, k=K)(batches[0])
    got = FusedEncodeSearch(encoder, small_ivf, k=K)(batches[0])
    mismatched = sum(1 for w, g in zip(want, got) if not same_ranking(w, g))
    log(f"full probe (n_probe={small_ivf.n_probe}) on {N_DOCS} docs: {BATCH - mismatched}/{BATCH} rows equal exact")
    if mismatched:
        raise AssertionError(f"full-probe IVF differs from exact on {mismatched} rows")

    # -- 6. absorb on the 1M index ----------------------------------------------
    # fresh documents past absorb_threshold move into free slab slots in the
    # background; a full-probe serve must then rank each one first
    fresh = [t + " absorbed" for t in corpus(ivf.absorb_threshold, seed=SEED + 7)]
    fresh_keys = [(1 << 62) + i for i in range(len(fresh))]
    if set(fresh_keys) & set(keys):
        raise AssertionError("fresh keys collide with indexed keys")
    with torch.no_grad():
        fresh_vecs = torch.cat(
            [encoder.encode_to_device(fresh[i : i + ENCODE_CHUNK]) for i in range(0, len(fresh), ENCODE_CHUNK)]
        ).cpu().numpy()
    t0 = time.perf_counter()
    ivf.add(fresh_keys, fresh_vecs)
    while ivf._absorbing:
        if time.perf_counter() - t0 > 120:
            raise AssertionError("absorb did not finish within 120 s")
        time.sleep(0.01)
    absorb_s = time.perf_counter() - t0
    # rows whose preferred clusters are all full stay in the exact tail,
    # as in the reference
    placed = [i for i, key in enumerate(fresh_keys) if key in ivf._slot_of_key]
    if ivf.stats["absorbs"] != 1 or ivf.stats["absorb_failures"] or len(placed) < BATCH:
        raise AssertionError(f"absorb placed {len(placed)}/{len(fresh)} rows; stats {ivf.stats}")
    if len(placed) + len(ivf._tail) != len(fresh):
        raise AssertionError(f"{len(placed)} placed + {len(ivf._tail)} in the tail != {len(fresh)} added")
    ivf.n_probe = C
    before = rescore_shortlist.launches
    probe_rows = placed[:: max(1, len(placed) // BATCH)][:BATCH]
    got = FusedEncodeSearch(encoder, ivf, k=K)([fresh[i] for i in probe_rows])
    found = sum(1 for row, i in zip(got, probe_rows) if row and row[0][0] == fresh_keys[i])
    ivf.n_probe = None
    log(
        f"absorb: {len(fresh)} fresh rows added past absorb_threshold={ivf.absorb_threshold}, "
        f"{len(placed)} placed in free slots, {len(ivf._tail)} left in the exact tail (their 4 preferred "
        f"clusters full), in {absorb_s:.3f} s; full-probe IVF serve (n_probe={C}, "
        f"{rescore_shortlist.launches - before} rescore launch) ranks the absorbed key first on "
        f"{found}/{BATCH} rows {tag}"
    )
    if found != BATCH:
        raise AssertionError(f"full-probe serve found {found}/{BATCH} absorbed keys")

    # -- 7. background retrain --------------------------------------------------
    retrain_phase(encoder, docs, doc_vecs, keys, tag)

    # -- 8. rerank: the main path's stage 2, counted ----------------------------
    rr_launches, rr_err = rerank_phase(encoder, ivf, docs, keys, tag)
    worst_err = max(worst_err, rr_err)

    record = {
        "kernels": [
            {
                "name": "ivf_rescore",
                "route": "cuda",
                "source": "pathway_tpu_torch/csrc/ivf_rescore.cu",
                "replaces": "pathway_tpu/ops/ivf_pallas.py:37",
                "launches": launches + rr_launches,
                "launches_by_path": {"serve": launches, "rerank": rr_launches},
                "max_abs_err": worst_err,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
                "library_with_gather_ms": library_gather_ms,
                "bf16_ms": bf16_ms,
                "bf16_plain_ms": bf16_plain_ms,
                "bf16_bound_ms": bf16_bound_ms,
                "bf16_bound_by": bf16_bound_by,
            }
        ]
    }
    print(smi)
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
