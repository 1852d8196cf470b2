#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathway_tpu_torch/``) on one
NVIDIA GPU:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare ROOT   # the package under ROOT alone: host
                                           # us per row-kernel wrapper call,
                                           # engine c16 decode tokens/s and the
                                           # c16 scheduled cascade's q/s
    python3 chip_smoke.py --framing        # host seconds of the warm-state
                                           # framing, plain against bulk
    python3 chip_smoke.py --real-weights   # the kernels' build, then phase 15
                                           # alone (~2 minutes)
    python3 chip_smoke.py --sharded        # the kernels' build, phase 4's rows,
                                           # then phase 16 alone (~1 minute)
    python3 chip_smoke.py --distributed    # the builds, phase 4's rows, then
                                           # phase 17 alone
    python3 chip_smoke.py --fabric         # the kernels' build, phase 4's rows
                                           # and the cascade, then phase 18 alone
    python3 chip_smoke.py --framework      # the builds, phase 4's rows and the
                                           # direct serve p50s, then phase 19 alone
    python3 chip_smoke.py --qa             # the same set-up, then phase 20 alone
    python3 chip_smoke.py --persist        # the builds, then phase 21 alone
    python3 chip_smoke.py --temporal       # the builds, then phase 22 alone
    python3 chip_smoke.py --hostapi        # the builds, then phase 23 alone
    python3 chip_smoke.py --cluster        # the builds, then phase 24 alone
    python3 chip_smoke.py --connectors     # the builds, then phase 25 alone
    python3 chip_smoke.py --analysis       # the builds, then phase 26 alone
    python3 chip_smoke.py --native         # the builds, then phase 27 alone
    python3 chip_smoke.py --surface        # the builds and phase 4's rows,
                                           # then phase 28 alone
    python3 chip_smoke.py --first-call ROOT...  # the profiler's first sampled
                                           # call, fresh processes, per root

Phases, in order; any failure exits non-zero:

1. the card's name and power limit from ``nvidia-smi``;
2. build of every CUDA kernel from ``pathway_tpu_torch/csrc`` (timed), and
   of the host batch tokenizer (``csrc/host/tokenize_hash.cc``, ``g++``,
   timed on its own line);
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
   own key first; then 8 fresh rows ride the exact tail and the tail
   upload fails past its 3 attempts (``ivf.tail_upload`` armed): the serve
   must return full resident-only rows flagged ``tail_skipped``, and the
   next serve each tail row's own key first;
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
   plain version on the queries and probes of one 16-query rerank call,
   where its bound is printed too.  Printed: p50 / p90 per mode,
   stage-2 ms per mode, device ms of the MaxSim step and of the packed
   cross-encoder forward, missing-document counts and known-item MRR;
9. scheduler: ``ServeScheduler`` over the phase-8 cascade pipeline
   (window 5,000 us, 16 unique queries per batch), single-query requests
   at concurrency 1, 4 and 16 (``max(32, 12 c)`` each; every 2nd one of
   the 4 hot queries at the head of a pool of 64 eight-word queries, the
   rest from that pool), scheduler off (callers call the pipeline) and on
   (no result cache).  Checked: the rescore kernel agrees with its plain
   version on the queries and probes of a B = 1 and a B = 4 stage-1 call,
   the shapes most of this phase's launches run at;
   every scheduled row has the keys and scores of the same text served
   alone (bf16 trunk: within 3e-2, keys free only between scores tied
   within 3e-2); every batch composition the scheduler formed, served
   again alone, is bit-identical; a coalesced batch books one solo
   serve's dispatches and fetches; no device-to-host sync while the
   c16 arm runs; with the tier-0 cache a second pass hits on every
   request with zero dispatches and rows bit-identical to the first,
   and after a forced absorb nothing stale is served; with the embedding
   cache keys and scores match the fused path and a repeated batch
   encodes nothing; a one-shot stage-1 fault retries to the clean rows,
   a persistent cross-encoder fault opens the breaker and later serves
   come back ``rerank_skipped`` with no stage-2 dispatch, and after the
   reset time serves are clean again.  Printed: queries/s and p50 / p90
   per concurrency and arm, unique queries per batch, dedup rate, the
   card's busy share at c16 with the scheduler on, and queries/s and p50
   at c1 and c16 with the observe layer on and off;
10. decode: the default ``TextGenerator`` (256 wide, 4 layers, 4 heads,
   d_ff 1024, max_length 256, vocab 32768, bf16, seeded init) with a
   ``PrefixKVCache(block=16)``, and an f32 twin of its state dict, on the
   traffic of bench.py phase_continuous_decode / phase_speculative_decode
   (16 prompts, the even half sharing a rerank-style prefix and ending at
   their own 4th greedy token; half the requests sampled at T = 0.8 with
   per-request seeds).  The row kernels (``csrc/decode_rows.cu``) are held
   against their plain versions: the readout within 1e-4 at M = 1, 13,
   16, 32, 256 and 512 rows with the first and last row bit-identical to
   the row alone, the LayerNorm within 1e-5, and the fused residual add +
   LayerNorm ``torch.equal`` to the add then ``layer_norm_rows`` (step and
   prefill shapes, bf16 and f32); each is timed alone (``torch.profiler``)
   and between CUDA events, with L2 cold (rewritten flush; for the
   readout also a read flush) and warm, beside ``F.linear`` /
   ``F.layer_norm``; the host microseconds per wrapper call are printed,
   and the kernels one 16-lane step launches, with the fused LayerNorms
   and with the adds launched apart.  Checked: f32 KV decode == legacy
   re-attend on all 16 prompts;
   every ``ContinuousDecoder`` request (16 slots, chunk 32, width 96) at
   c1 / c4 / c16 == its solo ``generate``, as is every call-level one; no
   device-to-host sync in the c16 step loop; a warm prefix join == a cold
   one with prefill tokens reused; one slot reused over EOS leaves gives
   solo tokens; 16 saturated requests at budget 32, spec_k 16 off and on,
   all == solo, at most 2 + 2 dispatches and fetches per round and 1 + 1
   per plain chunk; 8 requests drafted by the reduced-layer trunk, all ==
   solo; a 32-slot int8 pool under 16 requests: spec-on == spec-off, warm ==
   cold, its K/V bytes within the 16-slot bf16 pool's; the fused LayerNorm
   and the readout launched, the readout from the step, verify and
   prefill programs (launches printed by path and row count).  Printed:
   tokens/s and TTLT p50 / p90 per arm and
   concurrency, slots per chunk, busy share at c16, tokens per lane-round
   and draft sources, bf16-vs-int8 drift, pool bytes, prefill and step
   ms per dispatch;
11. live ingest (bench.py phase_live_ingest): a ``LiveIngestRunner``
   embeds connector commits into the 1M IVF index and the phase-8
   forward index while phase 9's scheduler serves the cascade at c16:
   128 single-query requests, 8 commits of 8 fresh documents 10 ms
   apart, a unique sentinel in the middle commit; then a burst of 2,048
   documents in commits of 64 (past ``absorb_threshold``: an absorb
   writes slabs in place while the MaxSim pipeline serves).  Checked:
   every batch lands, nothing dropped, the generation grew, the
   sentinel is retrievable and its ingest trace kept; stage 1 + MaxSim
   stay within 2 dispatches + 2 fetches per batch under the burst; the
   rescore kernel launched in the drives and agrees with its plain
   version on the absorbed rows' probes; 64 absorbed documents at full
   probe each rank their own key first; under a real freshness burn (a
   paused backlog past 50 ms) ``freshness`` fires, every ``high``
   request is clean and ``low`` ones are shed only with shed on.
   Printed: staleness and serve p50 / p99, ingest docs/s, busy share,
   plane on / off serve p50 per interleaved round;
12. warm state (bench.py ``phase_serve_fabric``'s cold ingest): cold
   bring-up (encode 65,536 documents, ``IvfKnnIndex.add``, first search)
   against a ``WarmStateManager`` snapshot of IVF, forward index, result
   and embedding caches to a ``FileBackend`` restored into fresh
   instances plus a first search.  Checked: 64 queries served
   bit-identically to the writer (fused, embedding-cache and MaxSim
   paths; stage-1 outputs ``torch.equal``), warm faster than cold, a
   corrupted newest chunk restored from the older snapshot and counted
   ``crc``; then the 1M IVF index snapshotted and restored (bytes and
   seconds printed), 64 serves bit-identical;
13. tuning (bench.py ``phase_self_tuning``): phase 9's scheduler over
   the cascade at c16 with the knob table's live coalescing window and a
   result cache, 256 requests of the bench's shifting workload (2/3 of
   the first half on 4 hot queries, then a cold tail over 96), static
   defaults against a background ``Tuner`` ticking every 50 ms, each
   arm after an unmeasured pass.  Checked: every batch books one solo
   serve's dispatches and fetches with the tuner live; every query ranks
   alike in both arms (within 3e-2); ``revert()`` restores
   ``config.snapshot()``, the live tier budgets and the profiler stride;
   an armed ``tuner.adjust`` fault freezes and reverts the tuner.
   Printed: q/s, p50 and p99 per arm, the knob trajectory, the tuned /
   static q/s ratio, and ``config.get`` against a raw environment parse
   as a share of the tuned p50;
14. profiling (bench.py ``phase_profiling_overhead``): the same stack
   with the profiler at stride 1 and a 10 Hz scraper (ledger sample and
   SLO document) against all of it off, 5 alternated pairs; one window
   of that stack, an encode and IVF search of its 32 queries and two
   short decode drives (plain steps, trunk-drafted speculation) under
   ``torch.profiler``; a 262,144 x 384 exact index built for the ledger
   cross-check; the in-place-write guard armed strict over absorbs into
   an index of the encoded documents under c16 stage-1 serves.
   Checked: 2 + 2 per batch at stride 1 (one solo serve's count); device
   time attributed to ``ivf.search``, ``encoder.forward``,
   ``rerank.stage2`` and ``generator.slot_{prefill,step,draft,verify}``;
   the ledger delta within 10% of ``torch.cuda.memory_allocated``'s;
   no violation over the absorbs, and a planted use of a snapshot taken
   before an absorb caught.  Printed: the added p50 with its spread
   (not a gate), the per-callable attribution beside ``torch.profiler``'s
   busy share of the window, the ledger by subsystem.

15. real weights: two checkpoints at the published shapes of
   sentence-transformers' all-MiniLM-L6-v2 and of
   cross-encoder/ms-marco-MiniLM-L-6-v2 (vocab 30,522, hidden 384, 6
   layers x 12 heads, intermediate 1,536, max positions 512; seeded
   N(0, 0.02), LayerNorm 1 / 0; the second with a pooler and one label)
   and a 30,522-line vocab holding every corpus word are written with
   the port's own safetensors writer into a temporary directory; the HF
   ``SentenceEncoder`` (f32) encodes the 65,536 documents (tokenize and
   forward timed apart) into a 1M x 384 IVF index as phase 4's, which
   ``FusedEncodeSearch`` serves in 110 batches of 64; the HF
   ``CrossEncoderModel`` reranks through ``RetrieveRerankPipeline``'s
   host-sorted stage 2 (50 calls of 16 queries, 32 candidates, k = 10),
   and ``ServeScheduler`` serves that pipeline at c1 / c4 / c16 with phase
   9's traffic; then the default ``ClipModel`` encodes 4,096 seeded 64 x
   64 images and their texts, and an ``IvfKnnIndex`` of the image rows is
   searched by the text rows.  Checked: 256 encoded rows against the same
   checkpoint on the CPU within 1e-4; no [UNK] in the corpus; the rescore
   kernel launched once per stage-1 call and equal to its plain version
   at the HF stage-1 and the CLIP search shapes; on the 65,536-row index
   at full probe every document's own key first; each rerank serve 2
   dispatches + 2 fetches (stage 2 ``rerank_stage2_host``) with no flag,
   its scores ``predict()``'s within 1e-5 and its order a stable sort;
   ``encode_token_states`` refused, ``ForwardIndex.add`` counted as a
   failure and a MaxSim pipeline refused, as in the reference; every
   scheduled row the text served alone within 1e-4 (up to candidates
   swapped at a stage-1 tie within 1e-4 at the candidate cut); CLIP card
   against CPU within 3e-2 and its IVF at full probe equal to exact.
16. sharded serve (bench.py ``phase_sharded_serve``): ``ShardedIvfIndex``
   at 8 and at 1 shard over phase 4's 1M rows (8 logical shards
   round-robin over the visible cards: on one card, 8 resident
   partitions), 16 closed-loop single-query callers through
   ``ServeScheduler`` (window 5,000 us, 16 per batch, no result cache),
   192 requests over 64 eight-word queries, one unmeasured pass per arm;
   a ``DeviceKnnIndex`` over an 8-block mesh on the card beside the
   unsharded one; a ``ShardedForwardIndex`` of the 65,536 documents on
   the 8-shard group.  Checked: 8 shards == 1 shard bit for bit at full
   probe in sorted batches of 16; the device tree merge == the host merge;
   the mesh index's rows equal the unsharded index's and its serves agree
   within 1e-6 (keys swapped only at a tie within 1e-6 at the cut,
   counted); the sharded MaxSim table equal to one index's fed the same
   ingest batches; retrieve -> MaxSim at 2 + 2 healthy and with a shard
   down (flagged ``shard_skipped``); ``shard.dispatch.7`` armed over 16
   serves: 16 flagged, 0 errors, then a clean serve; 4,096 fresh rows
   absorbed under serve, each on its owning shard and first at full
   probe; the rescore kernel against its plain version at one shard's
   shape.  Printed: q/s, p50, p99 per arm, the merge's share of a
   16-query serve (device-merge p50 against host-merge p50, 30 serves
   each), dispatch ms per shard, the busy share, the device count.
17. the multi-process plane: (a) the native batch tokenizer's ids equal
   the Python path's on the 65,536 documents and each 64-query batch;
   host ms per batch, native against Python, and stage 1's tokenize
   share; (b) two ranks of this script (``--rank-worker``, torch only)
   join one cluster through ``parallel/distributed.py`` on the one card
   (gloo: the ranks share a device), each with 4 logical shards of one
   8-shard mesh: barrier, broadcast, a faulted broadcast (the local value,
   counted) and ``agree_generation`` on each rank; a ``DeviceKnnIndex`` of
   1,000,000 x 384 seeded unit rows made on the card (4 blocks of 125,000
   rows per rank); top-10 keys and scores of 16 batches of 64 bitwise
   equal across the ranks and to one process's 8-shard mesh; q/s and the
   exchange's ms per search printed with the backend; then ring attention
   at (d)'s shape with the 8 sequence blocks on an ``("sp",)`` mesh
   spanning the ranks (4 each; K/V passed to the next rank by
   ``distributed.ring_shift``, host-staged under gloo), f32 and bf16, full
   and causal, each rank returning the whole output, held in (d) against
   dense attention and the one-process ring (f32 within 1e-4, bf16 within
   3e-2); the ring's ms per call and the shift's bytes and ms per step
   printed per rank; (c)
   ``SentenceEncoder(mesh=...)`` over 8 logical shards against the
   unsharded encoder on 4,096 documents (bf16 within 3e-2, f32 within
   1e-5), docs/s of both; (d) ring attention at B = 1, L = 16,384, 6 heads
   of 64, 8 blocks of 2,048, causal and not, ~20% of keys masked, against
   dense attention (f32 within 1e-4, bf16 within 3e-2), ms of both.
18. the serve fabric: (a) bench.py ``phase_serve_fabric``: 3
   ``FabricWorker``s, each its own ``ServeScheduler`` (window 5,000 us,
   16 per batch, no result cache) over phase 9's cascade on the 1M IVF,
   behind one ``ServeFabric`` (heartbeat 0.1 s, timeout 0.5 s), 16
   closed-loop single-query callers, 96 requests over 32 eight-word
   queries after an unmeasured pass.  Checked: each pool query served
   alone through the fabric == the in-process scheduler bit for bit; 0
   false host-downs on the healthy arm; a worker killed mid-burst: every
   request answered, the affected ones flagged ``host_failover`` with a
   survivor's rows, 0 exceptions, its breaker open; one solo serve's
   dispatches + fetches per batch on the survivors; a ``stop()`` drain
   re-routes; a rolling bounce of all three under 8 callers, each
   replacement restored from the writer's warm state (a
   ``WarmStateManager`` snapshot over a ``MemoryBackend`` of the 65,536
   documents' IVF index, served bit-identically before it joins), 0
   errors, every breaker closed.  (b) ``phase_partitioned_fabric``: phase
   4's 1M rows in 3 partitions (key % 3), each an ``IvfKnnIndex`` with C
   scaled to its rows, ``FusedEncodeSearch`` -> ``ServeScheduler(window
   0)`` -> ``FabricWorker`` with a ``LiveIngestRunner``, beside an H = 1
   fleet.  Checked: H = 3 == H = 1 bit for bit (keys and scores) at full
   probe on 8 whole batches of 16 of phase 5's queries; the scatter booked
   1 logical + 3 physical with the hosts within 2 + 2; one document moves
   only its owner's generation entry, and 1,024 committed through
   ``fabric.connector()`` land on their owners only and are each found
   first by their own text at full probe; an absorb inside an open 1.5 s
   window is served and cached under neither generation; a partition
   killed under c16 costs its keys only (``partition_lost``, 0
   exceptions); the rescore kernel against its plain version at one
   partition's shape.  Printed: q/s, p50, p99 per arm; re-route ms; warm
   against cold replacement seconds; device bytes per partition against
   H = 1's; q/s, p50, p99 and recall@10 against exact at phase 4's probe
   share for H = 1 and H = 3; absorb docs/s at H = 3 and H = 1.
19. the framework, all through ``import pathway_tpu_torch as pw``: one
   ``TpuEmbedder`` at phase 4's width (seeded as phase 4's encoder, bf16)
   shared by two ``DocumentStore``s over the same tables (``splitter=None``):
   phase 4's 65,536 documents as a ``pw.debug.table_from_rows`` with
   ``_metadata = {"path": "d{i % 16}/{i}.txt"}`` and a stream of further
   documents from a ``pw.io.python.ConnectorSubject``; one store on
   ``BruteForceKnnFactory``, one on ``IvfKnnFactory`` at full probe;
   beside them a retracting ``DataIndex.query`` and a
   ``query_as_of_now`` over the IVF store's index.  (a) 4 atomic commits
   of 64 of phase 5's query texts (k = 10) and one of 64 under
   ``filepath_globpattern`` ``d3/*``.  Checked: the first commit's
   documents first in the exact store; the IVF store == the exact store
   rank by rank (ties within 1e-5); the glob commit returns only ``d3/``
   paths in both stores, through ``search_oversampled``; each commit's
   answers == a direct search of each operator's own index on the same
   query vectors; every index on ``cuda``.  (b) 8 commits of 1,024 further
   documents, each after a commit of 64 queries to the two ``DataIndex``
   arms, one of them equal to a document that lands 4 commits later.
   Checked: the retracting arm retracts that query's answer and re-emits
   it with the document first; the as-of-now arm never retracts.  (c) the
   rescore kernel at the framework's shape against its plain version.
   Printed: engine ingest docs/s against the embedder's encode +
   ``IvfKnnIndex.add`` called directly, retrieve ms per commit against
   phase 5's direct serve p50, commit-to-retrievable ms, the busy share.
20. question answering and chat: (a) a ``BaseRAGQuestionAnswerer``
   (``search_topk`` 6) behind ``QASummaryRestServer`` on 127.0.0.1, run by
   ``pw.run`` on a thread at a 10 ms tick: phase 4's encoder as a
   ``TpuEmbedder`` over an IVF ``DocumentStore`` of phase 4's 65,536
   documents (full probe), ``CrossEncoderReranker`` over the default
   ``CrossEncoderModel`` (24 candidates), ``TpuChat(continuous=True)`` over
   the default ``TextGenerator`` (48 new tokens).  ``urllib`` callers ask
   64 of phase 5's query documents: 8 answers at c1, 8 at c16 and a
   profiled burst of 4 at c4, with ``return_context_docs``; 16
   ``/v1/retrieve`` (k = 10), a summary of 4 texts, ``/v1/statistics``
   and ``/v1/pw_list_documents``.  Checked: every route 200 with the
   reference's JSON shape; each operator's searches == a direct search of
   its index; each answer's context == the top 6 of
   ``CrossEncoderModel.predict`` over its 24 candidates (stable order), and
   its response == ``TextGenerator.generate`` of the chat's QA prompt
   called directly (greedy); an unreadable body answered as ``{}``, a
   failing body 500 JSON and the server still up, a GET on a POST route
   405; every model and index on ``cuda``; the rescore, ``tied_readout`` and
   ``add_layer_norm_rows`` launched in the window (the check's direct
   calls run after it, on a stream of their own).  Printed: answer p50 /
   p99 at c1 and c16, answers/s, ``/v1/retrieve`` p50, decode tokens/s,
   the split of a c1 answer, the busy share, the launches, the rescore at
   the QA path's shape.  (b) ``python -m pathway_tpu_torch.cli run`` of
   ``templates/demo_question_answering.yaml`` (its five routes) and
   ``adaptive_rag.yaml`` (an answer) on the card, as the reference's
   template tests check them; without PyYAML the templates' objects are
   built in Python and served through ``cli.serve_config`` in a
   subprocess (``--serve-template NAME PORT``).
21. durable pipelines: (a) phase 19's ``TpuEmbedder`` over phase 4's
   65,536 documents written as 16 JSON-lines files, read by
   ``pw.io.jsonlines.read(mode="static", persistent_id="docs")`` and
   embedded once per delta; a hybrid ``DataIndex`` (``IvfKnnFactory`` at
   full probe + ``TantivyBM25Factory``, reciprocal rank fusion) over
   ``(vector, text)`` and a vector-only one beside it; 4 commits of 64 of
   phase 5's query texts (k = 10) through a persisted ``pw.io.python``
   subject; ``pw.run`` under a filesystem persistence config that
   snapshots every commit.  Then ``pw.reset()`` and run 2 of the same
   graph over the same store with 2 new files and 4 new commits.
   Checked: run 2's reader opens only the 2 new files (the connector's
   monitor counts their rows alone); the indexes hold 73,728 rows, each
   key once; every answer of both runs == a direct search of its
   operator's index, the IVF side == an exact scan, the fused list == an
   RRF of the sub-indexes' searches at 2k; a replayed query's vector answer
   == run 1's answer with the new documents merged in (ties and scores
   within 2e-2: the bf16 rows move with the packed batch); the first run's
   device memory freed by ``pw.reset()`` (within 10%); every index on
   ``cuda``; no snapshot record unpickles a torch class.  (b) this script
   as a worker on the card (``--persist-worker``, 4 files of 1,024
   documents, 64 queries, CSV sinks) killed by SIGKILL after 2 snapshot
   commits, restarted over 2 more files: its sinks == an uninterrupted
   run's, each document indexed once; then a chunk torn by 5 bytes:
   replay stops at the last intact record, every document indexed.  (c)
   ``python -m pathway_tpu_torch.cli replay`` over (b)'s store answers as
   (b)'s finished run.  Printed: cold ingest s, snapshot bytes and ms per
   commit, restart s and restart / cold, hybrid and vector-only retrieve
   ms per commit of 64, the BM25 host ms, the busy share of run 2, the
   rescore at the phase's shape and its launches.

22. time on the card: (a) phase 19's ``TpuEmbedder`` over phase 4's
   65,536 documents, each with an event time at 4,096 per simulated
   hour, streamed in time order in 16 commits of 4,096 through a
   ``pw.io.python`` subject; ``pw.temporal.windowby(tumbling(1 h),
   instance=doc, behavior=common_behavior(cutoff=3 h,
   keep_results=False))`` keeps a document while its window is inside the
   cutoff (16,384 alive at most) and a full-probe IVF ``DataIndex`` indexes
   the alive ones; after each document commit, 64 of phase 5's query
   texts through ``query_as_of_now`` (k = 10).  Checked: every answer ==
   an exact search on the card over the embeddings of the documents alive
   at that commit, rank by rank (ties within 1e-5); no answer holds a
   document past the cutoff; the index's live rows == the alive count
   after every commit; the rescore kernel at the phase's shape (B = 64,
   full probe, the slabs full of removed rows' ``-inf`` bias) against its
   plain version.  Printed: retrieve ms per query commit p50 / p99, the
   windowed chain's host ms per commit (``EngineOperator.process_ns``),
   the index removals' ms per commit, the IVF's retrains, the busy share,
   the rescore alone and between events beside its bound and
   ``baddbmm``.  (b) over the same documents' times: sliding windows (15
   min hop, 1 h) counting documents per topic, an ``asof_join`` of 1,024
   timestamped queries onto their topic's latest window and an
   ``interval_join`` of each with the documents of its last 56.25 s (~64),
   all == a plain Python loop; host ms per commit.  (c) the top-10
   neighbour graph of 1,024 of the documents from an IVF on the card at
   full probe (its rescore launches counted under ``temporal``):
   ``pw.graphs.pagerank`` (5 steps) == a float64 numpy power iteration
   within 1e-9, ``bellman_ford`` (weights 1 - score) == scipy's
   ``shortest_path`` within 1e-9, ``retrieve_prev_next_values`` over the
   documents sorted by time == numpy; seconds per arm;
23. the rest of the host API over an async retrieval path: phase 19's
   ``TpuEmbedder`` encodes phase 4's 65,536 documents into a full-probe
   ``IvfKnnIndex``; a ``ServeScheduler`` over ``FusedEncodeSearch`` on it
   answers (a) 1,024 of phase 5's query texts, arriving in 16 commits of
   64 through ``pw.io.python``, each through a ``pw.AsyncTransformer``
   whose ``invoke`` submits its query to the scheduler and awaits the
   ticket off the event loop, so a commit's invocations coalesce into
   batches.  Checked: every row arrives and the run returns (quiescence);
   every row == a direct search of its query (keys up to ties, scores
   within 2e-2: bf16 rows in another batch); the IVF launched the rescore
   kernel.  (b) the answers through the host API in the same run:
   ``pw.sql`` over the flattened hits (``WHERE`` on score, ``GROUP BY``
   document with ``COUNT(*)`` / ``MAX(score)``, then ``ORDER BY ...
   LIMIT``) == a plain Python count; a ``pw.transformer`` that chases
   each hit's pointer to its query's row == a plain loop; the answers
   through ``export_table``, then ``import_table`` in a fresh graph and
   the same ``pw.sql`` == the exported snapshot's plain count.  Printed:
   answers per second, commit-to-last-answer p50 / p99, the scheduler's
   items per batch, the busy share over (a), (b)'s host ms per commit, and
   the rescore at the phase's shape alone and between events beside its
   bound.

24. the multi-process engine: two ranks of ``pw.run`` through ``python -m
   pathway_tpu_torch.cli spawn`` on the one card, partitioned readers of
   phase 4's documents into a full-probe IVF and a mesh index spanning the
   ranks, queries through the REST front on rank 0, then a kill arm.
25. a CDC feed into a live vector index, through the client-gated
   connectors over fake clients injected into ``sys.modules`` for the
   phase only (the card's machine has no ``boto3``, ``kafka``,
   ``psycopg2`` or ``opentelemetry``): ``pw.io.s3.read`` of 16 JSON-lines
   objects with etag offsets holding phase 4's 65,536 documents; phase
   19's ``TpuEmbedder`` into a full-probe IVF ``DataIndex``;
   ``pw.io.debezium.read`` over a 4-partition Kafka topic streams 1,024
   updates and 1,024 deletes of those documents in 4 commits (its after
   images applied with ``update_rows``; the deletes, which the debezium
   table never held, through a second consumer group's
   ``pw.io.kafka.read`` and ``difference``), each followed by a commit of
   64 queries on a Kafka topic answered as of now (k = 10), half of them
   the commit's updated texts; the answers out through
   ``pw.io.kafka.write`` and ``pw.io.postgres.write_snapshot``; ``pw.run``
   under a monitoring endpoint and a recording ``opentelemetry``.
   Checked: every answer == an exact search on the card over the alive
   documents' embeddings (ties within 1e-5, scores within 1e-4); no
   deleted document returned; the index's rows == the alive count after
   every commit; the Kafka messages and the Postgres statements == a
   plain loop over the answers' update stream; one ``pathway.run`` span
   with the graph's operator and table counts; the rescore launched, and
   equal to its plain version at the phase's shape; every index tensor on
   ``cuda``.  Printed: ingest s, CDC commit to retrievable ms, retrieve
   p50 / p99 per query commit, the rescore alone against its bound, the
   busy share.
26. serve, ingest and decode under the runtime lock-order sanitizer, in a
   fresh interpreter (``--analysis-worker OUT``, this script) started with
   ``PATHWAY_LOCK_SANITIZER=1``, ``PATHWAY_LOCK_SANITIZER_RAISE=1``,
   ``PATHWAY_DONATION_GUARD=1`` and ``PATHWAY_DONATION_GUARD_STRICT=1``;
   its nonzero exit fails the run.  (a) phase 4's encoder over the 65,536
   documents into a full-probe ``IvfKnnIndex``; a ``ServeScheduler`` over
   ``FusedEncodeSearch`` (k = 10) takes 256 single-query requests over 64
   queries from 16 closed-loop callers while a second thread commits
   1,024 fresh documents (32 of them copies of query texts) after the
   64th answer, absorbed in the background: every answer == a direct
   search of its query against the index before the commit or after it
   (keys up to ties, scores within 2e-2), and the rescore kernel launched
   and equal to its plain version at the phase's shape.  (b) a
   ``ContinuousDecoder`` burst of the 16 greedy prompts on the default
   ``TextGenerator`` == solo ``generate``, with ``add_layer_norm_rows``
   and ``tied_readout`` launched and held against their plain versions.
   (c) no violation of either tripwire, locks tracked and edges observed,
   every runtime edge consistent with the declared ranks, and the edges
   the static lock graph (``analysis/lock_order.py``) lacks printed.  (d)
   32 scheduler batches under ``torch.cuda.set_sync_debug_mode("warn")``:
   each sync the mode reports lies in a function the hidden-sync rule
   counts as a booked or waived fetch; syncs per batch printed beside the
   fetches ``ops/dispatch_counter.py`` booked.  The static analysis runs
   in this process beside the worker.

27. the native host runtime (``csrc/host/native_io.cc``), then a CSV-fed
   index.  (a) on this host, in turns native, plain, plain, native, each
   native result equal to the plain one: ``native.csv_rows`` against the
   ``csv`` module over phase 4's 65,536 documents written as 16 CSV files
   of ``doc_id,text,score`` (texts with commas, doubled quotes and
   newlines; one file with CRLF endings); ``parse_int64`` /
   ``parse_float64`` against their plain versions over the id and score
   cells; ``crc32`` against ``zlib.crc32`` and ``frame_scan`` against
   ``scan_views`` over a 256 MiB blob in ``warmstate.chunk_bytes`` frames,
   framing those chunks by either CRC; then 65,536 event frames framed by
   either CRC and scanned by ``framing.scan`` against ``scan_views`` with
   copies.  (b) the first 4 files (16,384 documents) through
   ``pw.io.fs.read(format="csv")``, phase 19's ``TpuEmbedder`` into a
   full-probe IVF ``DataIndex``, 4 query commits of 64 through
   ``pw.io.python`` (k = 10, 10 ms tick).  Checked: the engine's rows ==
   the ``csv`` module's rows of the same files; every answer == an exact
   search on the card over the documents' embeddings (ties within 1e-5,
   scores within 1e-4); the rescore launched, and equal to its plain
   version at the phase's shape; every index tensor on ``cuda``.

28. the reference's public surface.  (a) filtered exact search on phase
   4's 1,000,000 x 384 ``DeviceKnnIndex``: 64 queries (encoded
   documents), k = 10, half with an allow-list of 1,000 keys holding
   their unfiltered top 5 and half with ``None``; each row == the
   unfiltered top 10 filtered by its list; then 64 of the returned keys
   removed and searched for again: none comes back, filtered or not (the
   rows are put back after).  (b) ``ServeScheduler`` over
   ``FusedEncodeSearch`` on the IVF index serves 64 requests from 16
   callers, every request traced (each == the direct serve within 3e-2),
   and one with an expired deadline (kept by the tail sampler); a
   4-prompt x 8-token ``ContinuousDecoder`` burst; then
   ``start_metrics_server`` answers ``GET /metrics`` classic
   (``version=0.0.4``, no exemplar token) and OpenMetrics (exemplars on
   bucket samples only, each naming a kept trace), ``/serve_stats`` with
   the ``generators`` and ``slo`` columns and ``/slo``; the rescore and
   the decode-row kernels launched.  ``python -m pathway_tpu_torch.config
   --format markdown``, run in a subprocess beside (a) and (b), prints
   ``markdown_table()``.

Every shape-census tripwire runs strict from the start
(``PATHWAY_RECOMPILE_STRICT=1``); after phase 28 none may have tripped.

The card's name and power limit, then the JSON record of the kernels,
then ``{"ok": true, "device": {...}}`` are the last three lines; the
seconds the whole run took are printed before them.
Without CUDA, or without the package beside it, the script fails before
printing any result.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import types

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
SCHED_CONC = (1, 4, 16)  # phase 9: concurrent callers
SCHED_WINDOW_US = 5000.0
SCHED_MAX_BATCH = 16
SCHED_TOL = 3e-2  # bf16 trunk: a query in another batch bucket moves its scores
TICKET_TIMEOUT_S = 120.0

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


def rescore_bound(distinct: int, M: int, d_pad: int, elem: int, B: int, p: int):
    """(bound ms, what bounds it, bytes) of one rescore launch: each probed
    slab and its bias row read once, q and probe read once, the output
    written once; f32 FLOPs at the f32 rate outside the tensor cores."""
    n_bytes = distinct * M * (d_pad * elem + 4) + B * d_pad * 4 + B * p * 4 + B * p * M * 4
    n_ops = 2 * B * p * M * d_pad
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", n_bytes


def stage1_rescore_args(retriever, ivf, texts):
    """The rescore kernel's inputs of one IVF stage-1 call over ``texts``,
    made by the retriever's own steps (bucketed batch, trunk, probes,
    padded queries) without launching the kernel: ``(probe, zq, slabs,
    bias)``."""
    from pathway_tpu_torch.ops.knn import _bucket

    ids, mask = retriever.encoder.tokenizer.encode_batch(texts)
    pad = np.zeros((_bucket(len(ids)) - len(ids), ids.shape[1]), ids.dtype)
    with torch.no_grad():
        z, _ = retriever._embed(np.concatenate([ids, pad]), np.concatenate([mask, pad]))
        probe = torch.topk(z @ ivf._centroids.t(), ivf.probe_count(), dim=1).indices.to(torch.int32)
        zq = torch.nn.functional.pad(z, (0, ivf._d_pad - z.shape[1])).contiguous()
    return probe, zq, ivf._slabs, ivf._bias


def rescore_at_path_shape(ivf, args, dev):
    """Kernel vs plain version, device time and bound of the rescore at
    one path's own inputs ``args`` (f32 slabs)."""
    from pathway_tpu_torch.ops.ivf_rescore import ivf_rescore_reference, rescore_shortlist

    probe, zq = args[0], args[1]
    with torch.no_grad():
        err = compare_rescore(rescore_shortlist, ivf_rescore_reference, *args)
        flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        ms = timed_ms(lambda: rescore_shortlist(*args), reps=20, flush=flush)
        library_ms, library_gather_ms = library_rescore_ms(ivf, probe, zq, flush)
        # the two kernels alone (probe inversion + rescore), L2 cold: the
        # event window above also holds any host gap before the launch.
        # Each kernel's mean over the launches the profiler kept (it can
        # drop some of a window's events, never add any)
        ours = [
            (us, n) for key, us, n in profiled_kernels(lambda: rescore_shortlist(*args), 20, flush)
            if "rescore_kernel" in key or "invert_probe_kernel" in key
        ]
        del flush
    kernels_ms = sum(us / n for us, n in ours) / 1e3 if ours else None
    traced = min(n for _, n in ours) if ours else 0
    distinct = int(torch.unique(probe).numel())
    bound_ms, bound_by, n_bytes = rescore_bound(distinct, ivf._M_pad, zq.shape[1], 4, probe.shape[0], probe.shape[1])
    return {
        "max_abs_err": err, "ms": ms, "kernels_ms": kernels_ms, "traced": traced, "bound_ms": bound_ms,
        "bound_by": bound_by,
        "distinct_clusters": distinct, "bytes": n_bytes, "B": probe.shape[0], "p": probe.shape[1],
        "library_ms": library_ms, "library_with_gather_ms": library_gather_ms,
    }


def library_rescore_ms(ivf, probe, q, flush):
    """The library's rescore at these probes, L2 cold: ``baddbmm`` over
    slabs and bias gathered beforehand (gather not timed), and gather +
    ``baddbmm`` together."""
    B, p = probe.shape
    M, d_pad = ivf._M_pad, ivf._d_pad
    pl = probe.long()
    qcol = q.reshape(B, -1, 1)

    def gather_baddbmm():
        return torch.baddbmm(ivf._bias[pl].reshape(B, p * M, 1), ivf._slabs[pl].reshape(B, p * M, d_pad), qcol)

    rows = ivf._slabs[pl].reshape(B, p * M, d_pad)
    bias_g = ivf._bias[pl].reshape(B, p * M, 1)
    library_ms = timed_ms(lambda: torch.baddbmm(bias_g, rows, qcol), reps=5, flush=flush)
    del rows, bias_g
    return library_ms, timed_ms(gather_baddbmm, reps=5, flush=flush)


def rescore_line(ivf, r) -> str:
    return (
        f"B={r['B']} p={r['p']} C={ivf._centroids.shape[0]} M={ivf._M_pad} d={ivf._d_pad} f32 slabs, "
        f"{r['distinct_clusters']} distinct clusters probed: max_abs_err={r['max_abs_err']:.3e}, "
        f"kernel {r['ms']:.4f} ms between CUDA events, "
        + (f"its 2 kernels alone {r['kernels_ms']:.4f} ms (mean over the {r['traced']} of 20 calls traced), "
           if r["kernels_ms"] is not None else "its kernels alone not measured, ")
        + f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e9:.4f} GB); baddbmm over slabs gathered "
        f"beforehand {r['library_ms']:.4f} ms, gather + baddbmm {r['library_with_gather_ms']:.4f} ms"
    )


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


def profiled_kernels(fn, reps: int, flush: torch.Tensor | None = None, clean: bool = False):
    """``(kernel name, device us, launches)`` of ``reps`` calls of ``fn``
    (``torch.profiler``), after one call outside the window.  With
    ``flush`` each call starts with L2 cold: the buffer is rewritten
    (``zero_``: L2 left full of dirty lines, whose write-back then shares
    the device memory with ``fn``) or, with ``clean``, read (``sum``: L2
    left full of clean lines); the flush kernels are left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.sum() if clean else flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        key = e.key.lower()
        if flush is not None and ("fill" in key or "at::native::reduce_kernel" in key):
            continue
        out.append((key, getattr(e, "self_device_time_total", 0.0), e.count))
    return out


def counted_kernels(fn, reps: int, flush: torch.Tensor | None = None, clean: bool = False,
                    include: str | None = None, exclude: tuple = ()):
    """(device us, launches) of the kernels of ``profiled_kernels`` whose
    names contain ``include`` (every kernel when None) and none of
    ``exclude``.  The profiler can drop the events of a window, never add
    any, and each call launches at least one kernel: a window that counts
    fewer than ``reps`` launches is measured again (3 windows at most),
    and the one that counts the most is kept."""
    best = (-1, 0.0)
    for _ in range(3):
        kept = [
            (us, n) for key, us, n in profiled_kernels(fn, reps, flush, clean)
            if (include is None or include in key) and not any(x in key for x in exclude)
        ]
        best = max(best, (sum(n for _, n in kept), sum(us for us, _ in kept)))
        if best[0] >= reps:
            break
    return best[1], best[0]


def kernel_time(fn, reps: int):
    """Device time of ``fn``'s kernels alone, without the gaps between
    them: (ms per call, kernel launches per call)."""
    us, launches = counted_kernels(fn, reps)
    return us / 1e3 / reps, launches / reps


def alone_ms(fn, reps: int, flush: torch.Tensor | None = None, include: str | None = None,
             exclude: tuple = (), clean: bool = False) -> float:
    """Device ms per call of ``fn``'s kernels alone (``counted_kernels``)."""
    return counted_kernels(fn, reps, flush, clean, include, exclude)[0] / 1e3 / reps


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


def forward_and_cross_encoder(encoder, docs, keys):
    """Phase 8's stage-2 models: the forward index of the 65,536
    documents (16 int8 rows each) and the cross-encoder; returns (forward
    index, cross-encoder, ingest seconds)."""
    from pathway_tpu_torch.index import ForwardIndex
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel

    fwd = ForwardIndex(encoder, tokens_per_doc=16, quant="int8")
    t0 = time.perf_counter()
    for i in range(0, N_DOCS, FWD_CHUNK):
        fwd.add(keys[i : i + FWD_CHUNK], docs[i : i + FWD_CHUNK])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ce = CrossEncoderModel(
        dimension=256, n_layers=4, n_heads=4, max_length=256, vocab_size=32768,
        seed=SEED + 1, dtype=torch.bfloat16,
    )
    return fwd, ce, ingest_s


def rerank_phase(encoder, ivf, docs, keys, tag: str):
    """Forward-index ingest, then the three rerank modes over the 1M IVF
    index; returns the rescore launches of the timed rerank calls, a
    record of the rescore kernel at this path's shape (max abs error
    against its plain version, time, bound) and the cascade pipeline."""
    from pathway_tpu_torch.ops import dispatch_counter
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.maxsim import maxsim_scores_host, maxsim_topk
    from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    dev = torch.device(DEVICE)
    fwd, ce, ingest_s = forward_and_cross_encoder(encoder, docs, keys)
    if len(fwd) != N_DOCS:
        raise AssertionError(f"forward index holds {len(fwd)} of {N_DOCS} docs")
    log(
        f"forward index: {N_DOCS} docs ingested in {ingest_s:.2f} s ({N_DOCS / ingest_s:.0f} docs/s incl. "
        f"host tokenize + encode), T'={fwd.tokens_per_doc} int8, {fwd.hbm_bytes() / 1e6:.1f} MB on the card "
        f"(capacity {fwd._capacity}), compression {fwd.compression_ratio():.2f}x, "
        f"audit |MaxSim f32 - int8| {fwd._quant_abs_err:.5f} {tag}"
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
    # version: the queries and probes of one 16-query stage-1 call
    # (outside the counted window)
    rr_kernel = rescore_at_path_shape(ivf, stage1_rescore_args(modes["maxsim"].retriever, ivf, calls[0]), dev)
    log(f"kernel ivf_rescore vs plain at the rerank stage-1 shape {rescore_line(ivf, rr_kernel)} {tag}")

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
    return rr_launches, rr_kernel, modes, fwd

class RecordingTarget:
    """Forwards the scheduler's batches to a pipeline and keeps each
    batch's text list, ``k`` and result, so a batch can be served again
    alone (the bit-identity check)."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.k = pipe.k
        self.batches = []
        self._lock = threading.Lock()

    def index_generation(self):
        return self.pipe.index_generation()

    def _default_deadline(self):
        return self.pipe._default_deadline()

    def submit(self, texts, k=None, deadline=None, n_requests=1):
        handle = self.pipe.submit(texts, k, deadline=deadline, n_requests=n_requests)
        record = [list(texts), k, None]
        with self._lock:
            self.batches.append(record)

        def complete():
            record[2] = handle()
            return record[2]

        complete.advance = handle.advance
        return complete


def drive(serve_one, reqs, conc: int):
    """``conc`` closed-loop callers share ``reqs`` (caller t takes every
    conc-th request from t); returns (queries/s, latencies ms, rows)."""
    n = len(reqs)
    lats = [None] * n
    rows = [None] * n
    errors = []
    barrier = threading.Barrier(conc)

    def worker(t: int):
        try:
            barrier.wait(timeout=60)
            for i in range(t, n, conc):
                t0 = time.perf_counter()
                rows[i] = serve_one(reqs[i])
                lats[i] = (time.perf_counter() - t0) * 1e3
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(conc)]
    t_all = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    elapsed = time.perf_counter() - t_all
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"scheduler drive c{conc}: {errors[:3]} (alive: {sum(t.is_alive() for t in threads)})")
    return n / elapsed, np.asarray(lats, np.float64), rows


def scheduler_phase(encoder, ivf, docs, pipe, tag: str):
    """Phase 9: the serve front over the cascade pipeline; returns the
    rescore launches of its counted drives and the rescore kernel's
    records at the B = 1 and B = 4 stage-1 shapes those drives launch
    most."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch import observe
    from pathway_tpu_torch.cache import EmbeddingCache, ResultCache
    from pathway_tpu_torch.ops import dispatch_counter
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.robust import CircuitBreaker, inject
    from pathway_tpu_torch.serve import ServeScheduler

    # the traffic of bench.py phase_concurrent_serve: the 4 hot queries
    # are the head of the pool
    pool = [" ".join(docs[(i * 9973) % N_DOCS].split()[:8]) for i in range(64)]
    hot = pool[:4]

    def workload(n: int):
        return [hot[i % 4] if i % 2 == 0 else pool[(i * 7) % 64] for i in range(n)]

    # warm the shapes both arms touch: each query alone, and coalesced
    # compositions of every unique count a batch can hold
    solo = {q: pipe([q], K) for q in pool}
    for b in range(2, SCHED_MAX_BATCH + 1):
        pipe(sorted(set(workload(3 * b)))[:b], K)
    with dispatch_counter.DispatchCounter() as counter:
        pipe([pool[0]], K)
    per_serve = (counter.dispatches, counter.fetches)

    def scheduler(target, cache=None):
        return ServeScheduler(
            target, window_us=SCHED_WINDOW_US, max_batch=SCHED_MAX_BATCH, result_cache=cache
        )

    def on_arm(sched):
        return lambda q: sched.submit([q], K).result(timeout=TICKET_TIMEOUT_S)

    # -- the counted drives: scheduler off and on per concurrency --------------
    rescore_shortlist.launches = 0
    stage1_batches = 0
    lines = []
    recorder = RecordingTarget(pipe)
    checked_rows = 0
    for conc in SCHED_CONC:
        reqs = workload(max(32, 12 * conc))
        cell = {}
        for arm in ("off", "on"):
            for measured in (False, True):  # an unmeasured pass first: warm compositions
                sched = scheduler(recorder if arm == "on" else pipe) if arm == "on" else None
                serve_one = on_arm(sched) if sched is not None else (lambda q: pipe([q], K))
                try:
                    with dispatch_counter.DispatchCounter() as counter:
                        qps, lats, rows = drive(serve_one, reqs, conc)
                finally:
                    if sched is not None:
                        sched.stop()
                stage1_batches += sum(1 for kind, t in counter.events if kind == "dispatch" and t == "serve_ivf")
                if not measured:
                    continue
                for q, got in zip(reqs, rows):
                    if got.degraded or not same_ranking(solo[q][0], got[0], tie=SCHED_TOL, atol=SCHED_TOL):
                        raise AssertionError(f"c{conc} {arm}: {q!r} got {got[0][:4]} {got.degraded}, alone {solo[q][0][:4]}")
                checked_rows += len(rows)
                cell[arm] = (qps, float(np.percentile(lats, 50)), float(np.percentile(lats, 90)))
                if sched is not None:
                    st = dict(sched.stats)
                    n_batches = st["batches"] + st["solo"]
                    if (counter.dispatches, counter.fetches) != (per_serve[0] * n_batches, per_serve[1] * n_batches):
                        raise AssertionError(
                            f"c{conc}: {counter.dispatches} dispatches + {counter.fetches} fetches for "
                            f"{n_batches} batches; one serve books {per_serve}"
                        )
                    cell["unique"] = st["items_dispatched"] / max(st["batches"], 1)
                    cell["dedup"] = st["dedup_hits"] / max(st["items"], 1)
                    cell["batches"] = st["batches"]
        lines.append(
            f"c{conc} ({len(reqs)} requests): off {cell['off'][0]:.1f} q/s p50 {cell['off'][1]:.3f} ms "
            f"p90 {cell['off'][2]:.3f} ms; on {cell['on'][0]:.1f} q/s p50 {cell['on'][1]:.3f} ms "
            f"p90 {cell['on'][2]:.3f} ms, {cell['batches']} batches, {cell['unique']:.2f} unique queries "
            f"per batch, dedup rate {cell['dedup']:.3f}"
        )
    launches = rescore_shortlist.launches
    if launches != stage1_batches:
        raise AssertionError(f"{launches} rescore launches for {stage1_batches} stage-1 batches")
    log(
        f"scheduler over the cascade (window {SCHED_WINDOW_US:.0f} us, max_batch {SCHED_MAX_BATCH}, no result "
        f"cache; host clock per request) {tag}: " + "; ".join(lines)
        + f"; {checked_rows} scheduled rows match their text served alone within {SCHED_TOL}; "
        f"{per_serve[0]} dispatches + {per_serve[1]} fetches per batch as per solo serve; "
        f"rescore launches {launches} (1 per stage-1 batch)"
    )

    # -- the rescore kernel at the shapes of those launches, against its plain
    # version: the scheduler-off arms serve one query (bucket B = 1), the c4
    # batches up to 4 unique queries (bucket B = 4); outside the counted drives
    sched_kernel = []
    for texts in ([hot[0]], sorted(hot)):
        r = rescore_at_path_shape(ivf, stage1_rescore_args(pipe.retriever, ivf, texts), torch.device(DEVICE))
        log(f"kernel ivf_rescore vs plain at the scheduler's stage-1 shape {rescore_line(ivf, r)} {tag}")
        sched_kernel.append(r)

    # -- the observe layer's own cost: scheduler on at c1 and c16 with the
    # recorder (histograms, traces at sample 1.0, events) on and off,
    # passes alternated on, off, off, on, on, off
    observe_was = observe.snapshot()["enabled"]
    cost = []
    for conc in (1, 16):
        reqs = workload(max(32, 12 * conc))
        runs = {True: [], False: []}
        for enabled in (True, False, False, True, True, False):
            observe.set_enabled(enabled)
            sched = scheduler(pipe)
            try:
                qps, lats, _ = drive(on_arm(sched), reqs, conc)
            finally:
                sched.stop()
                observe.set_enabled(observe_was)
            runs[enabled].append((qps, float(np.percentile(lats, 50)), sched.stats["batches"] + sched.stats["solo"]))
        for enabled, name in ((True, "on"), (False, "off")):
            qps, p50, batches = np.mean(runs[enabled], axis=0)
            cost.append(
                f"c{conc} observe {name}: {qps:.1f} q/s p50 {p50:.3f} ms, {batches:.1f} batches per pass "
                f"(p50 per pass {[round(r[1], 3) for r in runs[enabled]]})"
            )
    log(f"observe cost, scheduler on, 3 passes per setting of 32 (c1) / 192 (c16) requests {tag}: " + "; ".join(cost))

    # -- bit identity: every composition served again alone --------------------
    compositions = [b for b in recorder.batches if b[2] is not None]
    for texts, k, result in compositions:
        again = pipe.submit(texts, k)()
        if list(again) != list(result) or again.degraded != result.degraded:
            raise AssertionError(f"batch of {len(texts)} served again differs from the scheduled serve")
    log(f"scheduler bit identity {tag}: {len(compositions)} batch compositions served again alone, all bit-identical")

    # -- device busy share at c16, and no hidden host sync ---------------------
    reqs = workload(12 * 16)
    sched = scheduler(pipe)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive(on_arm(sched), reqs, 16)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        sched.stop()
    dev_ms = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ) / 1e3
    busy = f"{100 * dev_ms / wall_ms:.1f}% busy" if dev_ms > 0 else "device time not measured (no CUDA events traced)"
    sched = scheduler(pipe)
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            drive(on_arm(sched), reqs, 16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        sched.stop()
    syncs = [str(w.message)[:120] for w in caught if "synchroniz" in str(w.message).lower()]
    log(
        f"scheduler c16 {tag}: device kernels {dev_ms:.3f} ms in a {wall_ms:.3f} ms wall ({busy}); "
        f"{len(syncs)} device-to-host syncs under set_sync_debug_mode"
    )
    if syncs:
        raise AssertionError(f"hidden host sync on the scheduled serve path: {syncs[:3]}")

    # -- tier-0 result cache -----------------------------------------------------
    reqs = workload(12 * 16)
    cache = ResultCache()
    sched = scheduler(pipe, cache)
    try:
        _, _, first = drive(on_arm(sched), reqs, 16)
        hits0 = sched.stats["cache_hits"]
        with dispatch_counter.DispatchCounter() as counter:
            _, _, second = drive(on_arm(sched), reqs, 16)
        by_text = {}
        for q, row in zip(reqs, first):
            by_text.setdefault(q, []).append(list(row))
        if sched.stats["cache_hits"] - hits0 != len(reqs) or counter.dispatches or counter.fetches:
            raise AssertionError(
                f"cached pass: {sched.stats['cache_hits'] - hits0}/{len(reqs)} hits, {counter.dispatches} dispatches"
            )
        if any(list(row) not in by_text[q] for q, row in zip(reqs, second)):
            raise AssertionError("a cached row differs from every row the filling pass served for its text")
        gen0 = ivf.generation
        fresh = [t + " absorbed again" for t in corpus(ivf.absorb_threshold, seed=SEED + 11)]
        with torch.no_grad():
            fresh_vecs = torch.cat(
                [encoder.encode_to_device(fresh[i : i + ENCODE_CHUNK]) for i in range(0, len(fresh), ENCODE_CHUNK)]
            ).cpu().numpy()
        ivf.add([(1 << 62) + (1 << 20) + i for i in range(len(fresh))], fresh_vecs)
        wait_maintenance(ivf)
        hits1 = sched.stats["cache_hits"]
        with dispatch_counter.DispatchCounter() as counter:
            after = [on_arm(sched)(q) for q in hot]
        stale = [r.meta.get("index_generation") for r in after if r.meta.get("index_generation") != ivf.generation]
        if sched.stats["cache_hits"] != hits1 or counter.dispatches == 0 or stale or ivf.generation <= gen0:
            raise AssertionError(f"after the absorb: hits {sched.stats['cache_hits'] - hits1}, stale {stale}")
    finally:
        sched.stop()
    log(
        f"tier-0 result cache {tag}: second pass of {len(reqs)} requests all hits, 0 dispatches, rows bit-identical "
        f"to the filling pass; absorb of {len(fresh)} rows moved the generation {gen0} -> {ivf.generation}, "
        f"no stale row served ({counter.dispatches} dispatches for {len(hot)} requests after it)"
    )

    # -- tier-1 embedding cache --------------------------------------------------
    texts = pool[16:32]
    plain = FusedEncodeSearch(encoder, ivf, k=RR_CANDIDATES, embed_cache=None)(texts)
    cached_serve = FusedEncodeSearch(encoder, ivf, k=RR_CANDIDATES, embed_cache=EmbeddingCache())
    got = cached_serve(texts)
    if not all(same_ranking(w, g, tie=SCHED_TOL, atol=SCHED_TOL) for w, g in zip(plain, got)):
        raise AssertionError("embedding-cache serve differs from the fused path")
    with dispatch_counter.DispatchCounter() as counter:
        again = cached_serve(texts)
    if (counter.dispatches, counter.physical_dispatches) != (1, 1) or list(again) != list(got):
        raise AssertionError(f"repeated batch: {counter.physical_dispatches} launches, equal {list(again) == list(got)}")
    retries = observe.counter("pathway_robust_retries_total", site="serve.dispatch")
    r0 = retries.value
    with inject.armed("serve.dispatch", "raise", times=1):
        faulted = FusedEncodeSearch(encoder, ivf, k=RR_CANDIDATES, embed_cache=EmbeddingCache())(texts)
    if list(faulted) != list(got) or retries.value - r0 != 1:
        raise AssertionError(f"serve.dispatch fault: equal {list(faulted) == list(got)}, retries {retries.value - r0}")
    log(
        f"tier-1 embedding cache {tag}: {len(texts)} queries match the fused path within {SCHED_TOL}; the repeated "
        f"batch is 1 launch (search only); a one-shot serve.dispatch fault retried once to the same bits"
    )

    # -- faults through the scheduler --------------------------------------------
    sched = scheduler(pipe)
    breaker = CircuitBreaker("cross_encoder.scheduler-phase", reset_s=1.0)
    saved, pipe._breaker = pipe._breaker, breaker
    try:
        q = hot[0]
        clean = on_arm(sched)(q)
        retries = observe.counter("pathway_robust_retries_total", site="ivf.dispatch")
        r0 = retries.value
        with inject.armed("ivf.dispatch", "raise", times=1):
            got = on_arm(sched)(q)
        if list(got) != list(clean) or got.degraded or retries.value - r0 != 1:
            raise AssertionError(f"ivf.dispatch fault: equal {list(got) == list(clean)}, retries {retries.value - r0}")
        with inject.armed("rerank.dispatch", "raise"):
            served = 0
            while breaker.state != "open":
                served += 1
                if served > breaker.failure_threshold or on_arm(sched)(q).degraded != ("rerank_skipped",):
                    raise AssertionError(f"breaker still {breaker.state} after {served} faulted serves")
            fired = inject.fired_count("rerank.dispatch")
            with dispatch_counter.DispatchCounter() as counter:
                skipped = [on_arm(sched)(q) for _ in range(4)]
            if any(r.degraded != ("rerank_skipped",) for r in skipped) or inject.fired_count("rerank.dispatch") != fired:
                raise AssertionError("an open breaker still reached the cross-encoder")
            if any(t == "rerank_stage2" for _, t in counter.events):
                raise AssertionError("an open breaker still dispatched stage 2")
        time.sleep(breaker.reset_s + 0.1)
        after = on_arm(sched)(q)
        if after.degraded or breaker.state != "closed" or list(after) != list(clean):
            raise AssertionError(f"after the reset: {after.degraded}, breaker {breaker.state}")
    finally:
        pipe._breaker = saved
        sched.stop()
    log(
        f"scheduler faults {tag}: one-shot ivf.dispatch fault retried once to the clean rows; persistent "
        f"rerank.dispatch fault opened the breaker after {served} serves ({breaker.failure_threshold} failures), "
        f"then 4 serves rerank_skipped with {fired} fault firings and no stage-2 dispatch; clean again "
        f"{breaker.reset_s} s after disarming"
    )
    return launches, sched_kernel


DEC_SLOTS = 16  # phase 10: the engine of bench.py phase_continuous_decode
DEC_BUCKET = 32
DEC_WIDTH = 96
DEC_BUDGET = 32
DEC_CONC = (1, 4, 16)
DEC_REQS = {1: 2, 4: 4, 16: 16}  # the call-level arm serializes on the host (c1 / c4 cut from 4 / 8 for phase 24)
DEC_C16_REQS = 16  # the busy-share and sync-debug drives (64 before phase 24, 32 before phase 26; cut for each)
SPEC_K = 16  # phase_speculative_decode
SPEC_BUDGET = 32  # new tokens per speculative and int8 request (64 before phase 28: the script's time)
SPEC_REQS = 16  # the bench saturates 256; cut with SPEC_TRUNK_REQS and I8_REQS to keep the script's time (32 before phase 26)
SPEC_TRUNK_REQS = 8  # requests drafted by the reduced-layer trunk
I8_SLOTS = 32
I8_REQS = 16  # half the int8 pool's slots (one request per slot, 32, before phase 26)
SAMPLE_TEMP = 0.8
LN_ATOL = 1e-5  # f32 statistics summed in another order than torch's mean
READOUT_ATOL = 1e-4  # f32 dot products of 256 terms in another order
_SHARED = (
    "rerank the following passages for the query about incremental "
    "dataflow serving latency and freshness guarantees "
)
_TOPICS = (
    "vector index maintenance", "stream joins", "exactly once",
    "window aggregation", "kafka offsets", "snapshot replay",
    "sharded state", "commit ticks", "mesh collectives",
    "tokenizer ingest", "cross encoders", "packing rows",
)


def decode_prompts():
    """The 16 prompts of bench.py phase_continuous_decode: the even half
    shares the rerank-style prefix."""
    return [
        (_SHARED if i % 2 == 0 else "standalone question about ") + _TOPICS[i % len(_TOPICS)] + f" variant {i}"
        for i in range(16)
    ]


def host_us(fn, reps: int = 200, repeats: int = 7) -> float:
    """Host microseconds per call of ``fn`` (the launch path, no device
    wait inside a timed loop): the least of ``repeats`` loops of ``reps``
    calls, each followed by a synchronize, since the host is shared."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / reps * 1e6


def rows_host_line(decode_rows, d: int, dev) -> str:
    """Host microseconds per call of the row kernels' wrappers at the decode
    step's shapes ([16, 1, d] bf16 LayerNorm, [16, d] readout over a
    [32768, d] f32 table); with the fused entry when the module has it."""
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = (torch.randn(DEC_SLOTS, 1, d, generator=g, device=dev) * 3).to(torch.bfloat16)
    delta = torch.randn(DEC_SLOTS, 1, d, generator=g, device=dev).to(torch.bfloat16)
    w, b = torch.rand(d, generator=g, device=dev) + 0.5, torch.randn(d, generator=g, device=dev) * 0.1
    table = torch.randn(32768, d, generator=g, device=dev) * 0.02
    h = x[:, 0]
    parts = [
        f"layer_norm_rows {host_us(lambda: decode_rows.layer_norm_rows(x, w, b, torch.bfloat16)):.2f} us",
        f"x + delta then layer_norm_rows {host_us(lambda: decode_rows.layer_norm_rows(x + delta, w, b, torch.bfloat16)):.2f} us",
        f"tied_readout {host_us(lambda: decode_rows.tied_readout(h, table)):.2f} us",
    ]
    if hasattr(decode_rows, "add_layer_norm_rows"):
        parts.append(
            f"add_layer_norm_rows {host_us(lambda: decode_rows.add_layer_norm_rows(x, delta, w, b, torch.bfloat16)):.2f} us"
        )
    return "; ".join(parts)


def engine_c16_line() -> str:
    """Decode tokens/s of the default generator's engine (16 slots, chunk
    32, width 96) under 16 closed-loop callers: 3 passes of 64 requests
    (budget 32, half sampled at T = 0.8) after a 32-request warm-up."""
    from pathway_tpu_torch.cache import PrefixKVCache
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.serve import ContinuousDecoder

    gen = TextGenerator(kv_cache=PrefixKVCache(block=16), eos_id=None, seed=2)
    with torch.no_grad():
        step_us = {mode: host_us(lambda: fn(*args), reps=20, repeats=5)
                   for mode in ("greedy", "sampled") for fn, args in [step_program(gen, gen.device, mode == "greedy")]}
    prompts = decode_prompts()
    reqs = list(range(DEC_C16_REQS))
    eng = ContinuousDecoder(gen, slots=DEC_SLOTS, step_bucket=DEC_BUCKET, kv_width=DEC_WIDTH, name="smoke-compare")

    def one(j):
        temp = SAMPLE_TEMP if j % 4 in (2, 3) else 0.0
        return eng.submit(prompts[j % len(prompts)], max_new_tokens=DEC_BUDGET, temperature=temp,
                          seed=j % len(prompts)).result(timeout=TICKET_TIMEOUT_S)

    try:
        drive(one, reqs[:32], 16)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, _, outs = drive(one, reqs, 16)
            rates.append(sum(len(str(o).split()) for o in outs) / (time.perf_counter() - t0))
    finally:
        eng.stop()
    return (f"host us per 16-lane step {step_us['greedy']:.1f} greedy, {step_us['sampled']:.1f} sampled; "
            f"{len(reqs)} requests, budget {DEC_BUDGET}, tokens/s per pass " + ", ".join(f"{r:.1f}" for r in rates))


def serve_c16_line() -> str:
    """Queries/s and p50 of phase 9's c16 scheduled cascade (window 5,000
    us, 16 unique per batch, no result cache) on a stack of the 65,536
    encoded documents alone: 3 passes of 192 requests after a warm pass.
    Uses only entry points every slice of the port has."""
    from pathway_tpu_torch.index import ForwardIndex
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.serve import ServeScheduler

    encoder = SentenceEncoder(dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768, seed=SEED,
                              dtype=torch.bfloat16)
    docs, keys = corpus(N_DOCS), keys_for(N_DOCS)
    vecs = torch.cat([encoder.encode_to_device(docs[i : i + ENCODE_CHUNK]) for i in range(0, N_DOCS, ENCODE_CHUNK)])
    ivf = IvfKnnIndex(DIM, metric="cos")
    ivf.build_from_matrix(keys, vecs.float())
    fwd = ForwardIndex(encoder, tokens_per_doc=16, quant="int8")
    for i in range(0, N_DOCS, FWD_CHUNK):
        fwd.add(keys[i : i + FWD_CHUNK], docs[i : i + FWD_CHUNK])
    ce = CrossEncoderModel(dimension=256, n_layers=4, n_heads=4, max_length=256, vocab_size=32768, seed=SEED + 1,
                           dtype=torch.bfloat16)
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(encoder, ivf, k=RR_CANDIDATES), ce, dict(zip(keys, docs)), k=K,
                                  candidates=RR_CANDIDATES, forward_index=fwd, cascade=K)
    pool = [" ".join(docs[(i * 9973) % N_DOCS].split()[:8]) for i in range(64)]
    reqs = [pool[i % 4] if i % 2 == 0 else pool[(i * 7) % 64] for i in range(192)]
    for q in pool:
        pipe([q], K)
    for b in range(2, SCHED_MAX_BATCH + 1):
        pipe(sorted(set(reqs))[:b], K)
    passes = []
    for _ in range(4):
        sched = ServeScheduler(pipe, window_us=SCHED_WINDOW_US, max_batch=SCHED_MAX_BATCH, result_cache=None)
        try:
            qps, lats, _ = scheduled_drive(sched, reqs, 16)
        finally:
            sched.stop()
        passes.append((round(qps, 1), round(float(np.percentile(lats, 50)), 3)))
    passes = passes[1:]  # the first pass warms batch compositions
    return (f"{len(reqs)} requests per pass: {float(np.mean([q for q, _ in passes])):.1f} q/s, p50 "
            f"{float(np.median([p for _, p in passes])):.3f} ms (q/s, p50 per pass {passes})")


@torch.no_grad()
def rows_kernels(gen, dev, tag: str):
    """The row kernels of the decode path against their plain versions at
    the shapes the engine gives them, timed alone and between CUDA events
    with L2 cold and warm, beside one library call each.  Returns the
    records of the kernels line (launches filled in later)."""
    import torch.nn.functional as F

    from pathway_tpu_torch.ops import decode_rows
    from pathway_tpu_torch.ops.decode_rows import (
        add_layer_norm_reference, add_layer_norm_rows, layer_norm_reference, layer_norm_rows, tied_readout,
        tied_readout_reference,
    )

    d = gen.config.d_model
    ln = gen.module.blocks[0].ln_0
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)

    # -- LayerNorm: plain entry vs its plain version; fused entry == add + plain entry
    ln_err = 0.0
    for shape in ((DEC_SLOTS, 1, d), (DEC_SLOTS, 32, d), (3, 5, d)):
        x = (torch.randn(*shape, generator=g, device=dev) * 3).to(torch.bfloat16)
        got32 = layer_norm_rows(x, ln.weight, ln.bias, torch.float32)
        want32 = layer_norm_reference(x, ln.weight, ln.bias, torch.float32)
        got16 = layer_norm_rows(x, ln.weight, ln.bias, torch.bfloat16).float()
        torch.cuda.synchronize()
        ln_err = max(ln_err, float((got32 - want32).abs().max()))
        # the bf16 output is the f32 value rounded: within one bf16 ulp of it
        if ln_err > LN_ATOL or bool(((got16 - want32).abs() > want32.abs() * 2.0**-8 + 1e-6).any()):
            raise AssertionError(f"layer_norm_rows {shape}: f32 err {ln_err}, or bf16 beyond one ulp")
    fused_cases = 0
    for shape in ((DEC_SLOTS, 1, d), (DEC_SLOTS, 32, d)):  # a step, a 16-row 32-token prefill
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(*shape, generator=g, device=dev) * 3).to(dtype)
            delta = torch.randn(*shape, generator=g, device=dev).to(dtype)
            for out_dtype in (torch.bfloat16, torch.float32):
                s, y = add_layer_norm_rows(x, delta, ln.weight, ln.bias, out_dtype)
                s2 = x + delta
                y2 = layer_norm_rows(s2, ln.weight, ln.bias, out_dtype)
                torch.cuda.synchronize()
                if not (torch.equal(s, s2) and torch.equal(y, y2)):
                    raise AssertionError(f"add_layer_norm_rows {shape} {dtype} -> {out_dtype} differs from the two steps")
                fused_cases += 1
            ln_err = max(ln_err, float((y.float() - add_layer_norm_reference(x, delta, ln.weight, ln.bias, torch.float32)[1]).abs().max()))
    x = (torch.randn(DEC_SLOTS, 1, d, generator=g, device=dev) * 3).to(torch.bfloat16)
    delta = torch.randn(DEC_SLOTS, 1, d, generator=g, device=dev).to(torch.bfloat16)
    x32 = x.float()
    ln_t = {}
    for key, fl in (("cold", flush), ("warm", None)):
        ln_t[f"events_{key}"] = timed_ms(lambda: layer_norm_rows(x, ln.weight, ln.bias, torch.bfloat16), reps=20, flush=fl)
        ln_t[f"alone_{key}"] = alone_ms(lambda: layer_norm_rows(x, ln.weight, ln.bias, torch.bfloat16), 20, fl,
                                         include="layer_norm_rows", exclude=("add_",))
        ln_t[f"fused_events_{key}"] = timed_ms(lambda: add_layer_norm_rows(x, delta, ln.weight, ln.bias, torch.bfloat16),
                                               reps=20, flush=fl)
        ln_t[f"fused_alone_{key}"] = alone_ms(lambda: add_layer_norm_rows(x, delta, ln.weight, ln.bias, torch.bfloat16),
                                              20, fl, include="add_layer_norm_rows")
        ln_t[f"two_step_alone_{key}"] = alone_ms(lambda: layer_norm_rows(x + delta, ln.weight, ln.bias, torch.bfloat16), 20, fl)
        ln_t[f"library_alone_{key}"] = alone_ms(lambda: F.layer_norm(x32, (d,), ln.weight, ln.bias, 1e-6), 20, fl)
        ln_t[f"library_events_{key}"] = timed_ms(lambda: F.layer_norm(x32, (d,), ln.weight, ln.bias, 1e-6), reps=20, flush=fl)
    ln_plain_ms = timed_ms(lambda: add_layer_norm_reference(x, delta, ln.weight, ln.bias, torch.bfloat16), reps=20, flush=flush)
    rows_ = DEC_SLOTS
    ln_bytes = rows_ * d * 2 * 4 + 2 * d * 4  # x, delta read; s, y written (bf16); w, b
    ln_ops = 9 * rows_ * d
    ln_bound = max(ln_bytes / PEAK_BYTES_PER_S, ln_ops / PEAK_F32_FLOPS) * 1e3

    # -- readout: every row count the decode path gives it, row invariance
    table = gen._table
    V = table.shape[0]
    ro_err = 0.0
    ro_ms = {}
    for M in (1, 13, DEC_SLOTS, I8_SLOTS, DEC_SLOTS * SPEC_K, I8_SLOTS * SPEC_K):
        h = torch.randn(M, d, generator=g, device=dev).to(torch.bfloat16)
        got = tied_readout(h, table)
        want = tied_readout_reference(h, table)
        torch.cuda.synchronize()
        ro_err = max(ro_err, float((got - want).abs().max()))
        # row invariance, the reason the kernel exists: the first and the
        # last row equal the same row computed alone
        for r in sorted({0, M - 1}):
            if not torch.equal(tied_readout(h[r : r + 1], table)[0], got[r]):
                raise AssertionError(f"tied_readout: row {r} of {M} rows differs from the row alone")
        if M in (DEC_SLOTS, DEC_SLOTS * SPEC_K):
            h32 = h.float()
            rec = {}
            for key, fl in (("cold", flush), ("warm", None)):
                rec[f"events_{key}"] = timed_ms(lambda: tied_readout(h, table), reps=20, flush=fl)
                rec[f"alone_{key}"] = alone_ms(lambda: tied_readout(h, table), 20, fl, include="tied_readout")
                rec[f"library_alone_{key}"] = alone_ms(lambda: F.linear(h32, table), 20, fl)
                rec[f"library_events_{key}"] = timed_ms(lambda: F.linear(h32, table), reps=20, flush=fl)
            rec["alone_clean"] = alone_ms(lambda: tied_readout(h, table), 20, flush, include="tied_readout", clean=True)
            rec["library_alone_clean"] = alone_ms(lambda: F.linear(h32, table), 20, flush, clean=True)
            rec["plain"] = timed_ms(lambda: tied_readout_reference(h, table), reps=20, flush=flush)
            n_bytes = V * d * 4 + M * d * 2 + M * V * 4
            n_ops = 2 * M * V * d
            rec["bound"] = max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS) * 1e3
            rec["bound_by"] = "bytes" if n_bytes / PEAK_BYTES_PER_S >= n_ops / PEAK_F32_FLOPS else "operations"
            ro_ms[M] = rec
    if ro_err > READOUT_ATOL:
        raise AssertionError(f"tied_readout: max abs err {ro_err} > {READOUT_ATOL}")
    h = torch.randn(DEC_SLOTS, d, generator=g, device=dev).to(torch.bfloat16)
    # why the kernels exist: torch's own f32 readout and row mean of row 0,
    # alone and among 16 rows (printed, not checked: torch's choice)
    torch_moved = int((tied_readout_reference(h[:1], table)[0] != tied_readout_reference(h, table)[0]).sum())
    x16 = torch.randn(DEC_SLOTS * 16, d, generator=g, device=dev)
    mean_moved = int(sum(
        bool(x16[i : i + 1].mean(-1)[0] != x16.mean(-1)[i]) for i in range(DEC_SLOTS)
    ))
    del flush
    host = rows_host_line(decode_rows, d, dev)
    step, verify = ro_ms[DEC_SLOTS], ro_ms[DEC_SLOTS * SPEC_K]
    log(
        f"decode row kernels {tag}: LayerNorm [{DEC_SLOTS}, 1, {d}] bf16, f32 err {ln_err:.3e}; add_layer_norm_rows == "
        f"x + delta then layer_norm_rows (torch.equal, s and y) in {fused_cases} cases (step and 16 x 32 prefill, bf16 "
        f"and f32 in and out); alone cold / warm: fused {ln_t['fused_alone_cold']:.4f} / {ln_t['fused_alone_warm']:.4f} ms, "
        f"layer_norm_rows {ln_t['alone_cold']:.4f} / {ln_t['alone_warm']:.4f}, add + layer_norm_rows "
        f"{ln_t['two_step_alone_cold']:.4f} / {ln_t['two_step_alone_warm']:.4f}, F.layer_norm (f32 in) "
        f"{ln_t['library_alone_cold']:.4f} / {ln_t['library_alone_warm']:.4f}; between events cold / warm: fused "
        f"{ln_t['fused_events_cold']:.4f} / {ln_t['fused_events_warm']:.4f}, layer_norm_rows {ln_t['events_cold']:.4f} / "
        f"{ln_t['events_warm']:.4f}, F.layer_norm {ln_t['library_events_cold']:.4f} / {ln_t['library_events_warm']:.4f}; "
        f"plain add + LayerNorm {ln_plain_ms:.4f}; bound {ln_bound:.6f} ms (bytes)"
    )
    for M, rec in ro_ms.items():
        log(
            f"decode row kernels {tag}: tied_readout [{M}, {d}] x [{V}, {d}] alone cold / clean-cold / warm "
            f"{rec['alone_cold']:.4f} / {rec['alone_clean']:.4f} / {rec['alone_warm']:.4f} ms, between events cold / warm "
            f"{rec['events_cold']:.4f} / {rec['events_warm']:.4f}; F.linear alone {rec['library_alone_cold']:.4f} / "
            f"{rec['library_alone_clean']:.4f} / {rec['library_alone_warm']:.4f}, between events "
            f"{rec['library_events_cold']:.4f} / {rec['library_events_warm']:.4f}; plain {rec['plain']:.4f}; bound "
            f"{rec['bound']:.4f} ms ({rec['bound_by']})"
        )
    log(
        f"decode row kernels {tag}: tied_readout err {ro_err:.3e} at M = 1 / 13 / {DEC_SLOTS} / {I8_SLOTS} / "
        f"{DEC_SLOTS * SPEC_K} / {I8_SLOTS * SPEC_K}, first and last row bit-identical alone and among M rows; "
        f"torch alone vs among {DEC_SLOTS} rows: f32 readout of row 0 differs in {torch_moved} of {V} logits, row mean "
        f"differs in {mean_moved} of {DEC_SLOTS} rows (of {DEC_SLOTS * 16}); host us per wrapper call: {host}"
    )
    common = {"route": "cuda", "source": "pathway_tpu_torch/csrc/decode_rows.cu", "port_side": True}
    return [
        {"name": "layer_norm_rows", **common,
         "entries": "add_layer_norm_rows (the decode path's: each LayerNorm with its residual add) and layer_norm_rows",
         "replaces": "pathway_tpu/models/transformer.py:278 (XLA nn.LayerNorm and residual add of the KV twin; "
                     "no Pallas kernel)",
         "launches": 0, "max_abs_err": ln_err, "ms": ln_t["fused_events_cold"],
         "kernels_ms": ln_t["fused_alone_cold"], "kernels_warm_ms": ln_t["fused_alone_warm"],
         "plain_ms": ln_plain_ms, "bound_ms": ln_bound,
         "bound_by": "bytes" if ln_bytes / PEAK_BYTES_PER_S >= ln_ops / PEAK_F32_FLOPS else "operations",
         "library_ms": ln_t["library_events_cold"], "library_alone_ms": ln_t["library_alone_cold"],
         "plain_entry_kernels_ms": ln_t["alone_cold"], "two_step_kernels_ms": ln_t["two_step_alone_cold"]},
        {"name": "tied_readout", **common,
         "replaces": "pathway_tpu/models/generator.py:574 (XLA readout einsum; no Pallas kernel)",
         "launches": 0, "max_abs_err": ro_err, "ms": step["events_cold"], "kernels_ms": step["alone_cold"],
         "kernels_warm_ms": step["alone_warm"], "kernels_clean_cold_ms": step["alone_clean"],
         "library_alone_clean_ms": step["library_alone_clean"], "plain_ms": step["plain"], "bound_ms": step["bound"],
         "bound_by": step["bound_by"], "library_ms": step["library_events_cold"],
         "library_alone_ms": step["library_alone_cold"],
         "verify_shape": {"M": DEC_SLOTS * SPEC_K, "kernels_ms": verify["alone_cold"],
                          "kernels_warm_ms": verify["alone_warm"], "kernels_clean_cold_ms": verify["alone_clean"],
                          "ms": verify["events_cold"],
                          "library_alone_ms": verify["library_alone_cold"], "plain_ms": verify["plain"],
                          "bound_ms": verify["bound"], "bound_by": verify["bound_by"]}},
    ]


def step_program(gen, dev, greedy: bool):
    """The engine's slot step program for a 16-slot pool (chunk 1), with
    arguments that keep every lane live: ``(fn, args)``."""
    cfg = gen.config
    S, H = DEC_SLOTS, cfg.n_heads
    pk = torch.zeros((S, cfg.n_layers, DEC_WIDTH, H, cfg.d_model // H), dtype=cfg.dtype, device=dev)
    args = (
        pk, torch.zeros_like(pk), torch.arange(S, device=dev) + 5, torch.full((S,), 8, device=dev),
        torch.ones(S, dtype=torch.bool, device=dev), torch.full((S,), 100, device=dev),
        torch.zeros((S, 2), dtype=torch.int64, device=dev), torch.full((S,), 0.0 if greedy else SAMPLE_TEMP, device=dev),
        torch.full((S,), -1, device=dev), greedy,
    )
    return gen._slot_step_fn(S, DEC_WIDTH, 1), args


@torch.no_grad()
def step_launches(gen, dev, greedy: bool):
    """CUDA kernels one 16-lane decode step launches (the engine's slot
    step program, chunk 1, every lane live), counted with ``torch.profiler``
    in turns (fused, apart, apart, fused): ((with each LayerNorm fused with
    its residual add, with the add and the LayerNorm launched apart as
    before the fused entry), the launches that differ, by kernel)."""
    from pathway_tpu_torch.models import transformer
    from pathway_tpu_torch.ops.decode_rows import layer_norm_rows

    fn, args = step_program(gen, dev, greedy)

    def count():
        counts = {}
        for key, _, n in profiled_kernels(lambda: fn(*args), 1):
            counts[key] = counts.get(key, 0) + n
        return counts

    fused_entry = transformer.add_layer_norm_rows

    def apart(x, delta, weight, bias, out_dtype):
        s = x + delta
        return s, layer_norm_rows(s, weight, bias, out_dtype)

    runs = {"fused": [], "apart": []}
    for mode in ("fused", "apart", "apart", "fused"):
        transformer.add_layer_norm_rows = apart if mode == "apart" else fused_entry
        try:
            runs[mode].append(count())
        finally:
            transformer.add_layer_norm_rows = fused_entry
    # the profiler can drop events of a run, never add them: the larger count of each mode
    totals = {mode: max(sum(c.values()) for c in counts) for mode, counts in runs.items()}
    fused, apart_ = (max(runs[m], key=lambda c: sum(c.values())) for m in ("fused", "apart"))
    diff = {k[:60]: apart_.get(k, 0) - fused.get(k, 0) for k in set(fused) | set(apart_)
            if apart_.get(k, 0) != fused.get(k, 0)}
    return (totals["fused"], totals["apart"]), diff


def decode_phase(tag: str):
    """Phase 10: generator decode at the default model's full width.
    Returns the records of the decode path's row kernels, with their
    launches in the engine arms."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.cache import PrefixKVCache
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.ops import decode_rows, dispatch_counter
    from pathway_tpu_torch.serve import ContinuousDecoder
    from pathway_tpu_torch.serve import decode as decode_mod

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    kv = PrefixKVCache(block=16)
    gen = TextGenerator(kv_cache=kv, eos_id=None, seed=2)  # 256 wide, 4 layers, vocab 32768, bf16
    gen32 = TextGenerator(dtype=torch.float32, kv_cache=None, eos_id=None, seed=2)
    gen32.module.load_state_dict(gen.module.state_dict())
    kernels = rows_kernels(gen, dev, tag)
    prompts = decode_prompts()

    # -- f32: KV decode == the legacy re-attend ---------------------------------
    kv32 = gen32.generate(prompts, max_new_tokens=DEC_BUDGET, use_kv=True)
    legacy32 = gen32.generate(prompts, max_new_tokens=DEC_BUDGET, use_kv=False)
    bad = [i for i, (a, b) in enumerate(zip(kv32, legacy32)) if a != b]
    if bad:
        raise AssertionError(f"f32 KV decode differs from the legacy re-attend on prompts {bad}")
    log(f"decode f32 twin {tag}: KV decode == legacy re-attend, token for token, on all {len(prompts)} prompts "
        f"({DEC_BUDGET} tokens each)")

    # EOS-heavy short half: each even prompt's 4th greedy token is its EOS
    eos_of = {}
    for i, out in enumerate(gen.generate(prompts, max_new_tokens=SPEC_BUDGET)):
        toks = [int(t.strip("<>")) for t in out.split()]
        if i % 2 == 0 and len(toks) > 4:
            eos_of[i] = toks[3]

    def request(j: int, budget: int):
        i = j % len(prompts)
        temp = SAMPLE_TEMP if i % 4 in (2, 3) else 0.0
        return prompts[i], budget, eos_of.get(i), temp, i

    def call_level(req):
        p, budget, eos, temp, seed = req
        return gen.generate([p], max_new_tokens=budget, eos_id=eos, temperature=temp, seed=seed)[0]

    solo_memo = {}

    def solo(req):
        if req not in solo_memo:
            solo_memo[req] = call_level(req)
        return solo_memo[req]

    def submit(eng, req):
        p, budget, eos, temp, seed = req
        return eng.submit(p, max_new_tokens=budget, eos_id=eos, temperature=temp, seed=seed)

    def saturated(eng, reqs):
        t0 = time.perf_counter()
        tickets = [submit(eng, r) for r in reqs]
        outs = [t.result(timeout=TICKET_TIMEOUT_S) for t in tickets]
        return time.perf_counter() - t0, outs

    def n_tokens(outs):
        return sum(len(str(o).split()) for o in outs)

    def check_same(outs, reqs, what):
        bad = [j for j, (o, r) in enumerate(zip(outs, reqs)) if str(o) != solo(r) or getattr(o, "degraded", ())]
        if bad:
            j = bad[0]
            raise AssertionError(f"{what}: {len(bad)} of {len(reqs)} requests differ from solo generate; "
                                 f"first {reqs[j][0]!r} T={reqs[j][3]}: {str(outs[j])[:80]} vs {solo(reqs[j])[:80]}")

    def hist_delta(h, before):
        c, s = h.count - before[0], h.sum_seconds - before[1]
        return (1e3 * s / c if c else float("nan")), c

    # warm the shapes of both arms and the prefix cache off the clock
    eng = ContinuousDecoder(gen, slots=DEC_SLOTS, step_bucket=DEC_BUCKET, kv_width=DEC_WIDTH, name="smoke-decode")
    reqs16 = [request(j, DEC_BUDGET) for j in range(16)]
    for r in reqs16:
        solo(r)
    saturated(eng, reqs16)
    drive(lambda r: submit(eng, r).result(timeout=TICKET_TIMEOUT_S), [request(j, DEC_BUDGET) for j in range(32)], 16)

    # launches per 16-lane step, counted from the step program (greedy and
    # sampled), with the fused LayerNorms and with the add launched apart
    launches_step, step_diff = {}, {}
    for mode in ("greedy", "sampled"):
        launches_step[mode], step_diff[mode] = step_launches(gen, dev, greedy=mode == "greedy")
    if any(n <= 0 for pair in launches_step.values() for n in pair):
        raise AssertionError(f"no launches counted in a decode step: {launches_step}")
    log(
        f"decode step {tag}: one 16-lane step launches {launches_step['greedy'][0]} kernels greedy, "
        f"{launches_step['sampled'][0]} sampled, with each LayerNorm fused with its residual add; "
        f"{launches_step['greedy'][1]} / {launches_step['sampled'][1]} with the add launched apart "
        f"({launches_step['greedy'][1] - launches_step['greedy'][0]} / "
        f"{launches_step['sampled'][1] - launches_step['sampled'][0]} fewer; the larger of 2 counts each; the kernels "
        f"that differ, apart minus fused: {step_diff['greedy']})"
    )

    # -- the counted main path: engine arms, spec arms, int8 arms -------------------
    from pathway_tpu_torch.models import generator as generator_mod

    readout_by_path = {}
    counted_readout = generator_mod.tied_readout

    def classified_readout(h, table):
        """The generator's readout, with its launches split by caller."""
        where = sys._getframe(1).f_code.co_qualname
        path = ("verify" if "_slot_verify_fn" in where else "step" if "_slot_step_fn" in where
                else "prefill" if "_slot_prefill_fn" in where else "draft" if "_slot_draft_fn" in where
                else "solo")
        rows = h.numel() // h.shape[-1]
        readout_by_path[(path, rows)] = readout_by_path.get((path, rows), 0) + 1
        return counted_readout(h, table)

    generator_mod.tied_readout = classified_readout
    decode_rows.layer_norm_rows.launches = 0
    decode_rows.add_layer_norm_rows.launches = 0
    decode_rows.tied_readout.launches = 0
    pre0 = (decode_mod._H_PREFILL.count, decode_mod._H_PREFILL.sum_seconds)
    step0 = (decode_mod._H_STEP.count, decode_mod._H_STEP.sum_seconds)
    lines = []
    try:
        for conc in DEC_CONC:
            reqs = [request(j, DEC_BUDGET) for j in range(DEC_REQS[conc])]
            r_call, l_call, o_call = drive(call_level, reqs, conc)
            st0 = dict(eng.pool_stats)
            r_eng, l_eng, o_eng = drive(lambda r: submit(eng, r).result(timeout=TICKET_TIMEOUT_S), reqs, conc)
            check_same(o_call, reqs, f"call-level c{conc}")
            check_same(o_eng, reqs, f"engine c{conc}")
            tok = n_tokens(o_eng)
            chunks = eng.pool_stats["chunks"] - st0["chunks"]
            occ = (eng.pool_stats["occupancy_sum"] - st0["occupancy_sum"]) / max(chunks, 1)
            lines.append(
                f"c{conc}: call-level {tok * r_call / len(reqs):.1f} tokens/s, TTLT p50 {np.percentile(l_call, 50):.3f} "
                f"p90 {np.percentile(l_call, 90):.3f} ms; engine {tok * r_eng / len(reqs):.1f} tokens/s, TTLT p50 "
                f"{np.percentile(l_eng, 50):.3f} p90 {np.percentile(l_eng, 90):.3f} ms, {occ:.2f} slots per chunk "
                f"({chunks} chunks); {len(reqs)} requests, {tok} tokens"
            )
        log(f"decode closed loop {tag} (budget {DEC_BUDGET}, 16 slots, chunk {DEC_BUCKET}, width {DEC_WIDTH}, "
            f"half the prompts sampled at T={SAMPLE_TEMP}; every request == its solo generate): " + "; ".join(lines))

        # device busy share of the c16 engine arm, then no host sync in it
        reqs = [request(j, DEC_BUDGET) for j in range(DEC_C16_REQS)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive(lambda r: submit(eng, r).result(timeout=TICKET_TIMEOUT_S), reqs, 16)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = sum(
            getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        ) / 1e3
        busy = f"{100 * dev_ms / wall_ms:.1f}% busy" if dev_ms > 0 else "device time not measured (no CUDA events traced)"
        torch.cuda.set_sync_debug_mode(1)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, _, o_sync = drive(lambda r: submit(eng, r).result(timeout=TICKET_TIMEOUT_S), reqs, 16)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check_same(o_sync, reqs, "engine c16 under sync debug mode")
        syncs = [str(w.message)[:120] for w in caught if "synchroniz" in str(w.message).lower()]
        log(f"decode engine c16 {tag}: device kernels {dev_ms:.3f} ms in a {wall_ms:.3f} ms wall ({busy}); "
            f"{len(syncs)} device-to-host syncs under set_sync_debug_mode")
        if syncs:
            raise AssertionError(f"hidden host sync in the decode step loop: {syncs[:3]}")

        # warm prefix join == cold, bf16
        p1 = _SHARED * 2 + "what is incremental computation"
        p2 = _SHARED * 2 + "how does the scheduler coalesce"
        kv.clear()
        cold = eng.submit(p2, max_new_tokens=DEC_BUDGET).result(timeout=TICKET_TIMEOUT_S)
        kv.clear()
        kv.stats_tokens.update(reused=0, computed=0)
        eng.submit(p1, max_new_tokens=DEC_BUDGET).result(timeout=TICKET_TIMEOUT_S)
        warm = eng.submit(p2, max_new_tokens=DEC_BUDGET).result(timeout=TICKET_TIMEOUT_S)
        reused = kv.stats_tokens["reused"]
        if str(warm) != str(cold) or reused <= 0 or str(warm) != gen.generate([p2], max_new_tokens=DEC_BUDGET)[0]:
            raise AssertionError(f"bf16 warm prefix join: warm == cold {str(warm) == str(cold)}, reused {reused}")
    finally:
        eng.stop()

    # slot reuse after an EOS leave: one slot, every request takes it over
    base = [int(t.strip("<>")) for t in gen.generate([prompts[1]], max_new_tokens=10)[0].split()]
    one = ContinuousDecoder(gen, slots=1, step_bucket=4, kv_width=DEC_WIDTH, name="smoke-decode-reuse")
    try:
        seq = [prompts[1], prompts[4], prompts[7], prompts[1]]
        outs = [one.submit(p, max_new_tokens=10, eos_id=base[1]).result(timeout=TICKET_TIMEOUT_S) for p in seq]
        for p, o in zip(seq, outs):
            if str(o) != gen.generate([p], max_new_tokens=10, eos_id=base[1])[0]:
                raise AssertionError(f"slot reuse after EOS: {p!r} differs from solo")
        if one.pool_stats["finished"] != len(seq):
            raise AssertionError(f"slot reuse: {one.pool_stats}")
    finally:
        one.stop()
    log(f"decode {tag}: bf16 warm prefix join == cold ({reused} prefill tokens reused); a single slot reused "
        f"after {len(seq)} EOS leaves gives each request its solo tokens")

    # -- speculative arms: spec-off vs spec-on, saturated ------------------------------
    specs = {}
    for k in (0, SPEC_K):
        specs[k] = ContinuousDecoder(gen, slots=DEC_SLOTS, step_bucket=DEC_BUCKET, kv_width=DEC_WIDTH, spec_k=k,
                                     name=f"smoke-spec{k}")
    # the reduced-layer trunk draft, which the n-gram miner leaves idle on
    # this traffic: every round drafts through it
    specs["trunk"] = ContinuousDecoder(gen, slots=DEC_SLOTS, step_bucket=DEC_BUCKET, kv_width=DEC_WIDTH,
                                       spec_k=SPEC_K, draft="trunk", name="smoke-spec-trunk")
    try:
        sreqs = [request(j, SPEC_BUDGET) for j in range(SPEC_REQS)]
        for k, e in specs.items():
            saturated(e, sreqs[:16])  # warm shapes and the suffix corpus
        _, o_trunk = saturated(specs["trunk"], sreqs[:SPEC_TRUNK_REQS])
        check_same(o_trunk, sreqs[:SPEC_TRUNK_REQS], "spec-on, trunk drafts")
        tr = specs["trunk"].pool_stats
        trunk_round = 1.0 + tr["draft_accepted"] / max(tr["draft_offered"] / (SPEC_K - 1), 1e-9)
        sp0 = dict(specs[SPEC_K].pool_stats)
        src0 = dict(specs[SPEC_K]._draft_sources)
        off0 = specs[0].pool_stats["chunks"]
        with dispatch_counter.DispatchCounter() as off_counter:
            w_off, o_off = saturated(specs[0], sreqs)
        off_chunks = specs[0].pool_stats["chunks"] - off0
        off_by = {(kind, t): sum(1 for e in off_counter.events if e == (kind, t)) for kind in ("dispatch", "fetch")
                  for t in ("decode_step", "decode_draft", "decode_verify")}
        if (off_chunks <= 0 or off_by[("dispatch", "decode_step")] != off_chunks
                or off_by[("fetch", "decode_step")] != off_chunks or off_by[("dispatch", "decode_verify")]):
            raise AssertionError(f"plain chunk budget: {off_chunks} chunks, events {off_by}")
        with dispatch_counter.DispatchCounter() as counter:
            w_on, o_on = saturated(specs[SPEC_K], sreqs)
        check_same(o_off, sreqs, "spec-off")
        check_same(o_on, sreqs, "spec-on")
        st = specs[SPEC_K].pool_stats
        rounds = st["spec_rounds"] - sp0["spec_rounds"]
        chunks = st["chunks"] - sp0["chunks"]
        by = {}
        for kind, t in counter.events:
            by[(kind, t)] = by.get((kind, t), 0) + 1
        spec_d = by.get(("dispatch", "decode_draft"), 0) + by.get(("dispatch", "decode_verify"), 0)
        spec_f = by.get(("fetch", "decode_draft"), 0) + by.get(("fetch", "decode_verify"), 0)
        plain = chunks - rounds
        if (rounds <= 0 or spec_d > 2 * rounds or spec_f > 2 * rounds or by.get(("dispatch", "decode_verify"), 0) != rounds
                or by.get(("dispatch", "decode_step"), 0) != plain or by.get(("fetch", "decode_step"), 0) != plain):
            raise AssertionError(f"spec dispatch budget: {rounds} rounds, {plain} plain chunks, events {by}")
        d_acc = st["draft_accepted"] - sp0["draft_accepted"]
        d_off = st["draft_offered"] - sp0["draft_offered"]
        acc_round = 1.0 + d_acc / max(d_off / (SPEC_K - 1), 1e-9)
        sources = {key: specs[SPEC_K]._draft_sources[key] - src0[key] for key in src0}
        tok = n_tokens(o_on)
        bf_bytes = specs[SPEC_K].hbm_components()
        log(
            f"decode spec {tag} (k={SPEC_K}, budget {SPEC_BUDGET}, {SPEC_REQS} requests saturated, 16 slots; "
            f"spec-on == spec-off == solo): spec-off {tok / w_off:.1f} tokens/s, spec-on {tok / w_on:.1f} tokens/s; "
            f"{rounds} rounds + {plain} plain chunks, {acc_round:.2f} tokens per lane-round, draft sources {sources}; "
            f"dispatches + fetches per round <= {spec_d / rounds:.2f} + {spec_f / rounds:.2f}; spec-off "
            f"{off_chunks} chunks, 1 + 1 each; trunk drafts (D = {specs['trunk']._draft_layers} layers, {SPEC_TRUNK_REQS} requests) "
            f"== solo at {trunk_round:.2f} tokens per lane-round over {tr['spec_rounds']} rounds"
        )
    finally:
        for e in specs.values():
            e.stop()

    # -- int8 pool: 32 slots in the bytes of the 16-slot bf16 pool ---------------------
    i8 = {}
    for k in (0, SPEC_K):
        i8[k] = ContinuousDecoder(gen, slots=I8_SLOTS, step_bucket=DEC_BUCKET, kv_width=DEC_WIDTH, spec_k=k,
                                  kv_quant="int8", name=f"smoke-int8-spec{k}")
    try:
        i8_bytes = i8[SPEC_K].hbm_components()
        ireqs = sreqs[:I8_REQS]
        for e in i8.values():
            saturated(e, ireqs[:16])
        w_i8_off, o_i8_off = saturated(i8[0], ireqs)
        w_i8, o_i8 = saturated(i8[SPEC_K], ireqs)
        if [str(o) for o in o_i8] != [str(o) for o in o_i8_off] or any(o.degraded for o in o_i8):
            raise AssertionError("int8: spec-on differs from spec-off")
        if i8[SPEC_K].pool_stats["spec_rounds"] <= 0:
            raise AssertionError("int8 spec arm ran no speculative round")
        drift = sum(1 for a, b in zip(o_i8, o_on[:I8_REQS]) if str(a) != str(b))
        kv.clear()
        cold = i8[0].submit(p2, max_new_tokens=DEC_BUDGET).result(timeout=TICKET_TIMEOUT_S)
        kv.clear()
        kv.stats_tokens.update(reused=0, computed=0)
        i8[0].submit(p1, max_new_tokens=DEC_BUDGET).result(timeout=TICKET_TIMEOUT_S)
        warm = i8[0].submit(p2, max_new_tokens=DEC_BUDGET).result(timeout=TICKET_TIMEOUT_S)
        if str(warm) != str(cold) or kv.stats_tokens["reused"] <= 0:
            raise AssertionError(f"int8 warm prefix join differs from cold (reused {kv.stats_tokens['reused']})")
    finally:
        for e in i8.values():
            e.stop()
    bf_total, i8_total = sum(bf_bytes.values()), sum(i8_bytes.values())
    ratio = i8_total / bf_total
    pool_i8 = i8_bytes["kv_pool"] - I8_SLOTS * 2 * 8  # without the sampling keys
    pool_bf = bf_bytes["kv_pool"] - DEC_SLOTS * 2 * 8
    if pool_i8 > pool_bf or ratio > 1.02:
        raise AssertionError(f"int8 pool of {I8_SLOTS} slots: {i8_bytes} vs bf16 {bf_bytes}")
    generator_mod.tied_readout = counted_readout
    pre_ms, pre_n = hist_delta(decode_mod._H_PREFILL, pre0)
    step_ms, step_n = hist_delta(decode_mod._H_STEP, step0)
    ln_launches = {"add_layer_norm_rows": decode_rows.add_layer_norm_rows.launches,
                   "layer_norm_rows": decode_rows.layer_norm_rows.launches}
    kernels[0]["launches"] = sum(ln_launches.values())
    kernels[0]["launches_by_entry"] = ln_launches
    kernels[1]["launches"] = decode_rows.tied_readout.launches
    by_path = {}
    for (path, rows), n in sorted(readout_by_path.items()):
        by_path.setdefault(path, {})[rows] = n
    kernels[1]["launches_by_path"] = {path: sum(v.values()) for path, v in by_path.items()}
    kernels[1]["launches_by_rows"] = {f"{path} M={rows}": n for (path, rows), n in sorted(readout_by_path.items())}
    missing = [p for p in ("step", "verify", "prefill") if not by_path.get(p)]
    if missing or ln_launches["add_layer_norm_rows"] <= 0 or kernels[1]["launches"] <= 0:
        raise AssertionError(f"decode path launches: readout by path {by_path}, LayerNorm {ln_launches}")
    log(
        f"decode int8 {tag}: {I8_SLOTS} slots, spec-on == spec-off, warm == cold; spec-on {n_tokens(o_i8) / w_i8:.1f} "
        f"tokens/s ({I8_REQS} requests, spec-off {n_tokens(o_i8_off) / w_i8_off:.1f}); bf16-vs-int8 drift: "
        f"{drift} of {I8_REQS} requests differ; pool bytes bf16 {DEC_SLOTS} slots {bf_bytes} = {bf_total}, int8 "
        f"{I8_SLOTS} slots {i8_bytes} = {i8_total} ({ratio:.4f}x; K/V alone {pool_i8} vs {pool_bf})"
    )
    log(
        f"decode phase {tag}: prefill {pre_ms:.3f} ms per dispatch ({pre_n}), step chunk / verify {step_ms:.3f} ms per "
        f"dispatch ({step_n}) from pathway_generator_phase_seconds; row kernel launches: "
        f"add_layer_norm_rows {ln_launches['add_layer_norm_rows']}, layer_norm_rows {ln_launches['layer_norm_rows']}, "
        f"tied_readout {kernels[1]['launches']} (by path {kernels[1]['launches_by_path']}; by rows "
        f"{kernels[1]['launches_by_rows']}); {time.perf_counter() - t_phase:.1f} s"
    )
    return kernels


LI_CALLERS = 16  # phase 11: the c16 drive of bench.py phase_live_ingest
LI_REQUESTS = 128
LI_COMMITS = 8
LI_PER_COMMIT = 8
LI_BURST = 2048  # past absorb_threshold: an absorb runs while serves do (4,096 before phase 28)
LI_BURST_COMMIT = 64
LI_ROUNDS = 3  # interleaved pairs of the plane and shed A/Bs
LI_SHED_BACKOFF_S = 0.1  # a shed caller waits this long before its next request, as after a retry-after
SENTINEL = "the zanzibar quorum ledger reconciles nightly freshness audits"


def live_drive(sched, pool, n: int, priority_of=None, feeder=None, until=None, shed_backoff_s=0.0):
    """``LI_CALLERS`` closed-loop callers serving single queries from
    ``pool`` (plus an optional feeder thread sharing their barrier); with
    ``until``, callers go on past ``n`` requests until it is set; a caller
    whose request was shed waits ``shed_backoff_s`` before its next one.
    Returns (latencies ms, shed flags, priorities) in request order."""
    done = []
    errors = []
    lock = threading.Lock()
    barrier = threading.Barrier(LI_CALLERS + (feeder is not None))

    def worker(t: int):
        try:
            barrier.wait(timeout=60)
            i = t
            while i < n or (until is not None and not until.is_set()):
                prio = priority_of(i) if priority_of else None
                t0 = time.perf_counter()
                res = sched.submit([pool[(i * 7) % len(pool)]], K, priority=prio).result(timeout=TICKET_TIMEOUT_S)
                lat = (time.perf_counter() - t0) * 1e3
                shed = bool(res.meta.get("shed"))
                if not shed and (res.degraded or not res[0]):
                    raise AssertionError(f"request {i}: degraded {res.degraded}, {len(res[0])} rows")
                with lock:
                    done.append((i, lat, shed, prio))
                if shed:
                    time.sleep(shed_backoff_s)
                i += LI_CALLERS
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    def feed():
        try:
            feeder(barrier)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
        finally:
            if until is not None:
                until.set()

    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(LI_CALLERS)]
    if feeder is not None:
        threads.append(threading.Thread(target=feed, daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"live drive: {errors[:3]} (alive: {sum(t.is_alive() for t in threads)})")
    done.sort()
    return np.asarray([d[1] for d in done], np.float64), [d[2] for d in done], [d[3] for d in done]


def stored_bytes(backend, prefix: str) -> int:
    keys = backend.list_keys(prefix + "/")
    if hasattr(backend, "root"):
        return sum(os.path.getsize(backend._path(k)) for k in keys)
    return sum(len(backend.get(k)) for k in keys)


def device_busy(prof, wall_ms: float) -> str:
    dev_ms = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ) / 1e3
    if dev_ms <= 0:
        return "busy share not measured (no CUDA events traced)"
    return f"device kernels {dev_ms:.3f} ms in a {wall_ms:.3f} ms wall ({100 * dev_ms / wall_ms:.1f}% busy)"


def delta_quantile_ms(h, before_counts, q: float, minus=None) -> float:
    """Bucket-bound estimate of the ``q`` quantile (ms) of the
    observations a histogram took since ``before_counts``, less the
    bucket counts ``minus``."""
    from pathway_tpu_torch.observe import bucket_bounds_s

    delta = [a - b for a, b in zip(h.snapshot()[0], before_counts)]
    if minus is not None:
        delta = [d - m for d, m in zip(delta, minus)]
    cut, cum = q * sum(delta), 0
    for bound, c in zip(bucket_bounds_s(), delta):
        cum += c
        if c and cum >= cut:
            return bound * 1e3
    return float("nan")


def stage_marks(ingest_mod):
    """(count, sum ns) of the freshness histograms, for ``stage_means``."""
    hists = {"freshness": ingest_mod._H_FRESH, **ingest_mod._H_STAGE}
    return {name: h.snapshot()[1:] for name, h in hists.items()}


def stage_means(ingest_mod, before, minus=None) -> str:
    """Mean ms per observation of each freshness histogram since
    ``before`` (queue wait and freshness per document, the rest per
    batch), less the (sum ns, count) deltas ``minus``."""
    now = stage_marks(ingest_mod)
    parts = []
    for name, (sum_ns, n) in now.items():
        d_sum, d_n = sum_ns - before[name][0], n - before[name][1]
        if minus is not None:
            d_sum, d_n = d_sum - minus[name][0], d_n - minus[name][1]
        parts.append(f"{name} {d_sum / d_n * 1e-6:.3f} ms" if d_n else f"{name} -")
    return ", ".join(parts)


def live_ingest_phase(encoder, ivf, docs, modes, fwd, tag: str):
    """Phase 11: live ingest into the 1M IVF index and the forward index
    under c16 scheduled serve; returns the rescore launches of its drives
    and the kernel's record at a stage-1 call made after the absorb."""
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch import config as port_config
    from pathway_tpu_torch.observe import slo as slo_mod
    from pathway_tpu_torch.observe import trace as trace_mod
    from pathway_tpu_torch.ops import dispatch_counter
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.serve import LiveIngestRunner, ServeScheduler
    from pathway_tpu_torch.serve import ingest as ingest_mod

    t_phase = time.perf_counter()
    # a fresh SLO engine: the burn of earlier phases' injected faults is
    # not this traffic's, and it would hold the runner's backpressure on
    slo_mod.reset()
    cascade, maxsim = modes["cascade"], modes["maxsim"]
    pool = [" ".join(docs[(i * 9973) % N_DOCS].split()[:8]) for i in range(32)]
    fresh_texts = corpus(LI_BURST + 4096, seed=SEED + 11)  # every arm's fresh documents
    taken = [0]

    def fresh_rows(n: int):
        """New (key, text) rows, registered with the pipelines' document
        text so stage 2 can score them once retrievable."""
        rows = []
        for _ in range(n):
            i = taken[0]
            taken[0] += 1
            key, text = (1 << 60) + i, fresh_texts[i] + " fresh"
            cascade.doc_text[key] = text
            rows.append((key, text))
        return rows

    def scheduler(target):
        return ServeScheduler(target, window_us=SCHED_WINDOW_US, max_batch=SCHED_MAX_BATCH, result_cache=None)

    # -- ingest alone: 1,024 documents in commits of 64, no serve --
    t_arm = time.perf_counter()
    marks = stage_marks(ingest_mod)
    runner = LiveIngestRunner(encoder, ivf, fwd, name="smoke-alone")
    conn = runner.connector("smoke-alone-0")
    t0 = time.perf_counter()
    for _ in range(0, 1024, LI_BURST_COMMIT):
        conn.insert_rows(fresh_rows(LI_BURST_COMMIT))
        conn.commit()
    if not runner.flush(timeout=300.0):
        raise AssertionError("ingest alone did not land")
    alone_s = time.perf_counter() - t0
    runner.stop()
    log(
        f"ingest alone {tag}: 1024 documents in commits of {LI_BURST_COMMIT} in {alone_s:.3f} s "
        f"({1024 / alone_s:.0f} docs/s, host clock), {runner.stats['batches']} batches; stage means "
        f"{stage_means(ingest_mod, marks)}; SLOs firing {list(slo_mod.firing_specs())}; "
        f"{time.perf_counter() - t_arm:.1f} s"
    )

    # -- the combined drive: 128 requests from 16 callers, 8 commits of 8 --
    t_arm = time.perf_counter()
    marks = stage_marks(ingest_mod)
    fresh_counts = ingest_mod._H_FRESH.snapshot()[0]
    runner = LiveIngestRunner(encoder, ivf, fwd, name="smoke-live")
    conn = runner.connector("smoke-live-0")
    gen0 = ivf.generation
    sentinel_key = (1 << 60) - 1
    cascade.doc_text[sentinel_key] = SENTINEL
    sentinel = {}

    def route_sentinel():
        """The middle commit's sentinel arrives routed from a peer host,
        stamped at that host's commit 1 ms further back than the
        freshness threshold: its batch, alone in the queue (flushed before
        and after), is the one batch past the threshold, so its trace is
        force-kept.  Its observations are left out of the staleness
        quantiles and the stage means."""
        if not runner.flush(timeout=60.0):
            raise AssertionError("the commits before the sentinel did not land")
        before, marks0 = ingest_mod._H_FRESH.snapshot()[0], stage_marks(ingest_mod)
        stale_ns = int(port_config.get("observe.slo_freshness_ms") * 1e6) + 1_000_000
        runner.ingest_routed([(sentinel_key, SENTINEL, time.perf_counter_ns() - stale_ns)], connector="smoke-sentinel")
        if not runner.flush(timeout=60.0):
            raise AssertionError("the sentinel did not land")
        sentinel["excluded"] = [a - b for a, b in zip(ingest_mod._H_FRESH.snapshot()[0], before)]
        sentinel["marks"] = {
            name: (a[0] - marks0[name][0], a[1] - marks0[name][1]) for name, a in stage_marks(ingest_mod).items()
        }
        sentinel["traces"] = [
            t for t in trace_mod.snapshot_traces()["traces"]
            if t["kind"] == "ingest" and "smoke-sentinel" in t["attrs"].get("connectors", ())
        ]

    def feeder(barrier):
        barrier.wait(timeout=60)
        for c in range(LI_COMMITS):
            conn.insert_rows(fresh_rows(LI_PER_COMMIT))
            conn.commit(offsets={"0": (c + 1) * LI_PER_COMMIT})
            if c == LI_COMMITS // 2:
                route_sentinel()
            time.sleep(0.01)

    sched = scheduler(cascade)
    try:
        live_drive(sched, pool, 2 * LI_CALLERS)  # settle the compositions
        rescore_shortlist.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lats, _, _ = live_drive(sched, pool, LI_REQUESTS, feeder=feeder)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        sched.stop()
    landed = runner.flush(timeout=120.0)
    stats = runner.stats
    p50_ms = delta_quantile_ms(ingest_mod._H_FRESH, fresh_counts, 0.5, minus=sentinel["excluded"])
    p99_ms = delta_quantile_ms(ingest_mod._H_FRESH, fresh_counts, 0.99, minus=sentinel["excluded"])
    got = cascade([SENTINEL], K)
    kept = [t["keep_reason"] for t in sentinel["traces"]]
    found = sentinel_key in [key for key, _ in got[0]]
    log(
        f"live ingest, c{LI_CALLERS} scheduled cascade (window {SCHED_WINDOW_US:.0f} us, max_batch "
        f"{SCHED_MAX_BATCH}) over the 1M IVF index with {LI_COMMITS} commits of {LI_PER_COMMIT} fresh documents "
        f"10 ms apart {tag}: serve p50 {np.percentile(lats, 50):.3f} ms p99 {np.percentile(lats, 99):.3f} ms "
        f"({LI_REQUESTS} requests); staleness (arrival to retrievable) p50 {p50_ms:.3f} ms p99 {p99_ms:.3f} ms "
        f"(bucket bounds); runner {stats}; generation {gen0} -> {ivf.generation}; sentinel retrievable {found}, "
        f"its batch's ingest trace kept {kept}; stage means {stage_means(ingest_mod, marks, sentinel['marks'])}; "
        f"{device_busy(prof, wall_ms)}; SLOs firing {list(slo_mod.firing_specs())}; "
        f"{time.perf_counter() - t_arm:.1f} s"
    )
    if not landed or stats["dropped"] or ivf.generation <= gen0 or not found or kept != ["forced"]:
        raise AssertionError(f"live ingest: flushed {landed}, stats {stats}, sentinel {found}, its trace kept {kept}")

    # -- burst: LI_BURST documents in commits of 64 while the MaxSim pipeline
    # serves; the tail passes absorb_threshold and the absorb runs under
    # the serves; each batch stays within stage 1 + MaxSim's 2 + 2 --
    t_arm = time.perf_counter()
    marks = stage_marks(ingest_mod)
    absorbs0 = ivf.stats["absorbs"]
    burst_keys = []
    during_absorb = [0]
    t_burst = {}

    def burst_feeder(barrier):
        barrier.wait(timeout=60)
        t_burst["start"] = time.perf_counter()
        for _ in range(0, LI_BURST, LI_BURST_COMMIT):
            rows = fresh_rows(LI_BURST_COMMIT)
            burst_keys.extend(k for k, _ in rows)
            conn.insert_rows(rows)
            conn.commit()
        if not runner.flush(timeout=300.0):
            raise AssertionError("the burst did not land")
        t_burst["landed"] = time.perf_counter()
        wait_maintenance(ivf, timeout_s=120.0)

    class Watch:
        """Counts requests answered while the IVF absorb was running."""

        def __init__(self, target):
            self.target, self.k = target, target.k

        def __getattr__(self, name):
            return getattr(self.target, name)

        def submit(self, texts, k=None, deadline=None, n_requests=1):
            handle = self.target.submit(texts, k, deadline=deadline, n_requests=n_requests)

            def complete():
                out = handle()
                if ivf._absorbing:
                    during_absorb[0] += 1
                return out

            complete.advance = handle.advance
            return complete

    sched = scheduler(Watch(maxsim))
    try:
        with dispatch_counter.DispatchCounter() as counter:
            lats_b, _, _ = live_drive(sched, pool, LI_REQUESTS, feeder=burst_feeder, until=threading.Event())
        batches = sched.stats["batches"] + sched.stats["solo"]
    finally:
        sched.stop()
    wait_maintenance(ivf, timeout_s=120.0)
    launches = rescore_shortlist.launches
    docs_s = len(burst_keys) / (t_burst["landed"] - t_burst["start"])
    log(
        f"live ingest burst {tag}: {len(burst_keys)} documents in commits of {LI_BURST_COMMIT}, landed at "
        f"{docs_s:.0f} docs/s (embed + IVF and forward commits, host clock); {ivf.stats['absorbs'] - absorbs0} "
        f"absorb(s) ran, {during_absorb[0]} of {len(lats_b)} scheduled MaxSim requests answered during one; serve "
        f"p50 {np.percentile(lats_b, 50):.3f} ms p99 {np.percentile(lats_b, 99):.3f} ms; {counter.dispatches} "
        f"dispatches + {counter.fetches} fetches for {batches} batches; rescore launches in the drives "
        f"{launches}; stage means {stage_means(ingest_mod, marks)}; SLOs firing {list(slo_mod.firing_specs())}; "
        f"{time.perf_counter() - t_arm:.1f} s"
    )
    if ivf.stats["absorbs"] <= absorbs0 or ivf.stats["absorb_failures"]:
        raise AssertionError(f"the burst ran no absorb: {ivf.stats}")
    if counter.dispatches > 2 * batches or counter.fetches > 2 * batches:
        raise AssertionError(f"{counter.dispatches} dispatches + {counter.fetches} fetches for {batches} batches")
    if launches <= 0:
        raise AssertionError("the drives under ingest launched no rescore kernel")

    # -- absorbed rows served alone at full probe, and the kernel against its
    # plain version on the slabs the absorb wrote in place --
    placed = [k for k in burst_keys if k in ivf._slot_of_key]
    if len(placed) < BATCH:
        raise AssertionError(f"only {len(placed)} burst rows were absorbed into slab slots")
    probe_keys = placed[:: max(1, len(placed) // BATCH)][:BATCH]
    texts = [cascade.doc_text[k] for k in probe_keys]
    C = ivf._centroids.shape[0]
    ivf.n_probe = C
    try:
        rows = FusedEncodeSearch(encoder, ivf, k=K)(texts)
    finally:
        ivf.n_probe = None
    first = sum(1 for row, key in zip(rows, probe_keys) if row and row[0][0] == key)
    kernel = rescore_at_path_shape(ivf, stage1_rescore_args(maxsim.retriever, ivf, texts[:RR_QUERIES]), torch.device(DEVICE))
    log(
        f"after the burst {tag}: {len(placed)} of {len(burst_keys)} rows in slab slots, {len(ivf._tail)} in the tail; "
        f"full-probe serve (n_probe={C}) ranks the absorbed key first on {first}/{BATCH}; kernel ivf_rescore vs "
        f"plain over the absorbed rows' probes {rescore_line(ivf, kernel)}"
    )
    if first != BATCH:
        raise AssertionError(f"full-probe serve found {first}/{BATCH} absorbed keys")

    # -- freshness plane on / off: serve p50 of interleaved pairs --
    t_arm = time.perf_counter()
    plane = {True: [], False: []}
    for r in range(LI_ROUNDS):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            arm = LiveIngestRunner(encoder, ivf, fwd, name=f"smoke-ab-{r}-{int(on)}", freshness_plane=on)
            arm_conn = arm.connector("ab-0")

            def ab_feeder(barrier, arm_conn=arm_conn):
                barrier.wait(timeout=60)
                for _ in range(6):
                    arm_conn.insert_rows(fresh_rows(LI_PER_COMMIT))
                    arm_conn.commit()
                    time.sleep(0.005)

            sched = scheduler(cascade)
            try:
                live_drive(sched, pool, 2 * LI_CALLERS)
                lat_ab, _, _ = live_drive(sched, pool, LI_REQUESTS, feeder=ab_feeder)
            finally:
                sched.stop()
                arm.flush(timeout=120.0)
                arm.stop()
            plane[on].append(float(np.percentile(lat_ab, 50)))
    ratios = [a / b for a, b in zip(plane[True], plane[False])]
    log(
        f"freshness plane on / off, serve p50 per interleaved round {tag}: on {[round(x, 3) for x in plane[True]]} "
        f"ms, off {[round(x, 3) for x in plane[False]]} ms, ratios {[round(x, 4) for x in ratios]} (spread "
        f"{min(ratios):.4f}-{max(ratios):.4f}, host clock); {time.perf_counter() - t_arm:.1f} s"
    )

    # -- shed A/B under a real freshness burn: a paused runner's backlog ages
    # past a 50 ms threshold; low requests are shed only with shed on, and
    # a shed caller backs off before its next request --
    runner.stop()
    os.environ["PATHWAY_SLO_FRESHNESS_MS"] = "50"
    backlog = None
    try:
        engine = slo_mod.set_engine(None)
        engine.evaluate(max_age_s=0.0)
        backlog = LiveIngestRunner(encoder, ivf, fwd, name="smoke-backlog", autostart=False)
        bconn = backlog.connector("backlog-0")
        bconn.insert_rows(fresh_rows(32))
        bconn.commit()
        time.sleep(0.12)
        engine.evaluate(max_age_s=0.0)
        firing = slo_mod.firing_specs()
        if "freshness" not in firing or not slo_mod.should_shed():
            raise AssertionError(f"a paused backlog past the threshold did not fire freshness: {firing}")
        high_p99 = {True: [], False: []}
        n_shed = {True: 0, False: 0}
        for r in range(LI_ROUNDS):
            for shed_on in ((True, False) if r % 2 == 0 else (False, True)):
                os.environ["PATHWAY_SERVE_SHED"] = "1" if shed_on else "0"
                sched = scheduler(cascade)
                try:
                    lat_s, sheds, prios = live_drive(
                        sched, pool, LI_REQUESTS, priority_of=lambda i: "low" if i % 2 else "high",
                        shed_backoff_s=LI_SHED_BACKOFF_S,
                    )
                finally:
                    sched.stop()
                if any(sh for sh, pr in zip(sheds, prios) if pr == "high"):
                    raise AssertionError("a high-priority request was shed")
                if shed_on != any(sheds):
                    raise AssertionError(f"shed {'on' if shed_on else 'off'}: {sum(sheds)} requests shed")
                n_shed[shed_on] += sum(sheds)
                high_p99[shed_on].append(float(np.percentile([l for l, pr in zip(lat_s, prios) if pr == "high"], 99)))
    finally:
        for name in ("PATHWAY_SLO_FRESHNESS_MS", "PATHWAY_SERVE_SHED"):
            os.environ.pop(name, None)
        if backlog is not None:
            backlog.start()
            backlog.flush(timeout=120.0)
            backlog.stop()
        slo_mod.reset()
    log(
        f"shed A/B under a freshness burn (paused backlog of 32 past 50 ms; firing {list(firing)}; shed callers back "
        f"off {LI_SHED_BACKOFF_S * 1e3:.0f} ms) {tag}: high p99 "
        f"per round shed on {[round(x, 3) for x in high_p99[True]]} ms, off {[round(x, 3) for x in high_p99[False]]} "
        f"ms; low requests shed {n_shed[True]} (on) / {n_shed[False]} (off); every high request clean; phase "
        f"{time.perf_counter() - t_phase:.1f} s"
    )
    return launches, kernel


def stage1_outputs(retriever, ivf, texts):
    """The IVF stage-1 device outputs (scores, slots, tail scores, tail
    ids) of one batch, for ``torch.equal`` between two indexes.  A check,
    not the path: its rescore launch is taken back off the count."""
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.knn import _bucket

    ids, mask = retriever.encoder.tokenizer.encode_batch(texts)
    pad = np.zeros((_bucket(len(ids)) - len(ids), ids.shape[1]), ids.dtype)
    launches = rescore_shortlist.launches
    with torch.no_grad():
        z, _ = retriever._embed(np.concatenate([ids, pad]), np.concatenate([mask, pad]))
        with ivf._lock:
            _tail, tail_dev = ivf._tail_snapshot_device()
            out = ivf._search_device(z, K, ivf.probe_count(), tail_dev, serve=True)
    rescore_shortlist.launches = launches
    return out


class Timed:
    """A warm-state component whose capture and install are timed."""

    def __init__(self, component):
        self.component, self.capture_s, self.install_s = component, 0.0, 0.0

    def warm_state(self):
        t0 = time.perf_counter()
        state = self.component.warm_state()
        self.capture_s += time.perf_counter() - t0
        return state

    def load_warm_state(self, state):
        t0 = time.perf_counter()
        out = self.component.load_warm_state(state)
        torch.cuda.synchronize()
        self.install_s += time.perf_counter() - t0
        return out


def timed_line(total_s: float, comps, attr: str) -> str:
    parts = ", ".join(f"{name} {getattr(c, attr):.3f} s" for name, c in comps.items())
    rest = total_s - sum(getattr(c, attr) for c in comps.values())
    what = "pickle + frame + write" if attr == "capture_s" else "read + CRC scan + unpickle"
    return f"{attr.split('_')[0]} {parts}; {what} {rest:.3f} s"


def warm_state_phase(encoder, ivf, docs, keys, fwd, doc_text, tag: str):
    """Phase 12: cold bring-up (encode + build + first search) against a
    warm restore of IVF, forward index and both cache tiers from a
    ``FileBackend``; then the 1M IVF index itself.  Returns the rescore
    launches of its serves."""
    import shutil
    import tempfile

    from pathway_tpu_torch import observe
    from pathway_tpu_torch.cache import EmbeddingCache, ResultCache
    from pathway_tpu_torch.index import ForwardIndex
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.persistence import FileBackend, MemoryBackend
    from pathway_tpu_torch.serve import WarmStateManager

    t_phase = time.perf_counter()
    rescore_shortlist.launches = 0
    queries = [" ".join(docs[(i * 7919 + 3) % N_DOCS].split()[::2]) for i in range(BATCH)]

    # -- cold: encode the corpus, add, first search (the build) --
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = IvfKnnIndex(DIM, metric="cos")
    vecs = np.concatenate([encoder.encode(docs[i : i + ENCODE_CHUNK]) for i in range(0, N_DOCS, ENCODE_CHUNK)])
    cold.add(keys[:N_DOCS], vecs)
    cold.search(encoder.encode(queries[:2]), k=K)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    wait_maintenance(cold)

    def stack(ivf_x, fwd_x, ec):
        return (
            FusedEncodeSearch(encoder, ivf_x, k=K, embed_cache=None),
            FusedEncodeSearch(encoder, ivf_x, k=K, embed_cache=ec),
            RetrieveRerankPipeline(
                FusedEncodeSearch(encoder, ivf_x, k=RR_CANDIDATES, embed_cache=None), doc_text=doc_text, k=K,
                candidates=RR_CANDIDATES, forward_index=fwd_x,
            ),
        )

    rc, ec = ResultCache(), EmbeddingCache()
    writer = stack(cold, fwd, ec)
    want = [list(w(queries)) for w in writer]  # fills the embedding cache
    for q, row in zip(queries, want[2]):
        rc.put_row(q, cold.generation, K, row)
    want_dev = stage1_outputs(writer[0], cold, queries)

    fail_crc = observe.counter("pathway_warmstate_restore_failures_total", kind="crc")
    with tempfile.TemporaryDirectory(prefix="warmstate-") as tmp:
        backend = FileBackend(tmp)
        comps = {name: Timed(c) for name, c in (("ivf", cold), ("forward", fwd), ("result_cache", rc),
                                                ("embedding_cache", ec))}
        t0 = time.perf_counter()
        prefix = WarmStateManager(backend, name="replica0", components=comps).snapshot()
        t_snap = time.perf_counter() - t0
        if prefix is None:
            raise AssertionError("the warm-state snapshot was skipped")
        snap_bytes = stored_bytes(backend, prefix)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replica = {
            "ivf": IvfKnnIndex(DIM, metric="cos"),
            "forward": ForwardIndex(encoder, tokens_per_doc=16, quant="int8"),
            "result_cache": ResultCache(),
            "embedding_cache": EmbeddingCache(),
        }
        timed = {name: Timed(c) for name, c in replica.items()}
        report = WarmStateManager(FileBackend(tmp), name="replica0", components=timed).restore()
        t_restore = time.perf_counter() - t0
        replica["ivf"].search(encoder.encode(queries[:2]), k=K)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        if not report.restored:
            raise AssertionError(f"warm restore failed: {report}")
        reader = stack(replica["ivf"], replica["forward"], replica["embedding_cache"])
        hits0 = replica["embedding_cache"].stats["hits"]
        got = [list(r(queries)) for r in reader]
        got_dev = stage1_outputs(reader[0], replica["ivf"], queries)
        cached = replica["result_cache"].get_rows([(q, replica["ivf"].generation) for q in queries], K)
        same = [g == w for g, w in zip(got, want)]
        dev_equal = all(torch.equal(a, b) for a, b in zip(got_dev, want_dev))
        emb_hits = replica["embedding_cache"].stats["hits"] - hits0

        # a corrupted newest chunk falls back to the older snapshot
        mgr = WarmStateManager(backend, name="fallback", components={"ivf": cold}, keep=2)
        older, _newer = mgr.snapshot(), mgr.snapshot()
        key = f"{mgr._snap_prefix(mgr._list_seqs()[-1])}/ivf"
        blob = bytearray(backend.get(key))
        blob[len(blob) // 2] ^= 0xFF
        backend.put(key, bytes(blob))
        crc0 = fail_crc.value
        fallback = WarmStateManager(backend, name="fallback", components={"ivf": IvfKnnIndex(DIM, metric="cos")}).restore()
        crc_counted = fail_crc.value - crc0
    log(
        f"warm state {tag}: cold bring-up (encode {N_DOCS} docs + IVF add + first search) {t_cold:.3f} s; snapshot "
        f"of IVF + forward index ({len(fwd)} docs) + result cache ({len(rc._tier)}) + embedding cache ({len(ec)}) to "
        f"a FileBackend {snap_bytes / 1e6:.1f} MB in {t_snap:.3f} s; warm restore + first search {t_warm:.3f} s "
        f"(warm_vs_cold {t_cold / t_warm:.2f}x); snapshot {timed_line(t_snap, comps, 'capture_s')}; restore "
        f"{timed_line(t_restore, timed, 'install_s')}; {BATCH} queries bit-identical to the writer: fused {same[0]}, "
        f"embedding-cache path {same[1]} ({emb_hits} hits), MaxSim pipeline {same[2]}, stage-1 device outputs "
        f"torch.equal {dev_equal}; result cache rows equal {cached == want[2]}; corrupted newest chunk: restored "
        f"{fallback.restored} from the older snapshot {fallback.snapshot == older}, crc failures counted {crc_counted}"
    )
    if not all(same) or not dev_equal or cached != want[2] or emb_hits != BATCH:
        raise AssertionError("the warm-restored stack does not serve bit-identically to the writer")
    if t_warm >= t_cold:
        raise AssertionError(f"warm restore {t_warm:.3f} s is not faster than cold bring-up {t_cold:.3f} s")
    if not fallback.restored or fallback.snapshot != older or crc_counted != 1:
        raise AssertionError(f"CRC fallback: {fallback}, crc counted {crc_counted}")
    del cold, replica, writer, reader, vecs

    # -- the 1M IVF index itself --
    wait_maintenance(ivf)
    want = FusedEncodeSearch(encoder, ivf, k=K)(queries)
    with tempfile.TemporaryDirectory(prefix="warmstate-1m-") as tmp:
        need = 3 * ivf._slabs.numel() * ivf._slabs.element_size()
        free = shutil.disk_usage(tmp).free
        # the snapshot is written where the temporary directory has room for it
        backend = FileBackend(tmp) if free > need else MemoryBackend()
        where = type(backend).__name__
        t0 = time.perf_counter()
        big_w = {"ivf": Timed(ivf)}
        prefix = WarmStateManager(backend, name="ivf1m", components=big_w, keep=1).snapshot()
        t_snap = time.perf_counter() - t0
        if prefix is None:
            raise AssertionError("the 1M snapshot was skipped")
        snap_bytes = stored_bytes(backend, prefix)
        t0 = time.perf_counter()
        big = IvfKnnIndex(DIM, metric="cos")
        big_r = {"ivf": Timed(big)}
        report = WarmStateManager(backend, name="ivf1m", components=big_r).restore()
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        del backend
    got = FusedEncodeSearch(encoder, big, k=K)(queries)
    dev_equal = all(torch.equal(a, b) for a, b in zip(
        stage1_outputs(FusedEncodeSearch(encoder, big, k=K), big, queries),
        stage1_outputs(FusedEncodeSearch(encoder, ivf, k=K), ivf, queries),
    ))
    identical = list(got) == list(want)
    launches = rescore_shortlist.launches
    log(
        f"warm state, the 1M IVF index ({len(ivf)} rows, C={ivf._centroids.shape[0]} M_pad={ivf._M_pad}) {tag}: "
        f"snapshot {snap_bytes / 1e9:.3f} GB to a {where} "
        f"({free / 1e9:.1f} GB free in the temporary directory) in {t_snap:.3f} s ({timed_line(t_snap, big_w, 'capture_s')}), "
        f"restore {t_restore:.3f} s ({timed_line(t_restore, big_r, 'install_s')}; {report.restored}); {BATCH} serves bit-identical {identical}, stage-1 device outputs torch.equal "
        f"{dev_equal}; rescore launches of this phase's serves {launches} (its stage-1 output checks not counted); phase {time.perf_counter() - t_phase:.1f} s"
    )
    if not report.restored or not identical or not dev_equal:
        raise AssertionError("the restored 1M index does not serve bit-identically")
    del big
    return launches


ST_POOL = 96  # phase 13: bench.py phase_self_tuning's shifting workload
ST_CONC = 16
ST_REQUESTS = 256  # conc * 16, the bench's count
ST_TICK_S = 0.05
ST_LOOKUPS = 50_000
PO_POOL = 32  # phase 14: bench.py phase_profiling_overhead
PO_ROUNDS = 5
PO_REQUESTS = 128  # conc * 8, the bench's count
PO_LEDGER_ROWS = 262_144  # the structure built for the ledger-vs-allocator delta (~0.4 GB)
GUARD_ABSORB_THRESHOLD = 512
GUARD_ABSORBS = 6


def scheduled_drive(sched, reqs, conc: int):
    """``conc`` closed-loop callers through ``sched``: (q/s, latencies
    ms, rows per request)."""
    return drive(lambda q: sched.submit([q], K).result(timeout=TICKET_TIMEOUT_S), reqs, conc)


def tuning_phase(docs, pipe, tag: str) -> int:
    """Phase 13 (bench.py ``phase_self_tuning``): the c16 scheduler over
    the cascade with the knob table's live coalescing window, a result
    cache and the bench's shifting workload, static defaults against a
    background ``Tuner``.  Returns the rescore launches of its counted
    drives."""
    from pathway_tpu_torch import config
    from pathway_tpu_torch.cache import ResultCache, live_tiers
    from pathway_tpu_torch.observe import profile
    from pathway_tpu_torch.observe import slo as slo_mod
    from pathway_tpu_torch.ops import dispatch_counter
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.robust import inject
    from pathway_tpu_torch.serve import ServeScheduler, Tuner

    t_phase = time.perf_counter()
    slo_mod.reset()  # earlier phases' injected faults leave serve_latency burning
    pool = [" ".join(docs[(i * 9973) % N_DOCS].split()[:8]) for i in range(ST_POOL)]
    hot = pool[:4]

    def workload(n: int):
        # 2/3 of the first half on 4 hot queries, then a cold tail over the pool
        return [
            (hot[i % 4] if i % 3 else pool[(i * 7) % 64]) if i < n // 2 else pool[(i * 11 + 5) % len(pool)]
            for i in range(n)
        ]

    for q in pool:
        pipe([q], K)
    for b in range(2, SCHED_MAX_BATCH + 1):
        pipe(sorted(set(workload(3 * b)))[:b], K)
    with dispatch_counter.DispatchCounter() as counter:
        pipe([pool[0]], K)
    per_serve = (counter.dispatches, counter.fetches)

    snapshot0 = config.snapshot()
    stride0 = profile.sample_stride()

    def arm(tuned: bool):
        config.clear_overrides()
        reqs = workload(ST_REQUESTS)
        cache = ResultCache()
        sched = ServeScheduler(pipe, window_us=None, max_batch=SCHED_MAX_BATCH, result_cache=cache)
        budgets0 = {id(t): t.max_bytes for t in live_tiers()}
        tuner, traj = None, []
        if tuned:
            tuner = Tuner(interval_s=ST_TICK_S)
            tick = tuner.tick

            def tick_and_log():
                applied = tick()
                if applied:
                    traj.append((tuner.stats["ticks"], dict(config.overrides())))
                return applied

            tuner.tick = tick_and_log
            tuner.start()
        try:
            with dispatch_counter.DispatchCounter() as counter:
                qps, lats, rows = scheduled_drive(sched, reqs, ST_CONC)
            st = dict(sched.stats)
        finally:
            sched.stop()
            if tuner is not None:
                tuner.stop()
        n_batches = st["batches"] + st["solo"]
        if (counter.dispatches, counter.fetches) != (per_serve[0] * n_batches, per_serve[1] * n_batches):
            raise AssertionError(f"{'tuned' if tuned else 'static'}: {counter.dispatches} dispatches + "
                                 f"{counter.fetches} fetches for {n_batches} batches; one serve books {per_serve}")
        out = {"qps": qps, "lats": lats, "rows": dict(zip(reqs, rows)), "batches": n_batches, "traj": traj,
               "hits": cache.stats["hits"], "lookups": cache.stats["hits"] + cache.stats["misses"]}
        if tuner is not None:
            out.update(ticks=tuner.stats["ticks"], adjustments=tuner.stats["adjustments"],
                       final=dict(config.overrides()))
            tuner.revert()
            budgets = {id(t): t.max_bytes for t in live_tiers()}
            if config.snapshot() != snapshot0 or any(budgets.get(k, v) != v for k, v in budgets0.items()):
                raise AssertionError("revert() did not restore config.snapshot() and the live tier budgets")
            if profile.sample_stride() != stride0:
                raise AssertionError(f"revert() left the profiler stride at {profile.sample_stride()}")
        return out

    rescore_shortlist.launches = 0
    arms = {}
    for tuned in (False, True):
        arm(tuned)  # unmeasured pre-pass: batch compositions follow timing
        arms[tuned] = arm(tuned)
    launches = rescore_shortlist.launches
    static, tuned = arms[False], arms[True]
    differ = [q for q, got in tuned["rows"].items()
              if got.degraded or not same_ranking(static["rows"][q][0], got[0], tie=SCHED_TOL, atol=SCHED_TOL)]
    if differ:
        raise AssertionError(f"tuned rows rank differently from static on {len(differ)} queries: {differ[:3]}")
    if tuned["ticks"] < 1:
        raise AssertionError("the tuner never ticked")

    # 2 + 2 on a solo serve with the tuner thread live, as the bench checks
    live = Tuner(interval_s=ST_TICK_S).start()
    try:
        with dispatch_counter.DispatchCounter() as counter:
            pipe([pool[7]], K)
    finally:
        live.stop()
        live.revert()
    if (counter.dispatches, counter.fetches) != per_serve:
        raise AssertionError(f"solo serve with the tuner live: {counter.dispatches} + {counter.fetches}")

    # an armed tuner.adjust fault freezes the tuner and reverts it
    tier = ResultCache()._tier
    faulty = Tuner(interval_s=ST_TICK_S)
    faulty.tick()  # baseline of the signals
    faulty.revert()
    tier.stats["hits"] += 100
    tier.stats["evictions"] += 20
    moved = faulty.tick()
    budget_moved = tier.max_bytes
    inject.arm("tuner.adjust", "raise")
    try:
        frozen_tick = faulty.tick()
    finally:
        inject.disarm("tuner.adjust")
    if not (moved >= 1 and frozen_tick == 0 and faulty.frozen and config.overrides() == {}
            and tier.max_bytes == config.get("cache.result_bytes") != budget_moved and faulty.tick() == 0):
        raise AssertionError(f"tuner.adjust fault: moved {moved}, tick {frozen_tick}, frozen {faulty.frozen}, "
                             f"overrides {config.overrides()}")

    # config.get against a raw environment parse, priced per request at
    # the one live window read per batch
    t0 = time.perf_counter()
    for _ in range(ST_LOOKUPS):
        config.get("serve.coalesce_us")
    get_s = (time.perf_counter() - t0) / ST_LOOKUPS
    t0 = time.perf_counter()
    for _ in range(ST_LOOKUPS):
        float(os.environ.get("PATHWAY_SERVE_COALESCE_US") or 2000.0)
    raw_s = (time.perf_counter() - t0) / ST_LOOKUPS
    p50 = {t: float(np.percentile(a["lats"], 50)) for t, a in arms.items()}
    p99 = {t: float(np.percentile(a["lats"], 99)) for t, a in arms.items()}
    reads_per_req = tuned["batches"] / ST_REQUESTS
    share = get_s * reads_per_req / (p50[True] * 1e-3)
    traj = "; ".join(f"tick {tick}: {ov}" for tick, ov in tuned["traj"][:8])
    log(
        f"self-tuning c{ST_CONC} over the cascade ({ST_REQUESTS} requests, shifting workload, live window, result "
        f"cache) {tag}: static {static['qps']:.1f} q/s p50 {p50[False]:.3f} ms p99 {p99[False]:.3f} ms "
        f"({static['batches']} batches, hit rate {static['hits'] / max(static['lookups'], 1):.3f}); tuned "
        f"{tuned['qps']:.1f} q/s p50 {p50[True]:.3f} ms p99 {p99[True]:.3f} ms ({tuned['batches']} batches, hit rate "
        f"{tuned['hits'] / max(tuned['lookups'], 1):.3f}); tuned / static q/s {tuned['qps'] / static['qps']:.3f}; "
        f"tuner {tuned['ticks']} ticks, {tuned['adjustments']} adjustments, final {tuned['final']}; trajectory "
        f"[{traj}{' ...' if len(tuned['traj']) > 8 else ''}]; every query ranks alike in both arms; "
        f"{per_serve[0]} dispatches + {per_serve[1]} fetches per batch with the tuner live; revert restored the "
        f"snapshot and tier budgets; a tuner.adjust fault froze and reverted the tuner; config.get "
        f"{get_s * 1e9:.1f} ns vs raw env parse {raw_s * 1e9:.1f} ns, {reads_per_req:.3f} reads per request = "
        f"{100 * share:.5f}% of the tuned p50; rescore launches {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s"
    )
    return launches


def profiling_phase(encoder, ivf, docs, doc_vecs, keys, pipe, tag: str):
    """Phase 14 (bench.py ``phase_profiling_overhead``): the c16 stack
    with the profiler at stride 1 and a 10 Hz scraper (ledger + SLO
    document) against all of it off; the per-callable attribution beside
    ``torch.profiler``'s busy share; the ledger delta against the
    allocator's; the armed in-place-write guard under absorbs.  Returns
    the rescore launches of its drives and the decode row kernels'
    launches of its decode drive."""
    import gc

    from torch.profiler import ProfilerActivity, profile as torch_profile

    from pathway_tpu_torch import observe
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.observe import hbm, profile
    from pathway_tpu_torch.observe import slo as slo_mod
    from pathway_tpu_torch.ops import decode_rows, dispatch_counter, donation_guard
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.serve import ContinuousDecoder, ServeScheduler

    t_phase = time.perf_counter()
    pool = [" ".join(docs[(i * 9973) % N_DOCS].split()[:8]) for i in range(PO_POOL)]
    for q in pool:
        pipe([q], K)
    for b in range(2, SCHED_MAX_BATCH + 1):
        pipe(sorted(set(pool))[:b], K)
    with dispatch_counter.DispatchCounter() as counter:
        pipe([pool[0]], K)
    per_serve = (counter.dispatches, counter.fetches)
    stride0 = profile.sample_stride()
    shed0 = slo_mod.shed_advisory_enabled()
    rescore_shortlist.launches = 0

    def arm(on: bool, n: int):
        stop = threading.Event()
        scraper = None
        if on:
            profile.set_sample(1.0)
            slo_mod.set_shed_advisory(True)

            def scrape():
                while not stop.is_set():
                    hbm.sample()
                    slo_mod.engine().evaluate(max_age_s=0.0)
                    profile.profile_stats()
                    stop.wait(0.1)

            scraper = threading.Thread(target=scrape, daemon=True)
            scraper.start()
        else:
            profile.set_sample(0.0)
            slo_mod.set_shed_advisory(False)
        sched = ServeScheduler(pipe, window_us=SCHED_WINDOW_US, max_batch=SCHED_MAX_BATCH, result_cache=None)
        try:
            _, lats, _ = scheduled_drive(sched, [pool[(i * 7) % PO_POOL] for i in range(n)], ST_CONC)
        finally:
            sched.stop()
            stop.set()
            if scraper is not None:
                scraper.join(timeout=5)
        return lats

    try:
        # 2 + 2 per batch at stride 1: sampling adds no round trip
        profile.set_sample(1.0)
        sched = ServeScheduler(pipe, window_us=SCHED_WINDOW_US, max_batch=SCHED_MAX_BATCH, result_cache=None)
        try:
            with dispatch_counter.DispatchCounter() as counter:
                scheduled_drive(sched, [pool[(i * 7) % PO_POOL] for i in range(PO_REQUESTS)], ST_CONC)
            n_batches = sched.stats["batches"] + sched.stats["solo"]
        finally:
            sched.stop()
        if (counter.dispatches, counter.fetches) != (per_serve[0] * n_batches, per_serve[1] * n_batches):
            raise AssertionError(f"stride 1: {counter.dispatches} + {counter.fetches} for {n_batches} batches")

        # paired A/B, arm order alternated per round
        ratios, p50s = [], {True: [], False: []}
        for r in range(PO_ROUNDS):
            round_p50 = {}
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                arm(on, 2 * ST_CONC)  # settle after the flip
                round_p50[on] = float(np.percentile(arm(on, PO_REQUESTS), 50))
                p50s[on].append(round_p50[on])
            ratios.append(round_p50[True] / round_p50[False])

        # the attribution window: the c16 stack at stride 1, a stage-1
        # search and an encode of the pool, and a short decode drive, under
        # torch.profiler
        profile.set_sample(1.0)
        gen = TextGenerator()
        prompts = decode_prompts()
        engines = (ContinuousDecoder(gen, slots=DEC_SLOTS, step_bucket=8, kv_width=DEC_WIDTH),
                   ContinuousDecoder(gen, slots=DEC_SLOTS, step_bucket=8, kv_width=DEC_WIDTH, spec_k=8,
                                     draft="trunk"))
        try:
            for eng in engines:  # warm
                eng.generate(prompts, max_new_tokens=8)
            qvecs = encoder.encode(pool)
            ivf.search(qvecs[:BATCH], k=K)
            torch.cuda.synchronize()
            profile.drain(30.0)
            profile.reset()
            for kernel in (decode_rows.layer_norm_rows, decode_rows.add_layer_norm_rows, decode_rows.tied_readout):
                kernel.launches = 0
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                arm(True, PO_REQUESTS)
                encoder.encode(pool)
                ivf.search(qvecs, k=K)
                for eng in engines:
                    eng.generate(prompts, max_new_tokens=16)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            if not profile.drain(30.0):
                raise AssertionError("profiler samples still pending 30 s after the window")
        finally:
            for eng in engines:
                eng.stop()
        decode_launches = {
            "add_layer_norm_rows": decode_rows.add_layer_norm_rows.launches + decode_rows.layer_norm_rows.launches,
            "tied_readout": decode_rows.tied_readout.launches,
        }
        stats = profile.profile_stats()
    finally:
        profile.set_sample(1.0 / stride0 if stride0 else 0.0)
        slo_mod.set_shed_advisory(shed0)
    launches = rescore_shortlist.launches
    need = ("ivf.search", "encoder.forward", "rerank.stage2", "generator.slot_prefill", "generator.slot_step",
            "generator.slot_draft", "generator.slot_verify")
    missing = [n for n in need if stats.get(n, {}).get("device_s", 0.0) <= 0.0]
    if missing:
        raise AssertionError(f"no attributed device time for {missing}; rows {sorted(stats)}")
    attributed_s = sum(row["device_s"] for row in stats.values())
    rows = sorted(stats.items(), key=lambda kv: -kv[1]["device_s"])
    attribution = ", ".join(
        f"{name} {row['device_s'] * 1e3:.3f} ms / {row['calls']} calls" for name, row in rows if row["calls"]
    )
    added = [100.0 * (r - 1.0) for r in ratios]
    log(
        f"profiling overhead c{ST_CONC} over the cascade ({PO_ROUNDS} alternated pairs of {PO_REQUESTS} requests; "
        f"on = profiler stride 1 + a 10 Hz ledger / SLO scraper) {tag}: added p50 median "
        f"{float(np.median(added)):+.2f}% (pairs {[round(a, 2) for a in added]}, spread {min(added):+.2f}% .. "
        f"{max(added):+.2f}%; p50 on {[round(v, 3) for v in p50s[True]]} ms, off {[round(v, 3) for v in p50s[False]]} "
        f"ms); {per_serve[0]} dispatches + {per_serve[1]} fetches per batch at stride 1 ({n_batches} batches)"
    )
    log(
        f"per-callable attribution (submit -> ready, stride 1; one window: c16 cascade, encode + IVF search of "
        f"{PO_POOL} queries, 2 x 16 decode requests) {tag}: {attribution}; attributed {attributed_s * 1e3:.3f} ms "
        f"in a {wall_ms:.3f} ms wall ({100 * attributed_s * 1e3 / wall_ms:.1f}% of it: calls overlap and include "
        f"queue time); torch.profiler: {device_busy(prof, wall_ms)}; decode row kernel launches {decode_launches}"
    )

    # the ledger: its delta against the allocator's around a tracked
    # structure built after warm-up, and the whole sample beside it
    DeviceKnnIndex(DIM, metric="cos", initial_capacity=1024)
    gc.collect()
    torch.cuda.synchronize()
    s0 = hbm.sample()
    d0 = hbm.device_bytes()
    probe_index = DeviceKnnIndex(DIM, metric="cos", initial_capacity=PO_LEDGER_ROWS)
    torch.cuda.synchronize()
    s1 = hbm.sample()
    d1 = hbm.device_bytes()
    d_ledger, d_device = s1["total_bytes"] - s0["total_bytes"], d1 - d0
    subsystems = {sub: sum(parts.values()) for sub, parts in s1["subsystems"].items()}
    log(
        f"ledger {tag}: building a {PO_LEDGER_ROWS} x {DIM} exact index moved the ledger {d_ledger / 1e6:.3f} MB and "
        f"torch.cuda.memory_allocated {d_device / 1e6:.3f} MB ({100 * abs(d_device - d_ledger) / d_ledger:.3f}% "
        f"apart); whole ledger {s1['total_bytes'] / 1e9:.3f} GB against {d1 / 1e9:.3f} GB allocated (the rest: "
        f"transient tensors, the cuBLAS workspace, untracked copies), watermark {s1['watermark_bytes'] / 1e9:.3f} "
        f"GB; by subsystem (GB) { {k: round(v / 1e9, 3) for k, v in subsystems.items()} }; resources "
        f"{ {k: (v['used'], v['capacity'], round(v['exhaustion_eta_s'], 1)) for k, v in s1['resources'].items()} }"
    )
    del probe_index
    if abs(d_device - d_ledger) / d_ledger >= 0.10:
        raise AssertionError(f"ledger delta {d_ledger} vs allocator delta {d_device}: more than 10% apart")

    # the in-place-write guard, armed strict: absorbs under c16 serve on
    # an index of the encoded documents, then a planted snapshot
    os.environ["PATHWAY_DONATION_GUARD"] = "1"
    os.environ["PATHWAY_DONATION_GUARD_STRICT"] = "1"
    try:
        gidx = IvfKnnIndex(DIM, metric="cos", absorb_threshold=GUARD_ABSORB_THRESHOLD)
        gidx.build_from_matrix(keys[:N_DOCS], doc_vecs.float())
        # free slots for the absorbs (a remove masks its rows in place)
        gidx.remove(keys[: 2 * GUARD_ABSORB_THRESHOLD * GUARD_ABSORBS])
        gserve = FusedEncodeSearch(encoder, gidx, k=K)
        gserve(pool[:4])
        fresh = [t + " guarded" for t in corpus(GUARD_ABSORB_THRESHOLD * GUARD_ABSORBS, seed=SEED + 13)]
        with torch.no_grad():
            fresh_vecs = encoder.encode_to_device(fresh).float().cpu().numpy()
        fresh_keys = [(1 << 60) + i for i in range(len(fresh))]
        absorbs0 = gidx.stats["absorbs"]
        written0 = donation_guard.stats()["written"].get("ivf.absorb", 0)
        done = threading.Event()

        def feed():
            try:
                for c in range(GUARD_ABSORBS):
                    lo, hi = c * GUARD_ABSORB_THRESHOLD, (c + 1) * GUARD_ABSORB_THRESHOLD
                    gidx.add(fresh_keys[lo:hi], fresh_vecs[lo:hi])
                    wait_maintenance(gidx, 60.0)
            finally:
                done.set()

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        n_served = 0
        while not done.is_set():
            _, _, rows_ = drive(lambda q: gserve([q]), [pool[(i * 5) % PO_POOL] for i in range(ST_CONC * 4)], ST_CONC)
            n_served += len(rows_)
        feeder.join(timeout=120)
        absorbs = gidx.stats["absorbs"] - absorbs0
        stats_g = donation_guard.stats()
        written = stats_g["written"].get("ivf.absorb", 0) - written0
        if absorbs < 1 or written < 1 or stats_g["violations"]:
            raise AssertionError(f"guarded absorbs: {absorbs} absorbs, {written} writes, {stats_g['violations']}")
        # planted: a reference to the live bias taken as a snapshot
        # without a copy, then an absorb writes it in place
        planted = gidx._bias
        donation_guard.stamp("chip_smoke.planted_snapshot", planted)
        more = [t + " planted" for t in corpus(GUARD_ABSORB_THRESHOLD, seed=SEED + 17)]
        with torch.no_grad():
            more_vecs = encoder.encode_to_device(more).float().cpu().numpy()
        absorbs1 = gidx.stats["absorbs"]
        gidx.add([(1 << 59) + i for i in range(len(more))], more_vecs)
        wait_maintenance(gidx, 60.0)
        if gidx.stats["absorbs"] != absorbs1 + 1:
            raise AssertionError(f"the planted absorb did not commit: {gidx.stats}")
        try:
            donation_guard.guard("chip_smoke.planted_use", planted)
        except donation_guard.DonationViolation as exc:
            caught = str(exc)
        else:
            raise AssertionError("the planted use of a pre-write snapshot was not caught")
        if "ivf.absorb" not in caught:
            raise AssertionError(f"the planted violation names another writer: {caught}")
    finally:
        os.environ.pop("PATHWAY_DONATION_GUARD", None)
        os.environ.pop("PATHWAY_DONATION_GUARD_STRICT", None)
    log(
        f"in-place-write guard, armed strict {tag}: {absorbs} absorbs ({written} recorded in-place writes) under "
        f"{n_served} c{ST_CONC} stage-1 serves with 0 violations; planted snapshot caught: {caught[:120]}; "
        f"rescore launches of this phase {rescore_shortlist.launches}; phase {time.perf_counter() - t_phase:.1f} s"
    )
    return rescore_shortlist.launches, decode_launches


def seeded_unit_rows(dev) -> torch.Tensor:
    """Phase 4's seeded unit vectors beside the encoded documents."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = torch.randn(N_ROWS - N_DOCS, DIM, generator=gen, device=dev)
    rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    return rows


def main_rows(tag: str):
    """Phase 4's encoder, its 65,536 encoded documents and the exact index
    of those plus the seeded unit vectors (1,000,000 x 384):
    ``(encoder, docs, doc_vecs, keys, exact)``."""
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    encoder = SentenceEncoder(
        dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768, seed=SEED, dtype=torch.bfloat16,
    )
    docs = corpus(N_DOCS)
    t_tok = time.perf_counter()
    doc_vecs = torch.cat(
        [encoder.encode_to_device(docs[i : i + ENCODE_CHUNK]) for i in range(0, N_DOCS, ENCODE_CHUNK)]
    )
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t_tok
    rand_vecs = seeded_unit_rows(torch.device(DEVICE))
    log(
        f"index rows: {N_DOCS} encoded docs + {N_ROWS - N_DOCS} seeded unit vectors = {N_ROWS} x {DIM}; "
        f"encode {N_DOCS} docs {t_enc:.2f} s ({N_DOCS / t_enc:.0f} docs/s incl. host tokenize) {tag}"
    )
    keys = keys_for(N_ROWS)
    exact = DeviceKnnIndex(DIM, metric="cos", initial_capacity=N_ROWS)
    exact.add_from_device(keys[:N_DOCS], doc_vecs)
    exact.add_from_device(keys[N_DOCS:], rand_vecs)
    return encoder, docs, doc_vecs, keys, exact


def query_ids():
    """Phase 5's query documents: ``N_BATCHES`` batches of ``BATCH``."""
    return [(i * 9973) % N_DOCS for i in range(N_BATCHES * BATCH)]


def serve_batches(docs):
    qidx = query_ids()
    return [[docs[j] for j in qidx[b * BATCH : (b + 1) * BATCH]] for b in range(N_BATCHES)]


# -- phase 16: sharded serve -------------------------------------------------------
SS_SHARDS = 8  # logical shards, round-robin over the visible cards
SS_CALLERS = 16  # bench.py phase_sharded_serve: 16 closed-loop single-query callers,
SS_REQUESTS = 192  # 12 requests each over a pool of 64 eight-word queries
SS_MERGE_REPS = 30  # serves per arm of the merge-share probe
SS_ABSORB = 4096  # fresh rows absorbed under serve
SS_TIE = 1e-6  # mesh exact vs unsharded: score tolerance, and the tie a key swap needs


def sharded_phase(encoder, exact, serve_exact, docs, doc_vecs, keys, batches, tag: str):
    """Phase 16: ``ShardedIvfIndex`` at 8 and 1 shards over the 1M rows,
    ``ShardedForwardIndex`` on the 8-shard group, the mesh-sharded exact
    index beside the unsharded one; scheduler traffic at c16, the checks
    of the sharded tier, and the rescore kernel at one shard's shape.
    Returns (rescore launches of the phase's serves, the kernel record)."""
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch import observe
    from pathway_tpu_torch.index import ForwardIndex, ShardedForwardIndex
    from pathway_tpu_torch.ops import dispatch_counter
    from pathway_tpu_torch.ops.ivf import ShardedIvfIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.parallel import make_mesh
    from pathway_tpu_torch.robust import SHARD_SKIPPED, inject
    from pathway_tpu_torch.serve import ServeScheduler

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    # -- the two IVF arms over phase 4's 1M rows; a shard absorbs past its
    # share of the single index's threshold --
    arms = {}
    for n in (1, SS_SHARDS):
        t0 = time.perf_counter()
        idx = ShardedIvfIndex(DIM, metric="cos", n_shards=n, absorb_threshold=SS_ABSORB // n)
        idx.build_from_matrix(keys, exact._matrix[:N_ROWS])
        torch.cuda.synchronize()
        c = idx.shards[0]
        log(
            f"sharded IVF {tag}: {n} shard(s) over {len(idx)} rows built in {time.perf_counter() - t0:.2f} s; "
            f"shard 0: {len(c)} rows, C={c._centroids.shape[0]} C_pad={c._slabs.shape[0]} M_pad={c._M_pad} "
            f"n_probe={c.probe_count()}; slabs {sum(x._slabs.numel() for x in idx.shards) * 4 / 1e9:.2f} GB"
        )
        arms[n] = FusedEncodeSearch(encoder, idx, k=K)
    s8 = arms[SS_SHARDS]
    idx8, group = s8.index, s8.index.group
    log(
        f"shard group: {group.n_shards} logical shards over {len(group.devices)} visible card(s) "
        f"(torch.cuda.device_count() = {torch.cuda.device_count()}); the shards occupy {group.spans_devices} "
        f"card(s): {'more than one card' if group.spans_devices > 1 else 'one card, no cross-card copy'}"
    )

    # -- traffic: bench.py phase_sharded_serve --
    pool = [" ".join(docs[(i * 9973) % N_DOCS].split()[:8]) for i in range(64)]
    reqs = [pool[(i * 7) % len(pool)] for i in range(SS_REQUESTS)]
    for serve in arms.values():
        for q in pool:
            serve([q], K)
        for b in (2, 4, 8, 16):
            serve(sorted(set(pool))[:b], K)

    def sched_drive(serve):
        sched = ServeScheduler(serve, window_us=SCHED_WINDOW_US, max_batch=SCHED_MAX_BATCH, result_cache=None)
        try:
            qps, lats, rows = drive(lambda q: sched.submit([q], K).result(timeout=TICKET_TIMEOUT_S), reqs, SS_CALLERS)
        finally:
            sched.stop()
        bad = [r for r in rows if not r or not r[0] or r.degraded]
        if bad:
            raise AssertionError(f"sharded drive: {len(bad)} empty or degraded rows, e.g. {bad[0]}")
        return qps, float(np.percentile(lats, 50)), float(np.percentile(lats, 99))

    def shard_hists():
        return [
            observe.histogram("pathway_serve_shard_stage_seconds", stage="dispatch", shard=str(s)).snapshot()
            for s in range(SS_SHARDS)
        ]

    rescore_shortlist.launches = 0
    cells = {}
    for n, serve in arms.items():
        sched_drive(serve)  # unmeasured pass
        before = shard_hists()
        cells[n] = sched_drive(serve)
        if n == SS_SHARDS:
            per_shard_ms = [
                (a[1] - b[1]) / 1e6 / max(1, a[2] - b[2]) for a, b in zip(shard_hists(), before)
            ]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched_drive(s8)
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(
        f"sharded serve c{SS_CALLERS} {tag}, {SS_REQUESTS} requests over 64 queries, k={K}, window "
        f"{SCHED_WINDOW_US:.0f} us, max_batch {SCHED_MAX_BATCH}, no result cache: "
        + "; ".join(f"{n} shard(s) {q:.1f} q/s p50 {p50:.3f} ms p99 {p99:.3f} ms" for n, (q, p50, p99) in cells.items())
        + f"; 8-shard dispatch ms per shard (pathway_serve_shard_stage_seconds, stage=dispatch) "
        + " ".join(f"{ms:.3f}" for ms in per_shard_ms)
        + f"; 8-shard drive under torch.profiler: {device_busy(prof, wall_ms)}"
    )

    # -- 8 shards == 1 shard at full probe, matched composition --
    for serve in arms.values():
        for c in serve.index.shards:
            c.n_probe = c._centroids.shape[0]
    rows = {}
    for n, serve in arms.items():
        with ServeScheduler(serve, window_us=0) as sched:
            rows[n] = [list(sched.serve(pool[i : i + 16], K)) for i in range(0, 64, 16)]
    for serve in arms.values():
        for c in serve.index.shards:
            c.n_probe = None
    differ = sum(1 for a, b in zip(rows[1], rows[SS_SHARDS]) for ra, rb in zip(a, b) if ra != rb)
    log(f"full probe, 64 queries in sorted batches of 16 {tag}: 8 shards vs 1 shard, {differ} rows differ (bit for bit)")
    if differ:
        raise AssertionError(f"8-shard serve differs from 1-shard on {differ} rows at full probe")

    # -- merge share and device merge == host merge --
    probe_q = pool[:16]
    times = {}
    same = True
    for mode in ("device", "host"):
        s8.shard_host_merge = mode == "host"
        s8(probe_q, K)
        samples = []
        for _ in range(SS_MERGE_REPS):
            t0 = time.perf_counter()
            s8(probe_q, K)
            samples.append((time.perf_counter() - t0) * 1e3)
        times[mode] = float(np.percentile(samples, 50))
    for i in range(0, 64, 16):
        s8.shard_host_merge = False
        dev_rows = list(s8(pool[i : i + 16], K))
        s8.shard_host_merge = True
        same &= dev_rows == list(s8(pool[i : i + 16], K))
    s8.shard_host_merge = False
    share = (times["device"] - times["host"]) / times["device"]
    log(
        f"merge share {tag}: device tree merge p50 {times['device']:.3f} ms, host merge p50 {times['host']:.3f} ms "
        f"over {SS_MERGE_REPS} serves of 16 queries: share {100 * share:.2f}%; device merge == host merge on 64 "
        f"queries: {same}"
    )
    if not same:
        raise AssertionError("the device tree merge differs from the host merge")

    # -- the mesh-sharded exact index against the unsharded one --
    rand_vecs = seeded_unit_rows(dev)
    mesh_idx = DeviceKnnIndex(DIM, metric="cos", initial_capacity=N_ROWS, mesh=make_mesh(SS_SHARDS, 1, devices=[dev] * SS_SHARDS))
    mesh_idx.add_from_device(keys[:N_DOCS], doc_vecs)
    mesh_idx.add_from_device(keys[N_DOCS:], rand_vecs)
    del rand_vecs
    rows_equal = torch.equal(mesh_idx._matrix, exact._matrix)
    serve_mesh = FusedEncodeSearch(encoder, mesh_idx, k=K)
    worst = 0.0
    tie_rows = 0
    for texts in batches[:4]:
        for w, g in zip(serve_exact(texts), serve_mesh(texts)):
            if len(w) != len(g):
                raise AssertionError(f"mesh exact returned {len(g)} rows where unsharded returned {len(w)}")
            worst = max([worst] + [abs(a[1] - b[1]) for a, b in zip(w, g)])
            swaps = [j for j, (a, b) in enumerate(zip(w, g)) if a[0] != b[0]]
            for j in swaps:
                near = [w[i][1] for i in (j - 1, j + 1) if 0 <= i < len(w)]
                if abs(w[j][1] - g[j][1]) > SS_TIE or not (j == len(w) - 1 or any(abs(x - w[j][1]) <= SS_TIE for x in near)):
                    raise AssertionError(f"mesh exact: key {g[j]} at {j} where unsharded has {w[j]}, no tie")
            tie_rows += bool(swaps)
    log(
        f"mesh exact {tag}: {SS_SHARDS} row blocks of {mesh_idx.capacity // SS_SHARDS} on the card, rows equal "
        f"the unsharded index's: {rows_equal}; 256 queries: max |score diff| {worst:.3e} (<= {SS_TIE}), "
        f"{tie_rows} rows with keys swapped at a tie within {SS_TIE}"
    )
    if not rows_equal or worst > SS_TIE:
        raise AssertionError("mesh exact index differs from the unsharded one")
    del serve_mesh, mesh_idx

    # -- the sharded forward index; the same ingest batches into one index --
    sfwd = ShardedForwardIndex(encoder, group=group, tokens_per_doc=16, quant="int8")
    one_fwd = ForwardIndex(encoder, tokens_per_doc=16, quant="int8")
    t0 = time.perf_counter()
    for i in range(0, N_DOCS, 8 * FWD_CHUNK):
        sfwd.add(keys[i : i + 8 * FWD_CHUNK], docs[i : i + 8 * FWD_CHUNK])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    for i in range(0, N_DOCS, 8 * FWD_CHUNK):
        ck, ct = keys[i : i + 8 * FWD_CHUNK], docs[i : i + 8 * FWD_CHUNK]
        for _s, at in sorted(group.route(ck).items()):
            one_fwd.add([ck[j] for j in at], [ct[j] for j in at])
    if len(sfwd) != N_DOCS or len(one_fwd) != N_DOCS:
        raise AssertionError(f"forward indexes hold {len(sfwd)} / {len(one_fwd)} of {N_DOCS}")
    stage1 = FusedEncodeSearch(encoder, idx8, k=RR_CANDIDATES)
    stage1.export_query_tokens = True
    calls = [[" ".join(docs[(c * 16 + j) * 4099 % N_DOCS].split()[::2]) for j in range(RR_QUERIES)] for c in range(4)]
    table_equal = True
    for qs in calls:
        handle = stage1.submit(qs, RR_CANDIDATES)
        cands = [[key for key, _ in row] for row in handle()]
        (d8, m8), (d1, m1) = (
            f.gather_submit(handle.query_tokens, handle.query_mask, cands, K, width=RR_CANDIDATES) for f in (sfwd, one_fwd)
        )
        (a8, p8), (a1, p1) = d8(), d1()
        table_equal &= bool(np.array_equal(a8.view(np.int32), a1.view(np.int32)) and np.array_equal(p8, p1) and m8 == m1)
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(encoder, idx8, k=RR_CANDIDATES), forward_index=sfwd, k=K,
                                  candidates=RR_CANDIDATES)
    pipe(calls[0])
    budget = {}
    for name, site in (("healthy", None), ("shard 3 down", "shard.dispatch.3")):
        if site:
            inject.arm(site, "raise")
        try:
            with dispatch_counter.DispatchCounter() as counter:
                got = pipe(calls[1])
        finally:
            if site:
                inject.disarm(site)
        want_flags = (SHARD_SKIPPED,) if site else ()
        if tuple(got.degraded) != want_flags or any(len(r) != K for r in got):
            raise AssertionError(f"sharded retrieve -> MaxSim {name}: flags {got.degraded}, rows {[len(r) for r in got]}")
        budget[name] = (counter.dispatches, counter.fetches, counter.physical_dispatches)
    log(
        f"sharded forward index {tag}: {N_DOCS} docs over {group.n_shards} shards in {ingest_s:.2f} s "
        f"({N_DOCS / ingest_s:.0f} docs/s), per shard {[len(c) for c in sfwd.shards]}; MaxSim table == the unsharded "
        f"index's (same ingest batches), 4 calls of {RR_QUERIES} x {RR_CANDIDATES}: {table_equal}; retrieve -> MaxSim "
        f"dispatches, fetches (physical launches): "
        + ", ".join(f"{name} {d} + {f} ({p})" for name, (d, f, p) in budget.items())
    )
    if not table_equal or any((d, f) != (2, 2) for d, f, _p in budget.values()):
        raise AssertionError("sharded forward table or the 2 + 2 budget failed")

    # -- the dead-shard ladder --
    dead = SS_SHARDS - 1
    flagged = errors = 0
    with inject.armed(f"shard.dispatch.{dead}", "raise"):
        for i in range(16):
            try:
                got = s8([pool[i]], K)
                flagged += SHARD_SKIPPED in got.degraded and bool(got[0])
            except Exception:  # noqa: BLE001 - counted: the ladder must make this 0
                errors += 1
    clean = s8([pool[0]], K)
    log(
        f"dead shard {tag}: shard.dispatch.{dead} armed over 16 serves: {flagged}/16 flagged shard_skipped, "
        f"{errors} errors, skips {group.skips[dead]}; the next serve flags {clean.degraded}"
    )
    if flagged != 16 or errors or clean.degraded:
        raise AssertionError("the dead-shard ladder did not degrade every serve and recover")

    # -- absorb of fresh rows under serve: each lands on its owning shard --
    fresh = [t + " sharded" for t in corpus(SS_ABSORB, seed=SEED + 16)]
    fresh_keys = [(1 << 60) + i for i in range(SS_ABSORB)]
    with torch.no_grad():
        fresh_vecs = torch.cat(
            [encoder.encode_to_device(fresh[i : i + ENCODE_CHUNK]) for i in range(0, SS_ABSORB, ENCODE_CHUNK)]
        ).cpu().numpy()
    stop, serve_errors, spans = threading.Event(), [], []

    def serve_loop():
        i = 0
        while not stop.is_set():
            t_serve = time.perf_counter()
            try:
                got = s8([pool[i % len(pool)]], K)
                if not got[0]:
                    serve_errors.append("empty row")
            except Exception as exc:  # noqa: BLE001 - counted below
                serve_errors.append(repr(exc))
            i += 1
            spans.append((t_serve, time.perf_counter()))

    def served_past(n: int) -> None:
        t_wait = time.perf_counter()
        while len(spans) < n and server.is_alive() and time.perf_counter() - t_wait < 60:
            time.sleep(0.001)

    server = threading.Thread(target=serve_loop, daemon=True)
    server.start()
    try:
        served_past(4)  # the serve loop is warm before the rows land
        t0 = time.perf_counter()
        idx8.add(fresh_keys, fresh_vecs)
        while any(c._absorbing for c in idx8.shards):
            if time.perf_counter() - t0 > 120:
                raise AssertionError("sharded absorb did not finish within 120 s")
            time.sleep(0.01)
        t_done = time.perf_counter()
        absorb_s = t_done - t0
        served_past(len(spans) + 4)  # and serves on over the installed rows
    finally:
        stop.set()
        server.join(60)
    n_during = sum(1 for a, b in spans if a < t_done and b > t0)  # serves overlapping the add and absorbs
    misplaced = sum(
        1 for s, c in enumerate(idx8.shards) for key in fresh_keys
        if (key in c._slot_of_key or key in c._tail) != (group.owner_of(key) == s)
    )
    placed = [i for i, key in enumerate(fresh_keys) if key in idx8.shards[group.owner_of(key)]._slot_of_key]
    for c in idx8.shards:
        c.n_probe = c._centroids.shape[0]
    probe_rows = placed[:: max(1, len(placed) // BATCH)][:BATCH]
    got = s8([fresh[i] for i in probe_rows], K)
    for c in idx8.shards:
        c.n_probe = None
    found = sum(1 for row, i in zip(got, probe_rows) if row and row[0][0] == fresh_keys[i])
    absorbs = [c.stats["absorbs"] for c in idx8.shards]
    launches = rescore_shortlist.launches
    log(
        f"sharded absorb under serve {tag}: {SS_ABSORB} fresh rows, absorbs per shard {absorbs} in {absorb_s:.3f} s "
        f"overlapped by {n_during} serves ({len(spans)} in all, {len(serve_errors)} errors); {len(placed)} placed in "
        f"slab slots, "
        f"{misplaced} rows off their owning shard; full probe ranks the absorbed key first on "
        f"{found}/{len(probe_rows)} rows"
    )
    if (serve_errors or misplaced or min(absorbs) < 1 or found != len(probe_rows) or len(probe_rows) < BATCH
            or n_during < 1):
        raise AssertionError(f"sharded absorb: errors {serve_errors[:3]}, misplaced {misplaced}, found {found}")

    # -- the rescore kernel at one shard's shape (16 queries, shard 0) --
    child = idx8.shards[0]
    ids, mask = encoder.tokenizer.encode_batch(probe_q)
    with torch.no_grad():
        z, _ = s8._embed(ids, mask)
        probe = torch.topk(z @ child._centroids.t(), child.probe_count(), dim=1).indices.to(torch.int32)
        zq = torch.nn.functional.pad(z, (0, child._d_pad - z.shape[1])).contiguous()
    rec = rescore_at_path_shape(child, (probe, zq, child._slabs, child._bias), dev)
    log(f"ivf_rescore at one shard's shape {tag}: " + rescore_line(child, rec) + f"; launches in phase 16 {launches}")
    log(f"phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return launches, rec


# -- phase 17: the multi-process plane ---------------------------------------------
DP_RANKS = 2  # processes sharing the one card
DP_LOCAL_SHARDS = 4  # logical data shards per rank: one 8-shard mesh
DP_BATCHES = 16  # 64-query batches searched per rank
DP_TIMEOUT_S = 300.0  # a rank past this is killed and the phase fails
DP_EXCHANGE_REPS = 50  # all_gathers timed alone
EM_DOCS = 4096  # SentenceEncoder(mesh=...) documents
EM_CHUNK = 2048  # per encode call: blocks of 256 rows on 8 shards
EM_F32_DOCS = 512
RING_L = 16_384
RING_BLOCKS = 8
RING_HEADS = 6
RING_HD = 64
RING_F32_ATOL = 1e-4
RING_BF16_ATOL = 3e-2
RING_REPS = 3  # timed calls of the ring across the ranks, per configuration
RING_SHIFT_REPS = 20  # ring_shift calls timed alone
RING_CASES = tuple((causal, name, dt) for causal in (False, True)
                   for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)))


def dp_rows(dev) -> torch.Tensor:
    """Phase 17's index: 1,000,000 x 384 seeded unit vectors made on the
    card, as phase 4 makes its seeded rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    rows = torch.randn(N_ROWS, DIM, generator=gen, device=dev)
    rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    return rows


def dp_query_rows():
    return [(i * 9973) % N_ROWS for i in range(DP_BATCHES * BATCH)]


def dp_search(index, queries: np.ndarray):
    """``(keys [n, K] uint64, scores [n, K] f32, seconds per batch)`` of
    the index's 64-query batches."""
    keys = np.zeros((len(queries), K), np.uint64)
    scores = np.zeros((len(queries), K), np.float32)
    index.search(queries[:BATCH], K)  # warm-up
    t = time.perf_counter()
    for b in range(0, len(queries), BATCH):
        for i, row in enumerate(index.search(queries[b : b + BATCH], K)):
            keys[b + i] = [key for key, _ in row]
            scores[b + i] = [s for _, s in row]
    return keys, scores, (time.perf_counter() - t) / (len(queries) // BATCH)


def ring_inputs(dev):
    """Phase 17's ring attention inputs at B = 1, L = 16,384, 6 heads of
    64, ~20% of keys masked, made on the card from a seed (the same on
    every rank)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    q, k, v = (torch.randn(1, RING_L, RING_HEADS, RING_HD, generator=gen, device=dev) for _ in range(3))
    kv_mask = torch.rand(1, RING_L, generator=gen, device=dev) > 0.2
    positions = torch.arange(RING_L, device=dev)[None]
    return q, k, v, kv_mask, positions


def ring_across_ranks(dev, grid, out_dir: str) -> dict:
    """Phase 17(b)'s ring arm on this rank: the 8 blocks of an ``("sp",)``
    mesh over both ranks (4 each, the data axis of ``grid``), f32 and
    bf16, full and causal; rank 0 saves each whole output to ``out_dir``
    for the phase's checks.  Returns ms per call, and the shift's bytes
    and ms per step (``ring_shift`` of one block's K, V, mask and
    positions, timed alone)."""
    from pathway_tpu_torch.ops.ring_attention import ring_attention_sharded
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel.mesh import Mesh

    sp = Mesh([grid.data_device(i) for i in range(grid.shape["data"])], axis_names=("sp",), owners=grid.owners)
    q, k, v, kv_mask, positions = ring_inputs(dev)
    out = {"ms": {}, "shift_bytes": {}, "shift_ms": {}}
    for causal, name, dt in RING_CASES:
        args = (q.to(dt), k.to(dt), v.to(dt), kv_mask, positions)
        got = ring_attention_sharded(sp, *args, causal=causal)
        case = f"{'causal' if causal else 'full'} {name}"
        if dist.process_id() == 0:
            torch.save(got.cpu(), os.path.join(out_dir, f"ring {case}.pt"))
        del got
        dist.barrier(f"p17-ring-{case}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(RING_REPS):
            ring_attention_sharded(sp, *args, causal=causal)
        torch.cuda.synchronize()
        out["ms"][case] = (time.perf_counter() - t) * 1e3 / RING_REPS
        if causal:
            continue
        block = RING_L // sp.shape["sp"]
        held = [args[1][:, :block].contiguous(), args[2][:, :block].contiguous(), kv_mask[:, :block].contiguous(),
                positions[:, :block].contiguous()]
        out["shift_bytes"][name] = sum(t.numel() * t.element_size() for t in held)
        dist.ring_shift(held)
        dist.barrier(f"p17-shift-{name}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(RING_SHIFT_REPS):
            dist.ring_shift(held)
        torch.cuda.synchronize()
        out["shift_ms"][name] = (time.perf_counter() - t) * 1e3 / RING_SHIFT_REPS
    return out


def rank_worker(out_dir: str) -> int:
    """One rank of phase 17(b): join the cluster from the topology env,
    check the control plane, build this rank's blocks of the 8-shard
    ``DeviceKnnIndex`` and search it, then ring attention with this rank's
    4 of the 8 sequence blocks (``ring_across_ranks``); keys and scores to
    ``out_dir/rank<r>.npz``, one ``RESULT`` line."""
    from pathway_tpu_torch import observe
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel.mesh import gather_shards, local_shards, make_mesh
    from pathway_tpu_torch.persistence import MemoryBackend
    from pathway_tpu_torch.robust import inject
    from pathway_tpu_torch.serve.warmstate import WarmStateManager

    dist.maybe_initialize()
    rank = dist.process_id()
    degraded = observe.counter("pathway_dist_degraded_total", site="broadcast")
    checks = {"barrier": dist.barrier("p17-start")}
    tick = dist.broadcast_obj({"tick": 17} if dist.is_coordinator() else None, name="p17-tick")
    checks["broadcast"] = tick == {"tick": 17}
    before = degraded.value
    with inject.armed("dist.broadcast", "raise", times=1):
        local = dist.broadcast_obj({"rank": rank}, name="p17-faulted")
    checks["faulted_broadcast_local"] = local == {"rank": rank} and degraded.value == before + 1
    checks["agree_generation"] = WarmStateManager(MemoryBackend(), name="p17").agree_generation(
        17, tag="p17") == (17, True)
    dev = torch.device(DEVICE)
    mesh = make_mesh(devices=[dev] * DP_LOCAL_SHARDS)
    t = time.perf_counter()
    rows = dp_rows(dev)
    index = DeviceKnnIndex(DIM, metric="cos", initial_capacity=N_ROWS, mesh=mesh)
    index.add_from_device(keys_for(N_ROWS), rows)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    queries = rows[dp_query_rows()].cpu().numpy()
    del rows
    exchange = observe.histogram("pathway_serve_shard_stage_seconds", stage="exchange", shard="all")
    n0, s0 = exchange.count, exchange.sum_seconds
    keys, scores, batch_s = dp_search(index, queries)
    n_ex = exchange.count - n0
    # the exchange alone: the same [S_local, B, 2K] f64 candidates staged
    # from the card with no search between, so no rank waits on the
    # other's blocks
    cands = torch.zeros((DP_LOCAL_SHARDS, BATCH, 2 * K), dtype=torch.float64, device=dev)
    gather_shards(mesh, cands)
    dist.barrier("p17-exchange")
    t = time.perf_counter()
    for _ in range(DP_EXCHANGE_REPS):
        gather_shards(mesh, cands)
    alone_ms = (time.perf_counter() - t) * 1e3 / DP_EXCHANGE_REPS
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), keys=keys, scores=scores)
    block_rows = [list(b.shape) for b in index._mats if b is not None]
    del index
    torch.cuda.empty_cache()
    ring = ring_across_ranks(dev, mesh, out_dir)
    checks["done"] = dist.barrier("p17-done")
    out = {
        "rank": rank, "ranks": dist.process_count(), "backend": dist.data_backend(), "checks": checks,
        "shards": mesh.shape["data"], "local": local_shards(mesh),
        "block_rows": block_rows,
        "build_s": build_s, "qps": BATCH / batch_s, "batch_ms": batch_s * 1e3,
        "exchange_ms": (exchange.sum_seconds - s0) * 1e3 / max(1, n_ex), "exchanges": n_ex,
        "exchange_alone_ms": alone_ms, "exchange_bytes": cands.numel() * cands.element_size(), "ring": ring,
    }
    dist.shutdown()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def spawn_ranks(out_dir: str):
    """Phase 17(b)'s ranks as subprocesses of this script; each one's
    RESULT.  A rank past ``DP_TIMEOUT_S`` is killed with the others and
    the phase fails."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(DP_RANKS):
        env = dict(os.environ, PATHWAY_PROCESSES=str(DP_RANKS), PATHWAY_PROCESS_ID=str(rank),
                   PATHWAY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker", out_dir], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    deadline = time.monotonic() + DP_TIMEOUT_S
    results, failures = [], []
    try:
        for rank, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
                status = f"rc={proc.returncode}"
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                out, err = proc.communicate()
                status = "TIMEOUT"
            got = [json.loads(line[7:]) for line in out.splitlines() if line.startswith("RESULT ")]
            if status != "rc=0" or not got:
                failures.append(f"rank {rank} {status}:\n{out[-2000:]}\n{err[-4000:]}")
            else:
                results.append((got[0], err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failures:
        raise AssertionError("phase 17 ranks failed:\n" + "\n".join(failures))
    return results


def multiprocess_phase(encoder, docs, batches, serve_exact, exact_p50_ms: float, tag: str) -> None:
    """Phase 17: the native batch tokenizer, two ranks on the one card
    (control plane and an 8-shard ``DeviceKnnIndex``), the encoder over
    an 8-shard mesh, and ring attention at 16,384 tokens."""
    import tempfile

    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.ops.ring_attention import dense_attention, ring_attention_sharded
    from pathway_tpu_torch.parallel.mesh import Mesh, make_mesh

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)

    # -- (a) the native batch tokenizer against the Python path --
    tok = encoder.tokenizer
    for chunk in [docs[i : i + ENCODE_CHUNK] for i in range(0, N_DOCS, ENCODE_CHUNK)] + batches:
        got, want = tok.encode_batch(chunk), tok._encode_batch_ascii(chunk)
        if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
            raise AssertionError("native tokenizer ids differ from the Python path")
    times = {"native": [], "python": []}
    for _ in range(3):  # alternated passes over the 110 batches (the Python memo warm)
        for name, fn in (("native", tok.encode_batch), ("python", tok._encode_batch_ascii)):
            t = time.perf_counter()
            for texts in batches:
                fn(texts)
            times[name].append((time.perf_counter() - t) * 1e3 / len(batches))
    nat, py = min(times["native"]), min(times["python"])
    log(
        f"tokenizer {tag}: native ids == Python ids on {N_DOCS} documents and {len(batches)} batches of {BATCH}; "
        f"host ms per {BATCH}-query batch (best of 3 alternated passes) native {nat:.4f}, Python {py:.4f} "
        f"({py / nat:.1f}x); stage-1 tokenize share of the exact serve p50 ({exact_p50_ms:.3f} ms): native "
        f"{100 * nat / exact_p50_ms:.2f}%, Python {100 * py / exact_p50_ms:.2f}%; "
        + host_breakdown(serve_exact, batches[:50])
    )

    # -- (b) two ranks on the one card: control plane and an 8-shard index --
    with tempfile.TemporaryDirectory() as out_dir:
        t = time.perf_counter()
        results = spawn_ranks(out_dir)
        ranks_s = time.perf_counter() - t
        per_rank = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(DP_RANKS)]
        keys = [p["keys"] for p in per_rank]
        scores = [p["scores"] for p in per_rank]
        cases = [f"{'causal' if c else 'full'} {n}" for c, n, _dt in RING_CASES]
        ring_across = {case: torch.load(os.path.join(out_dir, f"ring {case}.pt")) for case in cases}
    outs = [r for r, _ in results]
    why = ""
    for o, (_, err) in zip(outs, results):
        said = [line for line in err.splitlines() if "data-plane backend" in line]
        if not all(o["checks"].values()) or o["backend"] != "gloo" or not said:
            raise AssertionError(f"rank {o['rank']}: checks {o['checks']}, backend {o['backend']}")
        why = said[0].split("data-plane backend ", 1)[1]
        if o["shards"] != DP_RANKS * DP_LOCAL_SHARDS or o["block_rows"] != [[N_ROWS // 8, DIM]] * DP_LOCAL_SHARDS:
            raise AssertionError(f"rank {o['rank']}: {o['shards']} shards, blocks {o['block_rows']}")
    rows = dp_rows(dev)
    one = DeviceKnnIndex(DIM, metric="cos", initial_capacity=N_ROWS, mesh=make_mesh(8, 1, devices=[dev] * 8))
    one.add_from_device(keys_for(N_ROWS), rows)
    queries = rows[dp_query_rows()].cpu().numpy()
    del rows
    want_keys, want_scores, one_s = dp_search(one, queries)
    del one
    all_keys = np.asarray(keys_for(N_ROWS), np.uint64)
    self_hit = float(np.mean(want_keys[:, 0] == all_keys[dp_query_rows()]))
    same = [np.array_equal(k, want_keys) and np.array_equal(s.view(np.uint32), want_scores.view(np.uint32))
            for k, s in zip(keys, scores)]
    log(
        f"two ranks on the one card {tag}: data-plane backend {why}; "
        f"control plane barrier / broadcast / faulted broadcast (local value, counted) / agree_generation "
        f"passed on both ranks; DeviceKnnIndex {N_ROWS} x {DIM} f32 on a {outs[0]['shards']}-shard mesh, "
        f"{DP_LOCAL_SHARDS} blocks of {N_ROWS // 8} rows per rank; top-{K} keys and scores of "
        f"{DP_BATCHES} x {BATCH} queries bitwise equal across ranks and to one process's 8-shard mesh: {same}; "
        f"self-hit {self_hit:.4f}; per rank (time-slicing one card, a correctness-first number, not a fleet "
        f"number): "
        + "; ".join(
            f"rank {o['rank']} {o['qps']:.1f} q/s ({o['batch_ms']:.3f} ms per {BATCH}-query search), exchange "
            f"{o['exchange_ms']:.3f} ms per search (all_gather + host staging, waiting for the other rank's "
            f"blocks included, {o['exchanges']} searches), exchange alone {o['exchange_alone_ms']:.3f} ms "
            f"({o['exchange_bytes']} bytes per rank, {DP_EXCHANGE_REPS} all_gathers), build {o['build_s']:.2f} s"
            for o in outs
        )
        + f"; one process, 8 shards: {BATCH / one_s:.1f} q/s ({one_s * 1e3:.3f} ms per search); "
        f"ranks' wall {ranks_s:.1f} s"
    )
    if not all(same) or self_hit != 1.0:
        raise AssertionError(f"2 x 4 shards differ from 1 x 8 (equal per rank: {same}), self-hit {self_hit}")
    log(
        f"ring attention across the two ranks {tag}: B=1 L={RING_L}, {RING_HEADS} heads x {RING_HD}, 8 blocks of "
        f"{RING_L // RING_BLOCKS} on an sp mesh spanning the ranks (4 blocks each, {why}); every rank returns the "
        f"whole output (checked in (d)); "
        + "; ".join(
            f"rank {o['rank']}: " + ", ".join(f"{case} {ms:.3f} ms" for case, ms in o["ring"]["ms"].items())
            + "; shift per step (one block's K, V, mask and positions to the next rank, host-staged): "
            + ", ".join(f"{name} {o['ring']['shift_bytes'][name]} bytes {o['ring']['shift_ms'][name]:.3f} ms"
                        for name in o["ring"]["shift_ms"])
            for o in outs
        )
        + f" ({RING_REPS} calls and {RING_SHIFT_REPS} shifts timed per case)"
    )

    # -- (c) SentenceEncoder over the logical 8-shard mesh --
    mesh8 = make_mesh(8, 1, devices=[dev] * 8)
    texts = docs[:EM_DOCS]

    def encode_rate(enc, chunk):
        enc.encode_to_device(texts[:chunk])  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = torch.cat([enc.encode_to_device(texts[i : i + chunk]) for i in range(0, len(texts), chunk)])
        torch.cuda.synchronize()
        return out, len(texts) / (time.perf_counter() - t)

    sharded = SentenceEncoder(dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768, seed=SEED,
                              dtype=torch.bfloat16, device=dev, mesh=mesh8)
    got, mesh_rate = encode_rate(sharded, EM_CHUNK)
    want, plain_rate = encode_rate(encoder, EM_CHUNK)
    bf16_err = float((got - want).abs().max())
    enc32 = dict(dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768, seed=SEED,
                 dtype=torch.float32, device=dev)
    f32_err = float((SentenceEncoder(mesh=mesh8, **enc32).encode_to_device(texts[:EM_F32_DOCS])
                     - SentenceEncoder(**enc32).encode_to_device(texts[:EM_F32_DOCS])).abs().max())
    log(
        f"SentenceEncoder(mesh=8 logical shards on the one card) {tag}: {EM_DOCS} documents in calls of "
        f"{EM_CHUNK} (blocks of {EM_CHUNK // 8} rows): bf16 max |mesh - unsharded| {bf16_err:.3e} (atol "
        f"{SCHED_TOL}), f32 over {EM_F32_DOCS} documents {f32_err:.3e} (atol 1e-5); {mesh_rate:.0f} docs/s "
        f"sharded, {plain_rate:.0f} docs/s unsharded (host tokenize included)"
    )
    if not (bf16_err <= SCHED_TOL and f32_err <= 1e-5):
        raise AssertionError(f"mesh encoder rows differ: bf16 {bf16_err}, f32 {f32_err}")

    # -- (d) ring attention at 16,384 tokens over 8 blocks --
    q, k, v, kv_mask, positions = ring_inputs(dev)
    ring_mesh = Mesh([dev] * RING_BLOCKS, axis_names=("sp",))
    torch.cuda.empty_cache()
    parts = []
    for causal in (False, True):
        for name, dt, atol in (("f32", torch.float32, RING_F32_ATOL), ("bf16", torch.bfloat16, RING_BF16_ATOL)):
            args = (q.to(dt), k.to(dt), v.to(dt), kv_mask, positions)
            ring = ring_attention_sharded(ring_mesh, *args, causal=causal)
            dense = dense_attention(*args, causal=causal)
            err = float((ring.float() - dense).abs().max())
            across = ring_across[f"{'causal' if causal else 'full'} {name}"].to(dev)
            across_dense = float((across.float() - dense).abs().max())
            across_one = float((across.float() - ring.float()).abs().max())
            del dense
            if not (err <= atol and across_dense <= atol and across_one <= atol and across.dtype == dt
                    and across.shape == ring.shape):
                raise AssertionError(f"ring attention {name} causal={causal}: max err {err}, across the ranks "
                                     f"{across_dense} against dense and {across_one} against one process (atol "
                                     f"{atol}), {across.dtype} {tuple(across.shape)}")
            del across
            ring_ms = timed_ms(lambda: ring_attention_sharded(ring_mesh, *args, causal=causal), reps=3)
            dense_ms = timed_ms(lambda: dense_attention(*args, causal=causal), reps=2)
            parts.append(f"{'causal' if causal else 'full'} {name}: max err {err:.2e} (atol {atol}), ring "
                         f"{ring_ms:.3f} ms, dense {dense_ms:.3f} ms; across the two ranks max err {across_dense:.2e} "
                         f"against dense, {across_one:.2e} against this ring")
            if name == "f32" and not causal:
                ks = sorted(profiled_kernels(lambda: ring_attention_sharded(ring_mesh, *args), reps=1),
                            key=lambda x: -x[1])
                parts.append(
                    f"ring f32 kernels alone {sum(us for _, us, _ in ks) / 1e3:.3f} ms in "
                    f"{sum(n for _, _, n in ks)} launches, top "
                    + ", ".join(f"{key[:48]} {us / 1e3:.3f} ms x{n}" for key, us, n in ks[:3])
                )
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(
        f"ring attention {tag}: B=1 L={RING_L} d_model {RING_HEADS * RING_HD} ({RING_HEADS} heads x {RING_HD}), "
        f"{RING_BLOCKS} blocks of {RING_L // RING_BLOCKS} on the one card, ~20% of keys masked: "
        + "; ".join(parts) + f"; peak allocated so far {peak:.1f} GB"
    )
    log(f"phase 17 in {time.perf_counter() - t_phase:.1f} s")


def tripwire_census() -> str:
    """Every shape-census tripwire of the run: none may have tripped,
    those of collected callables included."""
    from pathway_tpu_torch import observe
    from pathway_tpu_torch.ops.recompile_guard import trips

    gauges = observe.snapshot()["gauges"]
    sigs = {k: v for k, v in gauges.items() if k.startswith("pathway_recompile_signatures")}
    tripped = [k for k, v in gauges.items() if k.startswith("pathway_recompile_tripped") and v]
    if tripped or trips():
        raise AssertionError(f"recompile tripwires tripped: {tripped} {trips()}")
    by_callable = {}
    for k, v in sigs.items():
        name = k.split('callable="', 1)[1].split('"', 1)[0]
        by_callable[name] = max(by_callable.get(name, 0), int(v))
    return f"{len(sigs)} live tripwires, none tripped in the run; largest census per callable {by_callable}"


# the profiler's first sampled call, in a fresh process per run: the card
# test's call (a ~20 ms device sleep on a side stream, then a one-element
# allocation) timed on the host; "prealloc" allocates that element on the
# side stream beforehand, "unprofiled" leaves the profiler out; then the
# first robust import, one event made and recorded, one thread started,
# and the longest stall of the calling thread while another thread waits
# on an event behind the sleep
_FIRST_CALL = r"""
import json, sys, threading, time
sys.path.insert(0, sys.argv[1])
variant = sys.argv[2]
import torch
from pathway_tpu_torch.observe import profile
dev = torch.device("cuda")
side = torch.cuda.Stream()
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
with torch.cuda.stream(side):
    a.record(); torch.cuda._sleep(20_000_000); b.record()
b.synchronize()
cycles = int(20_000_000 * 20.0 / a.elapsed_time(b))
pre = None
if variant == "prealloc":
    with torch.cuda.stream(side):
        pre = torch.empty(1, device=dev)
    torch.cuda.synchronize()
def sleepy():
    torch.cuda._sleep(cycles)
    return pre if pre is not None else torch.empty(1, device=dev)
profile.set_sample(1.0)
fn = sleepy if variant == "unprofiled" else profile.wrap("first.call", sleepy)
out = {"variant": variant, "robust_loaded_before": "pathway_tpu_torch.robust" in sys.modules}
for i in range(3):
    with torch.cuda.stream(side):
        t0 = time.perf_counter(); fn(); out[f"call{i}_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(); profile.drain(10.0)
if variant == "unprofiled":
    t0 = time.perf_counter(); from pathway_tpu_torch.robust import inject; inject.any_armed()
    out["robust_import_ms"] = (time.perf_counter() - t0) * 1e3
    with torch.cuda.stream(side):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter(); ev = torch.cuda.Event(); ev.record(torch.cuda.current_stream(dev))
        out["event_make_record_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter(); th = threading.Thread(target=lambda: None); th.start()
    out["thread_start_ms"] = (time.perf_counter() - t0) * 1e3
    th.join(); torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(cycles); ev.record()
    th = threading.Thread(target=ev.synchronize); th.start()
    last = t0 = time.perf_counter(); gap = 0.0
    while last - t0 < 0.04:
        now = time.perf_counter(); gap = max(gap, now - last); last = now
    th.join()
    out["sync_stall_ms"] = gap * 1e3
print(json.dumps(out))
"""


def first_call_lines(roots, reps: int = 2):
    """One JSON line per fresh process: ``_FIRST_CALL`` for each root and
    variant, roots in turns."""
    lines = []
    for rep in range(reps):
        for root in roots:
            for variant in ("profiled", "prealloc", "unprofiled"):
                got = subprocess.run(
                    [sys.executable, "-c", _FIRST_CALL, os.path.abspath(root), variant],
                    capture_output=True, text=True, timeout=300,
                )
                if got.returncode != 0:
                    raise AssertionError(f"first-call probe {root} {variant}: {got.stderr[-2000:]}")
                lines.append(f"first sampled call, {root}, run {rep}: {got.stdout.strip()}")
    return lines


FRAMING_BYTES = (1_334_500_000, 3_356_000_000)  # phase 12's two snapshots


def framing_compare_line(n_bytes: int) -> str:
    """Host seconds to frame, and to scan and join, a payload of
    ``n_bytes`` cut into ``warmstate.chunk_bytes`` chunks as a snapshot
    section is: plain (``frame`` per copied chunk, joined; ``scan``, then
    join) against bulk (``frame_all`` over views, CRCs on 8 threads;
    ``scan_views``, then join), in turns plain, bulk, bulk, plain.  Both
    must give the same blob and the payload back."""
    from pathway_tpu_torch import config as port_config
    from pathway_tpu_torch.persistence.framing import frame, frame_all, scan, scan_views

    chunk = port_config.get("warmstate.chunk_bytes")
    payload = np.random.default_rng(SEED).bytes(n_bytes)

    def plain():
        t0 = time.perf_counter()
        blob = b"".join(frame(payload[o : o + chunk]) for o in range(0, n_bytes, chunk))
        t1 = time.perf_counter()
        back = b"".join(scan(blob)[0])
        return blob, back == payload, (t1 - t0, time.perf_counter() - t1)

    def bulk():
        t0 = time.perf_counter()
        view = memoryview(payload)
        blob = frame_all([view[o : o + chunk] for o in range(0, n_bytes, chunk)])
        t1 = time.perf_counter()
        back = b"".join(scan_views(blob)[0])
        return blob, back == payload, (t1 - t0, time.perf_counter() - t1)

    times = {"plain": [], "bulk": []}
    blobs, ok = {}, True
    for name in ("plain", "bulk", "bulk", "plain"):
        blob, back_ok, secs = (plain if name == "plain" else bulk)()
        ok = ok and back_ok
        times[name].append(secs)
        if name not in blobs:
            blobs[name] = blob
        del blob
    same = blobs["plain"] == blobs["bulk"]
    del blobs
    if not (ok and same):
        raise AssertionError(f"framing: payload back {ok}, same blob {same}")

    def turns(name):
        return ", ".join(f"{f:.3f} / {sc:.3f}" for f, sc in times[name])

    return (
        f"{n_bytes / 1e9:.3f} GB in {chunk} B chunks, host seconds frame / scan + join per turn: plain "
        f"{turns('plain')}; bulk {turns('bulk')}; same blob and payload back True"
    )


# -- phase 15: real weights ---------------------------------------------------------

# the published shapes of sentence-transformers' all-MiniLM-L6-v2 (its
# config.json on the Hugging Face model card), and of
# cross-encoder/ms-marco-MiniLM-L-6-v2 (the same trunk, a pooler and one
# label); each model's own max sequence length
MINILM = dict(
    vocab_size=30522, hidden_size=384, num_hidden_layers=6, num_attention_heads=12, intermediate_size=1536,
    max_position_embeddings=512, layer_norm_eps=1e-12, type_vocab_size=2,
)
HF_EMBED_MAX_LENGTH = 256
HF_CROSS_MAX_LENGTH = 512
HF_ATOL = 1e-4  # card against CPU, f32 with TF32 off on both
HF_SCORE_ATOL = 1e-5  # a rerank score against predict() of the same pair
N_CLIP = 4096
CLIP_ATOL = 3e-2  # bf16


def minilm_vocab():
    """30,522 lines: the five specials, every word of the corpus and of
    its ``doc<i>`` ids (so documents tokenize to real ids, not [UNK]),
    then filler lines."""
    head = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(dict.fromkeys(_WORDS)) + ["doc"]
    head += [f"##{i}" for i in range(10)]
    return head + [f"[unused{i}]" for i in range(MINILM["vocab_size"] - len(head))]


def clip_texts(n: int):
    rng = np.random.default_rng(SEED + 15)
    return [" ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), 6).tolist()) + f" img{i}" for i in range(n)]


def ivf_search_rescore_args(ivf, queries: np.ndarray):
    """The rescore kernel's inputs of one ``IvfKnnIndex.search`` of host
    ``queries`` (cos metric), made by the search's own steps without
    launching the kernel: ``(probe, zq, slabs, bias)``."""
    z = torch.from_numpy(queries / np.linalg.norm(queries, axis=1, keepdims=True)).to(ivf.device)
    probe = torch.topk(z @ ivf._centroids.t(), ivf.probe_count(), dim=1).indices.to(torch.int32)
    zq = torch.nn.functional.pad(z, (0, ivf._d_pad - z.shape[1])).contiguous()
    return probe, zq, ivf._slabs, ivf._bias


def real_weights_phase(docs, keys, tag: str):
    """Phase 15: local BERT checkpoints at MiniLM-L6 width through the
    embedder, stage 1 on a 1M IVF index, the host-sorted HF rerank and
    the scheduler, then ``ClipModel`` into an IVF index of image rows.
    Returns the rescore launches of its counted drives by path and the
    kernel's records at the HF stage-1 and the CLIP search shapes."""
    import tempfile

    from pathway_tpu_torch.index import ForwardIndex
    from pathway_tpu_torch.models.clip import ClipModel
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.models.hf_import import BertConfig, write_bert_checkpoint
    from pathway_tpu_torch.ops import dispatch_counter
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.serve import ServeScheduler

    dev = torch.device(DEVICE)
    launches = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # -- checkpoints, with the port's own writer --------------------------------
        t0 = time.perf_counter()
        cfg = BertConfig(**MINILM)
        vocab = minilm_vocab()
        emb_dir, ce_dir = os.path.join(tmp, "all-MiniLM-L6-v2"), os.path.join(tmp, "ms-marco-MiniLM-L-6-v2")
        write_bert_checkpoint(emb_dir, cfg, vocab, seed=SEED + 15)
        write_bert_checkpoint(ce_dir, cfg, vocab, seed=SEED + 16, n_labels=1)
        enc = SentenceEncoder(checkpoint_path=emb_dir, max_length=HF_EMBED_MAX_LENGTH)
        ce = CrossEncoderModel(checkpoint_path=ce_dir, max_length=HF_CROSS_MAX_LENGTH)
        n_params = sum(p.numel() for p in enc.module.parameters())
        if not enc.hf or not ce._hf or any(p.dtype != torch.float32 for p in enc.module.parameters()):
            raise AssertionError("the HF checkpoints did not load as f32 BERT modules")
        log(
            f"real weights: 2 seeded checkpoints at all-MiniLM-L6-v2 / ms-marco-MiniLM-L-6-v2 shapes (vocab "
            f"{cfg.vocab_size}, hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers x "
            f"{cfg.num_attention_heads} heads of {cfg.hidden_size // cfg.num_attention_heads}, intermediate "
            f"{cfg.intermediate_size}; {n_params / 1e6:.2f}M embedder parameters, f32) written with the port's "
            f"safetensors writer and loaded in {time.perf_counter() - t0:.2f} s"
        )
        cpu_enc = SentenceEncoder(checkpoint_path=emb_dir, max_length=HF_EMBED_MAX_LENGTH, device="cpu")
        cpu_ce = CrossEncoderModel(checkpoint_path=ce_dir, max_length=HF_CROSS_MAX_LENGTH, device="cpu")

    # -- encode the corpus: tokenize and forward timed apart -----------------------
    tok = enc.tokenizer
    tok_s = [0.0]
    encode_batch = tok.encode_batch

    def timed_encode_batch(*a, **kw):
        t = time.perf_counter()
        out = encode_batch(*a, **kw)
        tok_s[0] += time.perf_counter() - t
        return out

    tok.encode_batch = timed_encode_batch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        doc_vecs = torch.cat(
            [enc.encode_to_device(docs[i : i + ENCODE_CHUNK]) for i in range(0, N_DOCS, ENCODE_CHUNK)]
        )
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    finally:
        del tok.encode_batch
    want = cpu_enc.encode(docs[:ENCODE_CHUNK])
    enc_err = float(np.abs(doc_vecs[:ENCODE_CHUNK].cpu().numpy() - want).max())
    unk = sum(int((tok.encode_batch(docs[i : i + 64])[0] == tok.UNK).sum()) for i in range(0, 1024, 64))
    log(
        f"HF embedder encode {N_DOCS} docs, f32 {tag}: {N_DOCS / enc_s:.0f} docs/s ({enc_s:.2f} s: host WordPiece "
        f"tokenize {tok_s[0]:.2f} s, {N_DOCS / tok_s[0]:.0f} docs/s; upload + forward {enc_s - tok_s[0]:.2f} s, "
        f"{N_DOCS / (enc_s - tok_s[0]):.0f} docs/s); {unk} [UNK] ids in the first 1,024 docs; card vs CPU on "
        f"{ENCODE_CHUNK} rows max abs err {enc_err:.3e}"
    )
    if enc_err > HF_ATOL or unk:
        raise AssertionError(f"HF encode: card vs CPU {enc_err} > {HF_ATOL}, or {unk} [UNK] ids")
    if enc.encode_packed_to_device(docs[:4]).shape != (4, DIM):
        raise AssertionError("HF packed encode did not fall back to the plain encode")

    # -- stage 1: the 1M IVF index, served ------------------------------------------
    rand_vecs = seeded_unit_rows(dev)
    t0 = time.perf_counter()
    ivf = IvfKnnIndex(DIM, metric="cos")
    ivf.build_from_matrix(keys, torch.cat([doc_vecs, rand_vecs]))
    del rand_vecs
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    serve = FusedEncodeSearch(enc, ivf, k=K)
    qidx = query_ids()
    batches = serve_batches(docs)
    serve(batches[0])  # warm
    rescore_shortlist.launches = 0
    lat, hits = [], 0
    for b, texts in enumerate(batches):
        t = time.perf_counter()
        got = serve(texts)
        lat.append((time.perf_counter() - t) * 1e3)
        if got.degraded or len(got) != BATCH or any(len(r) != K for r in got):
            raise AssertionError(f"HF stage 1: wrong shape or degraded {got.degraded}")
        hits += sum(1 for row, j in zip(got, qidx[b * BATCH :]) if row[0][0] == keys[j])
    launches["stage1"] = rescore_shortlist.launches
    if launches["stage1"] != N_BATCHES:
        raise AssertionError(f"HF stage 1 launched the rescore kernel {launches['stage1']} times")
    hf_kernel = rescore_at_path_shape(ivf, stage1_rescore_args(serve, ivf, batches[0]), dev)
    log(
        f"HF stage 1: IVF over {N_DOCS} HF-encoded docs + {N_ROWS - N_DOCS} seeded unit vectors = {N_ROWS} x "
        f"{DIM}, built in {build_s:.2f} s (C={ivf._centroids.shape[0]}, n_probe={ivf.probe_count()}); "
        f"FusedEncodeSearch {N_BATCHES} batches x {BATCH} queries, k={K} {tag}: p50 {np.percentile(lat, 50):.3f} ms "
        f"p90 {np.percentile(lat, 90):.3f} ms; own key first on {hits}/{N_BATCHES * BATCH} at the default probe; "
        f"rescore launches {launches['stage1']}; {host_breakdown(serve, batches[:20])}"
    )
    log(f"kernel ivf_rescore vs plain at the HF stage-1 shape {rescore_line(ivf, hf_kernel)} {tag}")
    # full probe on the encoded documents alone: every document's own key first
    small = IvfKnnIndex(DIM, metric="cos")
    small.build_from_matrix(keys[:N_DOCS], doc_vecs)
    small.n_probe = small._centroids.shape[0]
    host_vecs = doc_vecs.cpu().numpy()
    first = 0
    for i in range(0, N_DOCS, 1024):
        rows = small.search(host_vecs[i : i + 1024], 1)
        first += sum(1 for j, row in enumerate(rows) if row and row[0][0] == keys[i + j])
    served = FusedEncodeSearch(enc, small, k=K)(batches[0])
    served_first = sum(1 for row, j in zip(served, qidx) if row[0][0] == keys[j])
    log(
        f"HF full probe (n_probe={small.n_probe}) on the {N_DOCS}-row index {tag}: own key first for "
        f"{first}/{N_DOCS} stored rows, and for {served_first}/{BATCH} re-encoded documents served"
    )
    if first != N_DOCS or served_first != BATCH:
        raise AssertionError(f"HF full probe: {first}/{N_DOCS}, served {served_first}/{BATCH} own keys first")
    del small

    # -- rerank: the host-sorted HF stage 2 ---------------------------------------------
    doc_text = dict(zip(keys[:N_DOCS], docs))
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(enc, ivf, k=RR_CANDIDATES), ce, doc_text, k=K, candidates=RR_CANDIDATES)
    n_q = RR_CALLS * RR_QUERIES
    targets = [(i * 9973 + 1) % N_DOCS for i in range(n_q)]
    calls = [
        [" ".join(docs[t].split()[::2]) for t in targets[c * RR_QUERIES : (c + 1) * RR_QUERIES]]
        for c in range(RR_CALLS)
    ]
    pipe(calls[0])  # warm
    rescore_shortlist.launches = 0
    rr_lat, mrr = [], 0.0
    with dispatch_counter.DispatchCounter() as counter:
        for c, qs in enumerate(calls):
            t = time.perf_counter()
            got = pipe(qs)
            rr_lat.append((time.perf_counter() - t) * 1e3)
            if got.degraded or len(got) != RR_QUERIES or any(len(r) != K for r in got):
                raise AssertionError(f"HF rerank: wrong shape or degraded {got.degraded}")
            for row, target in zip(got, targets[c * RR_QUERIES :]):
                ranked = [key for key, _ in row]
                if keys[target] in ranked:
                    mrr += 1.0 / (ranked.index(keys[target]) + 1)
    launches["rerank"] = rescore_shortlist.launches
    tags = [t for _, t in counter.events]
    if (counter.dispatches, counter.fetches) != (2 * RR_CALLS, 2 * RR_CALLS) or tags.count("rerank_stage2_host") != 2 * RR_CALLS:
        raise AssertionError(f"HF rerank: {counter.dispatches} + {counter.fetches} for {RR_CALLS} serves")
    if launches["rerank"] != RR_CALLS:
        raise AssertionError(f"HF rerank launched the rescore kernel {launches['rerank']} times")
    # scores are predict() of the same pairs; the order a stable sort of stage 1
    qs = calls[1]
    stage1 = pipe.retriever(qs, RR_CANDIDATES)
    got = pipe(qs)
    score_err, ties = 0.0, 0
    for q, row, s1 in zip(qs, got, stage1):
        scores = ce.predict([(q, doc_text[key]) for key, _ in row])
        score_err = max(score_err, float(np.abs(scores - np.asarray([s for _, s in row])).max()))
        pos = {key: j for j, (key, _) in enumerate(s1)}
        for (ka, sa), (kb, sb) in zip(row, row[1:]):
            if sb > sa or (sb == sa and pos[kb] < pos[ka]):
                raise AssertionError(f"HF rerank order is not a stable descending sort: {row}")
            ties += sb == sa
    cpu_scores = cpu_ce.predict([(qs[0], doc_text[key]) for key, _ in got[0]])
    cpu_err = float(np.abs(cpu_scores - np.asarray([s for _, s in got[0]])).max())
    if score_err > HF_SCORE_ATOL or cpu_err > HF_ATOL:
        raise AssertionError(f"HF rerank scores: vs predict {score_err} > {HF_SCORE_ATOL} or vs CPU {cpu_err}")
    # the reference's refusals: no token states from an HF trunk
    refused = []
    try:
        enc.encode_token_states(qs[:1])
    except NotImplementedError:
        refused.append("encode_token_states NotImplementedError")
    fwd = ForwardIndex(enc, tokens_per_doc=16)
    if fwd.add(keys[:4], docs[:4]) == 0 and fwd.stats["absorb_failures"] == 1:
        refused.append("ForwardIndex.add absorb failure counted")
    try:
        RetrieveRerankPipeline(FusedEncodeSearch(enc, ivf, k=RR_CANDIDATES), doc_text=doc_text, forward_index=fwd)
    except ValueError:
        refused.append("MaxSim pipeline ValueError")
    if len(refused) != 3:
        raise AssertionError(f"HF trunk with a forward index: only {refused}")
    stage2 = []
    for qs in calls[:20]:
        first_handle = pipe.retriever.submit(qs, RR_CANDIDATES)
        hits1 = first_handle()
        t = time.perf_counter()
        pipe._submit_chain(qs, hits1, K)()
        stage2.append((time.perf_counter() - t) * 1e3)
    log(
        f"HF rerank {RR_CALLS} calls x {RR_QUERIES} queries over the {N_ROWS}-row IVF index, {RR_CANDIDATES} candidates, "
        f"k={K}, closed loop {tag}: p50 {np.percentile(rr_lat, 50):.3f} ms p90 {np.percentile(rr_lat, 90):.3f} ms, "
        f"stage 2 alone p50 {np.percentile(stage2, 50):.3f} ms, known-item MRR {mrr / n_q:.4f}; "
        f"{counter.dispatches} dispatches + {counter.fetches} fetches (2 + 2 per serve, stage 2 booked "
        f"rerank_stage2_host); scores vs predict() max abs err {score_err:.3e}, vs the CPU {cpu_err:.3e}; "
        f"order a stable sort ({ties} exact ties); {'; '.join(refused)}; rescore launches {launches['rerank']}"
    )
    log(f"profile HF rerank {tag}: " + profile_serve(pipe, calls[:3]))

    # -- the scheduler over that pipeline (phase 9's traffic) ------------------------------
    pool = [" ".join(docs[(i * 9973) % N_DOCS].split()[:8]) for i in range(64)]
    hot = pool[:4]

    def workload(n: int):
        return [hot[i % 4] if i % 2 == 0 else pool[(i * 7) % 64] for i in range(n)]

    solo = {q: pipe([q], K) for q in pool}
    for b in range(2, SCHED_MAX_BATCH + 1):
        pipe(sorted(set(workload(3 * b)))[:b], K)

    def at_cut(q, want, got) -> bool:
        """Rows that differ only by candidates swapped at the stage-1 cut,
        where stage 1 ties within HF_ATOL (a batch-mate moves an f32
        embedding by ~1e-7), and agree on every other key."""
        s1 = pipe.retriever([q], RR_CANDIDATES + 16)[0]
        cut = s1[RR_CANDIDATES - 1][1]
        near = {key for key, s in s1 if abs(s - cut) <= HF_ATOL}
        diff = {key for key, _ in want} ^ {key for key, _ in got}
        keep = [(key, s) for key, s in want if key not in diff], [(key, s) for key, s in got if key not in diff]
        return bool(diff) and diff <= near and same_ranking(*keep, tie=HF_ATOL, atol=HF_ATOL)

    launches["scheduler"] = 0
    lines, checked, cut_rows = [], 0, 0
    for conc in SCHED_CONC:
        reqs = workload(max(32, 12 * conc))
        rescore_shortlist.launches = 0
        with ServeScheduler(pipe, window_us=SCHED_WINDOW_US, max_batch=SCHED_MAX_BATCH, result_cache=None) as sched:
            qps, lats, rows = drive(lambda q: sched.submit([q], K).result(timeout=TICKET_TIMEOUT_S), reqs, conc)
            n_batches = sched.stats["batches"] + sched.stats["solo"]
        launches["scheduler"] += rescore_shortlist.launches
        if rescore_shortlist.launches != n_batches:
            raise AssertionError(f"HF scheduler c{conc}: {rescore_shortlist.launches} rescore launches, {n_batches} batches")
        for q, got in zip(reqs, rows):
            if got.degraded:
                raise AssertionError(f"HF scheduler c{conc}: {q!r} degraded {got.degraded}")
            if not same_ranking(solo[q][0], got[0], tie=HF_ATOL, atol=HF_ATOL):
                if not at_cut(q, solo[q][0], got[0]):
                    raise AssertionError(f"HF scheduler c{conc}: {q!r} got {got[0]}, alone {solo[q][0]}")
                cut_rows += 1
        checked += len(rows)
        lines.append(
            f"c{conc} ({len(reqs)} requests) {qps:.1f} q/s p50 {np.percentile(lats, 50):.3f} ms "
            f"p90 {np.percentile(lats, 90):.3f} ms, {n_batches} batches"
        )
    log(
        f"HF scheduler over the HF rerank (window {SCHED_WINDOW_US:.0f} us, max_batch {SCHED_MAX_BATCH}, no result "
        f"cache) {tag}: " + "; ".join(lines) + f"; {checked} rows equal the text served alone within {HF_ATOL} "
        f"({cut_rows} of them up to candidates swapped at a stage-1 tie within {HF_ATOL} at the "
        f"{RR_CANDIDATES}-candidate cut); rescore launches {launches['scheduler']}"
    )
    del pipe, serve, ivf, doc_vecs, host_vecs
    torch.cuda.empty_cache()

    # -- CLIP: image rows in an IVF index, searched by text rows ----------------------------
    clip = ClipModel()
    cpu_clip = ClipModel(device="cpu")
    images = np.random.default_rng(SEED + 17).random((N_CLIP, clip.image_size, clip.image_size, 3), dtype=np.float32)
    texts = clip_texts(N_CLIP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_rows = np.concatenate([clip.encode_image(images[i : i + 256]) for i in range(0, N_CLIP, 256)])
    img_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    txt_rows = np.concatenate([clip.encode_text(texts[i : i + 256]) for i in range(0, N_CLIP, 256)])
    txt_s = time.perf_counter() - t0
    img_err = float(np.abs(cpu_clip.encode_image(images[:64]) - img_rows[:64]).max())
    txt_err = float(np.abs(cpu_clip.encode_text(texts[:64]) - txt_rows[:64]).max())
    if img_err > CLIP_ATOL or txt_err > CLIP_ATOL or not np.isfinite(img_rows).all():
        raise AssertionError(f"CLIP card vs CPU: image {img_err}, text {txt_err} > {CLIP_ATOL}")
    clip_keys = keys_for(N_CLIP)
    civf = IvfKnnIndex(clip.proj_dim, metric="cos")
    civf.add(clip_keys, img_rows)
    civf.build()
    rescore_shortlist.launches = 0
    t0 = time.perf_counter()
    found = [civf.search(txt_rows[i : i + BATCH], K) for i in range(0, N_CLIP, BATCH)]
    search_s = time.perf_counter() - t0
    launches["clip"] = rescore_shortlist.launches
    if launches["clip"] != N_CLIP // BATCH or any(len(r) != K for rows_ in found for r in rows_):
        raise AssertionError(f"CLIP search: {launches['clip']} rescore launches, or short rows")
    clip_kernel = rescore_at_path_shape(civf, ivf_search_rescore_args(civf, txt_rows[:BATCH]), dev)
    # full probe equals the exact top-10 of the same rows
    civf.n_probe = civf._centroids.shape[0]
    full = civf.search(txt_rows[:BATCH], K)
    sims = txt_rows[:BATCH] @ img_rows.T / np.linalg.norm(img_rows, axis=1)[None]
    order = np.argsort(-sims, axis=1, kind="stable")[:, :K]
    exact_rows = [[(clip_keys[j], float(sims[qi, j])) for j in order[qi]] for qi in range(BATCH)]
    mismatched = sum(1 for w, g in zip(exact_rows, full) if not same_ranking(w, g))
    if mismatched:
        raise AssertionError(f"CLIP IVF at full probe differs from exact on {mismatched} rows")
    log(
        f"CLIP (default ClipModel: 256 wide, 4 layers, 4 heads, 64 x 64 images in 16 x 16 patches, bf16) {tag}: "
        f"{N_CLIP} seeded images encoded in {img_s:.2f} s ({N_CLIP / img_s:.0f} images/s), their texts in "
        f"{txt_s:.2f} s; card vs CPU on 64 max abs err image {img_err:.3e} text {txt_err:.3e}; IVF of the image "
        f"rows (C={civf._centroids.shape[0]}, d={clip.proj_dim}) searched by the {N_CLIP} text rows in "
        f"{N_CLIP // BATCH} batches of {BATCH}, {search_s:.2f} s; full probe equals exact on {BATCH}/{BATCH} rows; "
        f"rescore launches {launches['clip']}"
    )
    log(f"kernel ivf_rescore vs plain at the CLIP search shape {rescore_line(civf, clip_kernel)} {tag}")
    log(f"phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return launches, hf_kernel, clip_kernel


# -- phase 18: the serve fabric ----------------------------------------------------
SF_HOSTS = 3  # bench.py phase_serve_fabric: a 3-worker replica group
SF_CALLERS = 16  # closed-loop single-query callers
SF_REQUESTS = 96  # per drive, over a pool of SF_POOL eight-word queries
SF_POOL = 32
SF_BOUNCE_CALLERS = 8  # the rolling bounce's continuous callers
SF_HB_S, SF_HB_TIMEOUT_S = 0.1, 0.5  # bench.py:3327-3334
PF_PARTS = 3  # partitions of the partitioned fleet; partition i owns key % 3 == i
PF_ID_BATCHES = 8  # whole batches of 16 of phase 5's queries for H = 3 == H = 1
PF_FRESH = 1024  # fresh documents committed through fabric.connector()
PF_WINDOW_US = 1_500_000.0  # the front window an absorb lands inside


def fabric_cascade(encoder, ivf, docs, keys):
    """Phase 8's cascade over ``ivf`` (forward index of the 65,536
    documents, the cross-encoder, MaxSim then cross-encoder over the top
    10), for ``--fabric`` alone."""
    from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    fwd, ce, _ingest_s = forward_and_cross_encoder(encoder, docs, keys)
    return RetrieveRerankPipeline(
        FusedEncodeSearch(encoder, ivf, k=RR_CANDIDATES), ce, dict(zip(keys[:N_DOCS], docs)), k=K,
        candidates=RR_CANDIDATES, forward_index=fwd, cascade=K,
    )


def _wait(pred, timeout_s: float, what: str) -> None:
    t_end = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"fabric phase: {what} within {timeout_s} s")
        time.sleep(0.005)


def _killer(front, kill):
    """Kill host 0 once it holds an in-flight request (mid-burst)."""
    def run():
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30 and front._links[0].inflight == 0:
            time.sleep(0.001)
        kill()

    return threading.Thread(target=run, daemon=True)


def fabric_phase(encoder, exact, serve_exact, cascade, docs, doc_vecs, keys, batches, tag: str):
    """Phase 18: (a) a replica fleet of 3 ``FabricWorker``s, each its own
    ``ServeScheduler`` over the cascade on the 1M IVF, behind one
    ``ServeFabric`` (bench.py ``phase_serve_fabric``); (b) partitioned
    fleets of H = 3 and H = 1 over phase 4's 1M rows, each host
    ``FusedEncodeSearch`` over its own IVF -> ``ServeScheduler(window 0)``
    -> ``FabricWorker`` with a ``LiveIngestRunner`` (``phase_partitioned_fabric``).
    Returns (rescore launches of the phase's serves, the kernel record at
    one partition's shape)."""
    import math

    from pathway_tpu_torch import robust
    from pathway_tpu_torch.cache import ResultCache, query_key
    from pathway_tpu_torch.ops import dispatch_counter
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.persistence import MemoryBackend
    from pathway_tpu_torch.robust import HOST_FAILOVER, PARTITION_LOST, REPLICA_LOST
    from pathway_tpu_torch.serve import (
        FabricWorker, LiveIngestRunner, ServeFabric, ServeScheduler, WarmStateManager, fabric_token,
    )

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    env_prev = {k: os.environ.get(k) for k in ("PATHWAY_FABRIC_HEARTBEAT", "PATHWAY_FABRIC_HEARTBEAT_TIMEOUT")}
    os.environ["PATHWAY_FABRIC_HEARTBEAT"] = str(SF_HB_S)
    os.environ["PATHWAY_FABRIC_HEARTBEAT_TIMEOUT"] = str(SF_HB_TIMEOUT_S)
    pool = [" ".join(docs[(i * 9973) % N_DOCS].split()[:8]) for i in range(SF_POOL)]
    reqs = [pool[(i * 7) % SF_POOL] for i in range(SF_REQUESTS)]
    rescore_shortlist.launches = 0
    try:
        # ==== (a) the replica fleet over the cascade ====
        # every composition a host's window can form is built before the
        # fleet starts, so no first touch stalls a pong
        for q in pool:
            cascade([q], K)
        for b in range(2, SCHED_MAX_BATCH + 1):
            cascade(sorted(set(pool))[:b], K)
        with dispatch_counter.DispatchCounter() as counter:
            cascade([pool[0]], K)
        per_serve = (counter.dispatches, counter.fetches)
        token = fabric_token()
        names = [f"chip-sf-{i}" for i in range(SF_HOSTS)]

        def scheduler():
            return ServeScheduler(cascade, window_us=SCHED_WINDOW_US, max_batch=SCHED_MAX_BATCH, result_cache=None)

        scheds = [scheduler() for _ in range(SF_HOSTS)]
        workers = [FabricWorker(scheds[i], token=token, name=names[i]) for i in range(SF_HOSTS)]
        front = ServeFabric({w.name: w.address for w in workers}, token, name="chip-fabric")
        local = scheduler()
        try:
            if front.connect() != SF_HOSTS:
                raise AssertionError("the front did not reach every host")
            differ = sum(1 for q in pool if list(front.serve([q], K)) != list(local.serve([q], K)))
            if differ:
                raise AssertionError(f"fabric rows differ from the in-process scheduler's on {differ} pool queries")

            def serve_one(q):
                return front.serve([q], K)

            def opens():
                return sum(robust.breaker(f"fabric:{n}").stats["opens"] for n in names)

            drive(serve_one, reqs, SF_CALLERS)  # unmeasured pass
            opens0, fail0 = opens(), front.stats["failover"]
            qps_h, lats_h, rows_h = drive(serve_one, reqs, SF_CALLERS)
            false_downs = opens() - opens0
            bad = [r for r in rows_h if not r or len(r[0]) != K or r.degraded]
            if bad or false_downs or front.stats["failover"] != fail0 or not all(l.up() for l in front._links):
                raise AssertionError(f"healthy fleet: {len(bad)} bad rows, {false_downs} false host-downs")

            # -- kill one host mid-burst: every request answered, the
            # affected ones flagged host_failover with a survivor's rows --
            def crash():
                workers[0].kill()
                scheds[0].stop()

            killer = _killer(front, crash)
            killer.start()
            qps_k, lats_k, rows_k = drive(serve_one, reqs, SF_CALLERS)
            killer.join(60)
            flagged = [i for i, r in enumerate(rows_k) if HOST_FAILOVER in r.degraded]
            bad = [r for r in rows_k if not r or len(r[0]) != K or REPLICA_LOST in r.degraded]
            wrong_host = [i for i in flagged if rows_k[i].meta.get("fabric_host") == names[0]]
            state0 = robust.breaker(f"fabric:{names[0]}").state
            reroute = [float(lats_k[i]) for i in flagged]
            if not flagged or bad or wrong_host or state0 == "closed":
                raise AssertionError(
                    f"kill: {len(flagged)} flagged, {len(bad)} unanswered, {len(wrong_host)} from the dead host, "
                    f"breaker {state0}"
                )

            # -- one solo serve's dispatches + fetches per batch on the
            # surviving hosts --
            def survivor_batches():
                return sum(scheds[i].stats["batches"] + scheds[i].stats["solo"] for i in range(1, SF_HOSTS))

            b0 = survivor_batches()
            with dispatch_counter.DispatchCounter() as counter:
                drive(serve_one, pool[:8], 8)
            n_batches = max(1, survivor_batches() - b0)
            if counter.dispatches > per_serve[0] * n_batches or counter.fetches > per_serve[1] * n_batches:
                raise AssertionError(f"survivors: {counter.dispatches} + {counter.fetches} for {n_batches} batches")
            budget = (counter.dispatches, counter.fetches, n_batches)

            # -- the writer's warm state, which a replacement restores
            # before it joins: the 65,536-document IVF index --
            writer = IvfKnnIndex(DIM, metric="cos")
            writer.build_from_matrix(keys[:N_DOCS], doc_vecs)
            probe_q = pool[:16]
            want_rows = list(FusedEncodeSearch(encoder, writer, k=K)(probe_q, K))
            backend = MemoryBackend()
            if WarmStateManager(backend, name="chip-sf", components={"ivf": writer}).snapshot() is None:
                raise AssertionError("the writer's snapshot failed")
            torch.cuda.synchronize()
            t0 = time.perf_counter()  # cold: re-embed the corpus, build, first search
            vecs = torch.cat(
                [encoder.encode_to_device(docs[i : i + ENCODE_CHUNK]) for i in range(0, N_DOCS, ENCODE_CHUNK)]
            )
            cold = IvfKnnIndex(DIM, metric="cos")
            cold.build_from_matrix(keys[:N_DOCS], vecs)
            FusedEncodeSearch(encoder, cold, k=K)(probe_q[:1], K)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            del vecs, cold
            warm_s = []

            def restart(i: int) -> None:
                """Stop host i (bye), bring up a replacement restored from
                the writer's warm state on the same port, wait for it to
                re-join."""
                port = workers[i].port
                link = front._links[i]
                workers[i].stop()
                scheds[i].stop()
                _wait(lambda: not link.up(), 5, f"host {i}'s bye reaching the front")
                torch.cuda.synchronize()
                t_w = time.perf_counter()
                replica = IvfKnnIndex(DIM, metric="cos")
                report = WarmStateManager(backend, name="chip-sf", components={"ivf": replica}).restore()
                got = list(FusedEncodeSearch(encoder, replica, k=K)(probe_q, K))
                torch.cuda.synchronize()
                warm_s.append(time.perf_counter() - t_w)
                if not report.restored or got != want_rows:
                    raise AssertionError(f"replacement {i}: restored {report.restored}, rows equal {got == want_rows}")
                scheds[i] = scheduler()
                t_bind = time.monotonic()
                while True:
                    try:
                        workers[i] = FabricWorker(scheds[i], host="127.0.0.1", port=port, token=token, name=names[i])
                        break
                    except OSError:
                        if time.monotonic() - t_bind > 15:
                            raise
                        time.sleep(0.05)
                probes = (f"rejoin probe {j}" for j in itertools.count())

                def rejoined() -> bool:
                    q = next(q for q in probes if front._affinity(q) == i)
                    return front.serve([q], K).meta.get("fabric_host") == names[i]

                _wait(rejoined, 30, f"host {i} re-joining")

            restart(0)  # the killed host comes back
            # -- a planned stop() drains: new admissions re-route --
            workers[1].stop()
            scheds[1].stop()
            _wait(lambda: not front._links[1].up(), 5, "the drained host's bye reaching the front")
            drained = [front.serve([q], K) for q in pool[:8]]
            if any(not r or not r[0] or r.meta.get("fabric_host") == names[1] or REPLICA_LOST in r.degraded
                   for r in drained):
                raise AssertionError("a drained host was served from, or a request was lost")
            restart(1)

            # -- rolling bounce of all three under continuous load --
            stop_serving = threading.Event()
            bounce_lats, bounce_errs = [], []
            lock = threading.Lock()

            def bounce_caller(qi: int):
                while not stop_serving.is_set():
                    t_r = time.perf_counter()
                    try:
                        got = front.serve([pool[qi % SF_POOL]], K)
                        with lock:
                            bounce_lats.append((time.perf_counter() - t_r) * 1e3)
                            if not (len(got) == 1 and got[0]):
                                bounce_errs.append(("empty", got.degraded))
                    except Exception as exc:  # noqa: BLE001 - counted: must stay 0
                        with lock:
                            bounce_errs.append(("raise", repr(exc)))
                    qi += SF_BOUNCE_CALLERS

            bounce_callers = [threading.Thread(target=bounce_caller, args=(t,), daemon=True) for t in range(SF_BOUNCE_CALLERS)]
            t_b = time.perf_counter()
            for t in bounce_callers:
                t.start()
            try:
                for i in range(SF_HOSTS):
                    restart(i)
            finally:
                stop_serving.set()
                for t in bounce_callers:
                    t.join(60)
            bounce_s = time.perf_counter() - t_b
            closed = [robust.breaker(f"fabric:{n}").state for n in names]
            if bounce_errs or len(bounce_lats) < 20 or any(s != "closed" for s in closed):
                raise AssertionError(f"rolling bounce: errors {bounce_errs[:3]}, {len(bounce_lats)} served, {closed}")
            blat = np.asarray(bounce_lats)
            log(
                f"replica fabric {tag}: {SF_HOSTS} FabricWorkers (ServeScheduler window {SCHED_WINDOW_US:.0f} us, max "
                f"batch {SCHED_MAX_BATCH}, no result cache) over the cascade on the 1M IVF, one ServeFabric front "
                f"(heartbeat {SF_HB_S} s, timeout {SF_HB_TIMEOUT_S} s), c{SF_CALLERS}, {SF_REQUESTS} requests over "
                f"{SF_POOL} queries: {SF_POOL} pool queries through the fabric == the in-process scheduler bit for bit; "
                f"healthy {qps_h:.1f} q/s p50 {np.percentile(lats_h, 50):.3f} ms p99 {np.percentile(lats_h, 99):.3f} ms, "
                f"{false_downs} false host-downs ({front.stats['stalled_ticks']} heartbeat ticks in the phase came "
                f"after a stall of the front itself and restarted the silence clocks); kill host 0 mid-burst {qps_k:.1f} q/s p50 "
                f"{np.percentile(lats_k, 50):.3f} ms p99 {np.percentile(lats_k, 99):.3f} ms, {len(flagged)} requests "
                f"flagged host_failover with a survivor's rows, 0 unanswered, 0 exceptions, breaker {state0}; re-route "
                f"ms of the flagged: p50 {np.percentile(reroute, 50):.3f} max {max(reroute):.3f}; survivors "
                f"{budget[0]} dispatches + {budget[1]} fetches for {budget[2]} batches (solo serve {per_serve[0]} + "
                f"{per_serve[1]}); stop() drain re-routed 8 of 8; rolling bounce of all {SF_HOSTS} under "
                f"{SF_BOUNCE_CALLERS} callers: {len(blat)} requests in {bounce_s:.2f} s ({len(blat) / bounce_s:.1f} "
                f"q/s) p50 {np.percentile(blat, 50):.3f} ms p99 {np.percentile(blat, 99):.3f} ms, 0 errors, breakers "
                f"{closed}; replacement bring-up: warm restore + first search "
                + ", ".join(f"{s:.3f}" for s in warm_s)
                + f" s against cold (encode {N_DOCS} docs + build + first search) {cold_s:.3f} s"
            )
        finally:
            front.stop()
            for w in workers:
                w.stop()
            for s in scheds + [local]:
                s.stop()
        launches_a = rescore_shortlist.launches

        # ==== (b) partitioned fleets over phase 4's 1M rows ====
        owner = np.asarray([k % PF_PARTS for k in keys], dtype=np.int64)
        t0 = time.perf_counter()
        h1 = IvfKnnIndex(DIM, metric="cos")
        h1.build_from_matrix(keys, exact._matrix[:N_ROWS])
        parts = []
        for p in range(PF_PARTS):
            rows_p = np.nonzero(owner == p)[0]
            idx = IvfKnnIndex(DIM, metric="cos")
            idx.build_from_matrix([keys[j] for j in rows_p.tolist()],
                                  exact._matrix[torch.from_numpy(rows_p).to(dev)])
            parts.append(idx)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        C = h1._centroids.shape[0]
        p_main = h1.probe_count()
        for idx in parts:
            idx.n_probe = math.ceil(p_main * idx._centroids.shape[0] / C)
        bytes1 = sum(h1.hbm_bytes().values())
        bytes3 = [sum(idx.hbm_bytes().values()) for idx in parts]
        if sum(len(idx) for idx in parts) != N_ROWS or any(
            k % PF_PARTS != p for p, idx in enumerate(parts) for k in idx._slot_of_key
        ):
            raise AssertionError("the partitions do not hold the 1M rows, each on its owner")

        class _Fleet:
            def __init__(self, indexes, tag_):
                self.names = [f"chip-pf{tag_}-{i}" for i in range(len(indexes))]
                self.token = fabric_token()
                self.indexes = indexes
                self.serves = [FusedEncodeSearch(encoder, idx, k=K) for idx in indexes]
                for serve in self.serves:  # every composition before the fleet starts
                    for q in pool:
                        serve([q], K)
                    for b in (2, 4, 8, 16):
                        serve(sorted(set(pool))[:b], K)
                self.scheds = [ServeScheduler(s, window_us=0, result_cache=None) for s in self.serves]
                self.runners = [LiveIngestRunner(encoder, idx, name=f"{n}-ing") for idx, n in zip(indexes, self.names)]
                self.workers = [FabricWorker(s, token=self.token, name=n, ingest=r)
                                for s, n, r in zip(self.scheds, self.names, self.runners)]
                self.fabric = ServeFabric({w.name: w.address for w in self.workers}, self.token,
                                          name=f"chip-pfab{tag_}", partitions=len(indexes))
                if self.fabric.connect() != len(indexes):
                    raise AssertionError("the partitioned front did not reach every host")
                self._probe = [idx.n_probe for idx in indexes]

            def full_probe(self, on: bool) -> None:
                for idx, p in zip(self.indexes, self._probe):
                    idx.n_probe = idx._centroids.shape[0] if on else p

            def stop(self) -> None:
                self.fabric.stop()
                for w in self.workers:
                    w.stop()
                for r in self.runners:
                    r.stop()
                for s in self.scheds:
                    s.stop()

        fleet3 = _Fleet(parts, "3")
        fleet1 = _Fleet([h1], "1")
        try:
            # -- H = 3 == H = 1 bit for bit at full probe, whole batches of 16 --
            id_batches = [batches[b // 4][(b % 4) * 16 : (b % 4 + 1) * 16] for b in range(PF_ID_BATCHES)]
            for f in (fleet3, fleet1):
                f.full_probe(True)
            got3 = [list(fleet3.fabric.serve(b, K)) for b in id_batches]
            got1 = [list(fleet1.fabric.serve(b, K)) for b in id_batches]
            for f in (fleet3, fleet1):
                f.full_probe(False)
            differ = sum(1 for a, b in zip(got3, got1) for ra, rb in zip(a, b) if ra != rb)
            if differ:
                raise AssertionError(f"H = 3 differs from H = 1 on {differ} rows at full probe")

            # -- the scatter's booking: 1 logical + 3 physical, hosts within 2 + 2 --
            with dispatch_counter.DispatchCounter() as counter:
                res = fleet3.fabric.serve([pool[0]], K)
            disp = [t for kind, t in counter.events if kind == "dispatch"]
            fet = [t for kind, t in counter.events if kind == "fetch"]
            host_disp = [t for t in disp if t != "fabric.scatter"]
            host_fet = [t for t in fet if t != "fabric.gather"]
            with dispatch_counter.DispatchCounter(mode="physical") as phys:
                fleet3.fabric.serve([pool[0]], K)
            if (res.degraded or disp.count("fabric.scatter") != 1 or fet.count("fabric.gather") != 1
                    or len(host_disp) > 2 * PF_PARTS or len(host_fet) > 2 * PF_PARTS or phys.physical_dispatches < PF_PARTS + 1):
                raise AssertionError(f"scatter booking: {counter.events}, physical {phys.physical_dispatches}")

            # -- scatter-gather at c16 at phase 4's probe share; recall vs exact --
            want = {q: {k for k, _ in serve_exact([q], K)[0]} for q in pool}
            cells = {}
            for name, f in (("H=1", fleet1), ("H=3", fleet3)):
                def serve_p(q, f=f):
                    return f.fabric.serve([q], K)

                drive(serve_p, reqs, SF_CALLERS)  # unmeasured pass
                qps, lats, rows = drive(serve_p, reqs, SF_CALLERS)
                bad = [r for r in rows if not r or len(r[0]) != K or r.degraded]
                if bad:
                    raise AssertionError(f"{name}: {len(bad)} bad rows, e.g. {bad[0].degraded}")
                recall = float(np.mean([len({k for k, _ in r[0]} & want[q]) / K for q, r in zip(reqs, rows)]))
                cells[name] = (qps, float(np.percentile(lats, 50)), float(np.percentile(lats, 99)), recall)

            # -- owner-routed absorb: one document, then 1,024 --
            before = fleet3.fabric.poll_generations()
            k_one = next(k for k in itertools.count(1 << 58) if k % PF_PARTS == 1)
            conn = fleet3.fabric.connector("chip-one")
            conn.insert(k_one, "owner routed fabric sentinel document about partition maps")
            if conn.commit() != 1 or not fleet3.runners[1].flush(timeout=60):
                raise AssertionError("the sentinel's absorb was not accepted")
            _wait(lambda: fleet3.fabric.poll_generations() != before, 10, "the sentinel's generation bump")
            after = fleet3.fabric.index_generation()
            moved_one = [i for i in range(PF_PARTS) if after[i] != before[i]]
            if moved_one != [1]:
                raise AssertionError(f"one absorb moved the generation entries {moved_one}: {before} -> {after}")
            fresh = [t + " fabric" for t in corpus(PF_FRESH, seed=SEED + 18)]
            fresh_keys = [(1 << 59) + i for i in range(PF_FRESH)]
            rates, under = {}, {}
            for name, f in (("H=3", fleet3), ("H=1", fleet1)):
                sizes0 = [len(idx) for idx in f.indexes]
                gens0 = f.fabric.poll_generations()
                c = f.fabric.connector(f"chip-{name}")
                c.insert_rows(zip(fresh_keys, fresh))
                # one caller serves through the fleet while the owners absorb:
                # the IVF's absorb and search locks under routed ingest
                stop_serving, served, serve_errs = threading.Event(), [0], []

                def serve_loop(f=f, stop_serving=stop_serving, served=served, serve_errs=serve_errs):
                    while not stop_serving.is_set():
                        try:
                            r = f.fabric.serve([pool[served[0] % SF_POOL]], K)
                            if not r or not r[0] or r.degraded:
                                serve_errs.append(r.degraded)
                        except Exception as exc:  # noqa: BLE001 - counted: must stay 0
                            serve_errs.append(repr(exc))
                        served[0] += 1

                server = threading.Thread(target=serve_loop, daemon=True)
                server.start()
                try:
                    t_a = time.perf_counter()
                    accepted = c.commit()
                    flushed = all(r.flush(timeout=120) for r in f.runners)
                    rates[name] = PF_FRESH / (time.perf_counter() - t_a)
                finally:
                    stop_serving.set()
                    server.join(60)
                under[name] = served[0]
                if accepted != PF_FRESH or not flushed or serve_errs:
                    raise AssertionError(
                        f"{name}: {accepted} of {PF_FRESH} accepted, flushed {flushed}, serve errors {serve_errs[:3]}"
                    )
                owned = [sum(1 for k in fresh_keys if k % len(f.indexes) == i) for i in range(len(f.indexes))]
                grown = [len(idx) - s for idx, s in zip(f.indexes, sizes0)]
                misplaced = sum(
                    1 for i, idx in enumerate(f.indexes) for k in fresh_keys
                    if ((k in idx._slot_of_key or k in idx._tail) != (k % len(f.indexes) == i))
                )
                _wait(lambda: all(g > g0 for g, g0 in zip(f.fabric.poll_generations(), gens0)), 10,
                      f"{name}'s owners' generation bumps")
                if grown != owned or misplaced:
                    raise AssertionError(f"{name}: grew {grown} for owned {owned}, {misplaced} rows off their owner")
            fleet3.full_probe(True)
            found = 0
            for i in range(0, PF_FRESH, 16):
                rows = fleet3.fabric.serve(fresh[i : i + 16], K)
                found += sum(1 for row, k in zip(rows, fresh_keys[i : i + 16]) if row and row[0][0] == k)
            fleet3.full_probe(False)
            if found != PF_FRESH:
                raise AssertionError(f"full probe found {found} of {PF_FRESH} absorbed documents by their own text")

            # -- an absorb inside an open window: served, never cached --
            cache = ResultCache()
            slow = ServeScheduler(fleet3.fabric, window_us=PF_WINDOW_US, result_cache=cache, name="chip-pf-front")
            try:
                q = pool[3]
                g_adm = fleet3.fabric.poll_generations()
                ticket = slow.submit([q], K)
                k_win = next(k for k in itertools.count(1 << 57) if k % PF_PARTS == 2)
                cw = fleet3.fabric.connector("chip-window")
                cw.insert(k_win, f"window absorb about {q}")
                if cw.commit() != 1 or not fleet3.runners[2].flush(timeout=30):
                    raise AssertionError("the in-window absorb was not accepted")
                _wait(lambda: fleet3.fabric.poll_generations() != g_adm, 10, "the in-window generation bump")
                in_window = not ticket._request.event.is_set()
                crossed = ticket.result(timeout=TICKET_TIMEOUT_S)
                g_new = fleet3.fabric.index_generation()
                stored = [cache.get_rows([query_key(q, g)], K) is not None for g in (g_adm, g_new)]
                if not in_window or not crossed or not crossed[0] or any(stored) or slow.stats["cache_hits"]:
                    raise AssertionError(
                        f"in-window absorb: landed in the window {in_window}, stored {stored}, "
                        f"hits {slow.stats['cache_hits']}"
                    )
            finally:
                slow.stop()

            # -- kill one partition under c16 --
            def crash_part():
                fleet3.workers[0].kill()
                fleet3.scheds[0].stop()

            killer = _killer(fleet3.fabric, crash_part)
            killer.start()
            _q, _l, rows_pk = drive(lambda q: fleet3.fabric.serve([q], K), reqs, SF_CALLERS)
            killer.join(60)
            lost = [r for r in rows_pk if PARTITION_LOST in r.degraded]
            dead_keys = sum(1 for r in lost for k, _s in r[0] if k % PF_PARTS == 0)
            if not lost or dead_keys or any(not r or not r[0] for r in rows_pk):
                raise AssertionError(f"partition kill: {len(lost)} flagged, {dead_keys} keys of the dead partition")
            launches = rescore_shortlist.launches
            log(
                f"partitioned fabric {tag}: H={PF_PARTS} partitions (key % {PF_PARTS}) of phase 4's {N_ROWS} rows, "
                f"C per partition {[idx._centroids.shape[0] for idx in parts]} (H=1: C={C}), n_probe "
                f"{[idx.n_probe for idx in parts]} against {p_main}, built in {build_s:.2f} s; device bytes per "
                f"partition {[round(b / 1e9, 4) for b in bytes3]} GB against H=1's {bytes1 / 1e9:.4f} GB: "
                f"{max(bytes3) / bytes1:.3f}x (the reference bench's bar 0.45x, printed, not a gate); H=3 == H=1 bit "
                f"for bit at full probe on {PF_ID_BATCHES} whole batches of 16; scatter booked 1 logical + "
                f"{PF_PARTS} physical sends ({phys.physical_dispatches} physical dispatches in the serve with the "
                f"hosts' own), {len(host_disp)} dispatches + {len(host_fet)} fetches on the hosts; c{SF_CALLERS} "
                + "; ".join(f"{n} {q:.1f} q/s p50 {p50:.3f} ms p99 {p99:.3f} ms recall@10 vs exact {r:.4f}"
                            for n, (q, p50, p99, r) in cells.items())
                + f"; one absorb moved entries {moved_one} only ({before} -> {after}); {PF_FRESH} fresh docs "
                f"through fabric.connector(): each on its owner, all found first by their own text at full probe; "
                f"absorb {rates['H=3']:.1f} docs/s at H=3 against {rates['H=1']:.1f} at H=1 "
                f"({rates['H=3'] / rates['H=1']:.2f}x) beside one serving caller ({under['H=3']} / {under['H=1']} "
                f"clean serves during them); in-window absorb served, cached under neither key, 0 hits; "
                f"kill partition 0 at c{SF_CALLERS}: {len(lost)} of {SF_REQUESTS} flagged partition_lost, 0 keys of "
                f"the dead partition, 0 exceptions; stalled heartbeat ticks H=3 {fleet3.fabric.stats['stalled_ticks']} "
                f"H=1 {fleet1.fabric.stats['stalled_ticks']}; rescore launches in phase 18 {launches} (replica fleet "
                f"{launches_a})"
            )
        finally:
            fleet3.stop()
            fleet1.stop()

        # -- the rescore kernel at one partition's shape (16 queries) --
        part = parts[1]
        serve_p = FusedEncodeSearch(encoder, part, k=K)
        rec = rescore_at_path_shape(part, stage1_rescore_args(serve_p, part, pool[:16]), dev)
        log(f"ivf_rescore at one partition's shape {tag}: " + rescore_line(part, rec))
    finally:
        for k, v in env_prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return launches, rec


_SHAPE_KEYS = (
    "B", "p", "distinct_clusters", "max_abs_err", "ms", "kernels_ms", "traced", "bound_ms", "bound_by",
    "library_ms", "library_with_gather_ms",
)


# -- phase 19: the framework ------------------------------------------------------
FW_COMMITS = 4  # (a): retrieve commits of BATCH queries
FW_STREAM_COMMITS = 8  # (b): document commits, each followed by a query commit
FW_STREAM_DOCS = 1024
FW_PLANTED_QUERY_COMMIT = 1  # (b): the planted query arrives in this query commit,
FW_PLANTED_DOC_COMMIT = 5  # its document in this later document commit
FW_COMMIT_MS = 10  # the engine's commit tick while the phase runs
FW_WAIT_S = 300.0


FW_INGEST: dict = {}  # phase 19's ingest seconds, read by phase 24


class _FrameworkDriver:
    """What phase 19's (and 21's, 22's) driver thread waits on: tick ends,
    answers per arm, each index's rows, and the moments its subjects
    committed."""

    def __init__(self, phase: str = "phase 19"):
        self.phase = phase
        self.cond = threading.Condition()
        self.tick = 0
        self.answers = {}  # arm -> {query key: [(time, row, diff), ...]}
        self.arrival = {}  # arm -> list of (perf_counter, key, diff)
        self.commit_at = {}  # subject name -> [perf_counter per commit]
        self.stop = False

    def on_tick(self, _ts) -> None:
        with self.cond:
            self.tick += 1
            self.cond.notify_all()

    def on_change(self, arm: str):
        book = self.answers.setdefault(arm, {})
        times = self.arrival.setdefault(arm, [])

        def on_change(key, row, time, is_addition):
            with self.cond:
                book.setdefault(int(key), []).append((time, row, 1 if is_addition else -1))
                times.append((_now(), int(key), 1 if is_addition else -1))
                self.cond.notify_all()

        return on_change

    def wait(self, pred, what: str) -> None:
        """Wait until ``pred()`` holds, then for the end of the tick after
        (every emission of the tick that made it true has landed)."""
        deadline = _now() + FW_WAIT_S
        with self.cond:
            while not pred():
                if self.stop or _now() > deadline:
                    raise AssertionError(f"{self.phase}: timed out waiting for {what}")
                self.cond.wait(0.05)
            seen = self.tick
            while self.tick <= seen + 1:
                if self.stop or _now() > deadline:
                    raise AssertionError(f"{self.phase}: timed out waiting for the tick after {what}")
                self.cond.wait(0.05)


def _now() -> float:
    return time.perf_counter()


def _queue_subject(pw, name: str, driver: _FrameworkDriver):
    """A ConnectorSubject that pushes the batches put on its queue, one
    atomic commit each, until it takes None."""
    import queue

    q = queue.Queue()

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for batch in iter(q.get, None):
                for row in batch:
                    self.next(**row)
                t_commit = _now()
                self.commit()
                with driver.cond:
                    driver.commit_at.setdefault(name, []).append(t_commit)
                    driver.cond.notify_all()

    return Subject(), q


def _framework_ops(pw):
    """The ExternalIndexOperators of the graph, in build order, with the
    inner index each holds (adapter -> DeviceKnn / DeviceIvfKnn)."""
    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator

    return [op for op in pw.G.engine_graph.operators if isinstance(op, ExternalIndexOperator)]


def _fw_rows(result):
    """[(path, score), ...] of one ``retrieve_query`` result row."""
    return [(r["metadata"]["path"], -float(r["dist"])) for r in result]


def framework_busy(prof, wall_ms: float, check: dict) -> str:
    """``device_busy`` of phase 19's window without the check's direct
    searches: the kernels on the check's stream (told apart by the marker
    it launches first) and the check's wall time are left out."""
    cuda = [e for e in prof.events() if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not cuda:
        return "busy share not measured (no CUDA events traced)"
    marks = {getattr(e, "device_resource_id", None) for e in cuda if "spin_kernel" in e.name}
    if len(marks) != 1 or None in marks:
        return "busy share not measured (the check's stream is not told apart among the traced kernels)"
    check_us = sum(e.time_range.elapsed_us() for e in cuda if e.device_resource_id in marks)
    dev_ms = (sum(e.time_range.elapsed_us() for e in cuda) - check_us) / 1e3
    wall = wall_ms - check["s"] * 1e3
    return (
        f"device kernels {dev_ms:.3f} ms in a {wall:.3f} ms wall ({100 * dev_ms / wall:.1f}% busy; the check's "
        f"direct searches, {check_us / 1e3:.3f} ms on the card in {check['s'] * 1e3:.3f} ms of wall, left out)"
    )


def framework_phase(direct_p50: dict, tag: str):
    """Phase 19: the framework — ``DocumentStore`` retrieval through
    ``TpuEmbedder`` and the engine, all through ``import pathway_tpu_torch
    as pw``.  Returns (rescore launches, the kernel at the framework's
    shape)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder
    from torch.profiler import ProfilerActivity, profile

    t_phase = _now()
    dev = torch.device(DEVICE)
    pw.reset()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    docs = corpus(N_DOCS)
    qidx = query_ids()
    stream_docs = [t + f" stream{i}" for i, t in enumerate(corpus(FW_STREAM_COMMITS * FW_STREAM_DOCS, seed=SEED + 13))]
    planted_doc = FW_PLANTED_DOC_COMMIT * FW_STREAM_DOCS + 17
    planted_path = f"s{FW_PLANTED_DOC_COMMIT}/{planted_doc}.txt"
    emb = TpuEmbedder(dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768, seed=SEED,
                      dtype=torch.bfloat16)

    # the direct path on the same documents: the embedder's encode + IvfKnnIndex.add
    torch.cuda.synchronize()
    t0 = _now()
    direct_vecs = emb.func(np.array(docs, dtype=object))
    direct = IvfKnnIndex(DIM, metric="cos")
    direct.add(keys_for(N_DOCS), direct_vecs)
    torch.cuda.synchronize()
    direct_s = _now() - t0
    del direct, direct_vecs

    driver = _FrameworkDriver()
    schema = pw.schema_from_types(data=str, _metadata=dict)
    static = pw.debug.table_from_rows(schema, [(t, {"path": f"d{i % 16}/{i}.txt"}) for i, t in enumerate(docs)])
    doc_subject, doc_q = _queue_subject(pw, "docs", driver)
    streamed = pw.io.python.read(doc_subject, schema=schema, atomic_batches=True, name="stream_docs")
    query_subject, query_q = _queue_subject(pw, "queries", driver)
    queries = pw.io.python.read(query_subject, schema=DocumentStore.RetrieveQuerySchema, atomic_batches=True,
                                name="queries")
    sq_subject, sq_q = _queue_subject(pw, "stream_queries", driver)
    stream_queries = pw.io.python.read(sq_subject, schema=pw.schema_from_types(query=str), atomic_batches=True,
                                       name="stream_queries")
    # both stores over the same tables: their operators see the same deltas,
    # so the embedder packs the same batches and both index the same vectors
    exact_store = DocumentStore(
        [static, streamed],
        retriever_factory=pw.stdlib.indexing.BruteForceKnnFactory(
            dimension=DIM, embedder=emb, reserved_space=N_DOCS + FW_STREAM_COMMITS * FW_STREAM_DOCS),
        splitter=None,
    )
    ivf_store = DocumentStore(
        [static, streamed],
        retriever_factory=pw.stdlib.indexing.IvfKnnFactory(dimension=DIM, embedder=emb, n_probe=1 << 30),
        splitter=None,
    )
    arms = {"exact": exact_store.retrieve_query(queries), "ivf": ivf_store.retrieve_query(queries)}
    chunks = ivf_store.parsed_docs
    for name, query in (("retracting", ivf_store.index.query), ("as_of_now", ivf_store.index.query_as_of_now)):
        res = query(stream_queries.query, number_of_matches=K)
        arms[name] = res.select(query=stream_queries.query, metas=chunks.metadata, scores=res.score)
    for name, table in arms.items():
        pw.io.subscribe(table, on_change=driver.on_change(name), on_time_end=driver.on_tick)
    ops = _framework_ops(pw)
    if len(ops) != 4:
        raise AssertionError(f"phase 19: {len(ops)} index operators, expected 4")
    inner = {name: op.index.inner for name, op in zip(("exact", "ivf", "retracting", "as_of_now"), ops)}
    index = {name: i.index for name, i in inner.items()}
    added = {name: [] for name in inner}  # (perf_counter, rows after) per add
    searches = {"exact": [], "ivf": []}  # (query vectors, k, replies) per unfiltered search
    oversampled = {"exact": 0, "ivf": 0}

    def record_adds(name):
        orig = inner[name].add

        def add(keys, values, metadatas):
            orig(keys, values, metadatas)
            with driver.cond:
                added[name].append((_now(), len(index[name])))
                driver.cond.notify_all()

        inner[name].add = add

    def record_searches(name):
        orig, orig_over = inner[name].search, index[name].search_oversampled

        def search(values, k, filters):
            out = orig(values, k, filters)
            if all(f is None for f in filters):
                searches[name].append((np.stack([np.asarray(v, np.float32) for v in values]), k, out))
            return out

        def search_oversampled(*args, **kwargs):
            oversampled[name] += 1
            return orig_over(*args, **kwargs)

        inner[name].search = search
        index[name].search_oversampled = search_oversampled

    for name in inner:
        record_adds(name)
    for name in searches:
        record_searches(name)

    def rows_in(name):
        return added[name][-1][1] if added[name] else 0

    def answered(arm):
        return len(driver.answers.get(arm, {}))

    report = {}
    # the check's direct searches run on a stream of their own, so that
    # the busy share can leave their kernels out; their rescore launches
    # are taken off the framework's count (the engine is idle meanwhile:
    # the next commit is put after the check)
    check_stream = torch.cuda.Stream(dev)
    check = {"launches": 0, "s": 0.0}

    def direct_search(name, vecs, k):
        t0, before = _now(), rescore_shortlist.launches
        check_stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(check_stream):
            if check["s"] == 0.0:
                torch.cuda._sleep(1)  # marks the stream among the traced kernels
            out = index[name].search(vecs, k)
        check_stream.synchronize()
        check["launches"] += rescore_shortlist.launches - before
        check["s"] += _now() - t0
        return out

    def drive():
        t_run = report["t_run"]
        driver.wait(lambda: all(rows_in(n) >= N_DOCS for n in inner), "the static documents")
        report["ingest_s"] = max(added[n][0][0] for n in inner) - t_run
        # (a) 4 retrieve commits of 64, then a commit of 64 under filepath_globpattern d3/*
        latencies = []
        for c in range(FW_COMMITS + 1):
            texts = [docs[j] for j in qidx[c * BATCH : (c + 1) * BATCH]]
            glob = "d3/*" if c == FW_COMMITS else None
            n_before = {name: len(v) for name, v in searches.items()}
            query_q.put([{"query": t, "k": K, "metadata_filter": None, "filepath_globpattern": glob} for t in texts])
            want = (c + 1) * BATCH
            driver.wait(lambda: answered("exact") >= want and answered("ivf") >= want
                        and len(driver.commit_at.get("queries", ())) > c, f"retrieve commit {c}")
            t_commit = driver.commit_at["queries"][c]
            last = max(t for arm in ("exact", "ivf") for t, _k, _d in driver.arrival[arm])
            if glob is None:
                latencies.append((last - t_commit) * 1e3)
                # the framework's answers == a direct search of the operator's own index
                for name in ("exact", "ivf"):
                    if len(searches[name]) != n_before[name] + 1:
                        raise AssertionError(f"phase 19: {name} searched {len(searches[name]) - n_before[name]} times")
                    vecs, k, got = searches[name][-1]
                    want_rows = direct_search(name, vecs, k)
                    if [list(r) for r in got] != [list(r) for r in want_rows]:
                        raise AssertionError(f"phase 19: the {name} store's answers differ from its index's search")
        report["retrieve_ms"] = latencies
        # (b) 8 document commits of 1,024, each after a query commit of 64
        stream_ms = []
        for c in range(FW_STREAM_COMMITS):
            texts = [docs[j] for j in qidx[(FW_COMMITS + 1 + c) * BATCH : (FW_COMMITS + 2 + c) * BATCH]]
            if c == FW_PLANTED_QUERY_COMMIT:
                texts[0] = stream_docs[planted_doc]
            sq_q.put([{"query": t} for t in texts])
            want = (c + 1) * BATCH
            driver.wait(lambda: answered("retracting") >= want and answered("as_of_now") >= want,
                        f"stream query commit {c}")
            lo = c * FW_STREAM_DOCS
            doc_q.put([
                {"data": stream_docs[i], "_metadata": {"path": f"s{i // FW_STREAM_DOCS}/{i}.txt"}}
                for i in range(lo, lo + FW_STREAM_DOCS)
            ])
            rows = N_DOCS + (c + 1) * FW_STREAM_DOCS
            driver.wait(lambda: all(rows_in(n) >= rows for n in inner)
                        and len(driver.commit_at.get("docs", ())) > c, f"document commit {c}")
            t_commit = driver.commit_at["docs"][c]
            stream_ms.append((added["ivf"][-1][0] - t_commit) * 1e3)
        report["stream_ms"] = stream_ms

    def run_driver():
        try:
            drive()
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread after the run
            report["error"] = exc
        finally:
            for q in (query_q, sq_q, doc_q):
                q.put(None)

    rescore_shortlist.launches = 0
    thread = threading.Thread(target=run_driver, daemon=True, name="phase19-driver")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        report["t_run"] = _now()
        thread.start()
        try:
            pw.run(commit_duration_ms=FW_COMMIT_MS)
        finally:
            driver.stop = True
            thread.join(timeout=60)
        torch.cuda.synchronize()
        wall_ms = (_now() - report["t_run"]) * 1e3
    launches = rescore_shortlist.launches - check["launches"]
    if "error" in report:
        raise report["error"]
    if launches == 0:
        raise AssertionError("phase 19: the framework's IVF path launched no rescore kernel")

    # -- checks --------------------------------------------------------------
    for name in ("exact", "ivf", "retracting", "as_of_now"):
        t = index[name]._mats[0] if name == "exact" else index[name]._slabs
        if t.device.type != dev.type:
            raise AssertionError(f"phase 19: the {name} index lives on {t.device}")
    q_keys, q_cols = queries._materialize()
    text_of = {int(k): q_cols["query"][i] for i, k in enumerate(q_keys)}
    glob_of = {int(k): q_cols["filepath_globpattern"][i] for i, k in enumerate(q_keys)}
    results = {}
    for arm in ("exact", "ivf"):
        keys_, cols = arms[arm]._materialize()
        results[arm] = {int(k): list(cols["result"][i]) for i, k in enumerate(keys_)}
    doc_of_text = {docs[j]: j for j in qidx[: (FW_COMMITS + 1) * BATCH]}
    plain = [qk for qk in text_of if glob_of[qk] is None]
    globbed = [qk for qk in text_of if glob_of[qk] is not None]
    if len(plain) != FW_COMMITS * BATCH or len(globbed) != BATCH:
        raise AssertionError(f"phase 19: {len(plain)} + {len(globbed)} queries answered")
    self_first = sum(
        1 for qk in plain
        if results["exact"][qk] and results["exact"][qk][0]["metadata"]["path"].endswith(f"/{doc_of_text[text_of[qk]]}.txt")
    )
    first_commit = [qk for qk in plain if doc_of_text[text_of[qk]] in set(qidx[:BATCH])]
    first_ok = all(
        results["exact"][qk][0]["metadata"]["path"].endswith(f"/{doc_of_text[text_of[qk]]}.txt") for qk in first_commit
    )
    mismatched = sum(
        1 for qk in plain
        if len(results["ivf"][qk]) != K or not same_ranking(_fw_rows(results["exact"][qk]), _fw_rows(results["ivf"][qk]))
    )
    glob_bad = sum(
        1 for qk in globbed
        if any(len(results[arm][qk]) != K or not all(r["metadata"]["path"].startswith("d3/") for r in results[arm][qk])
               for arm in ("exact", "ivf"))
    )
    C = index["ivf"]._centroids.shape[0]
    log(
        f"framework (a) {tag}: {FW_COMMITS} commits of {BATCH} queries (phase 5's texts, k={K}) into an exact and "
        f"an IVF DocumentStore sharing one TpuEmbedder: exact self-first {self_first}/{len(plain)} (the "
        f"{len(first_commit)} of the first commit all first: {first_ok}); IVF at full probe "
        f"(n_probe={index['ivf'].probe_count()} of C={C}) == exact rank by rank on {len(plain) - mismatched}/"
        f"{len(plain)}; a commit of {BATCH} under filepath_globpattern d3/*: {BATCH - glob_bad}/{BATCH} answered "
        f"with {K} d3/ paths only in both stores (search_oversampled calls: exact {oversampled['exact']}, IVF "
        f"{oversampled['ivf']}); each commit's answers == a direct search of the operator's own index; "
        f"index tensors on cuda"
    )
    if not first_ok or mismatched or glob_bad or not all(oversampled.values()):
        raise AssertionError("phase 19 (a): a retrieval check failed")

    retract_events = driver.answers["retracting"]
    asof_events = driver.answers["as_of_now"]
    planted_q = [qk for qk, ev in asof_events.items() if ev[0][1]["query"] == stream_docs[planted_doc]]
    if len(planted_q) != 1:
        raise AssertionError(f"phase 19 (b): {len(planted_q)} planted queries answered")
    pq = planted_q[0]
    ev = retract_events[pq]
    retracted = [e for e in ev if e[2] < 0]
    reemitted = [e for e in ev[1:] if e[2] > 0 and e[1]["metas"] and e[1]["metas"][0]["path"] == planted_path]
    before_first = ev[0][1]["metas"] and ev[0][1]["metas"][0]["path"] == planted_path
    asof_neg = sum(1 for evs in asof_events.values() for e in evs if e[2] < 0)
    asof_planted = any(m["path"] == planted_path for e in asof_events[pq] for m in e[1]["metas"])
    retract_total = sum(1 for evs in retract_events.values() for e in evs if e[2] < 0)
    t_planted = driver.commit_at["docs"][FW_PLANTED_DOC_COMMIT]
    seen = [t for t, k, d in driver.arrival["retracting"] if k == pq and d > 0 and t > t_planted]
    planted_ms = (seen[0] - t_planted) * 1e3 if seen else float("nan")
    log(
        f"framework (b) {tag}: {FW_STREAM_COMMITS} commits of {FW_STREAM_DOCS} documents into the IVF store between "
        f"{FW_STREAM_COMMITS} query commits of {BATCH}; the planted query (commit {FW_PLANTED_QUERY_COMMIT}) found "
        f"its document (commit {FW_PLANTED_DOC_COMMIT}): retracting arm {len(retracted)} retraction(s) and "
        f"{len(reemitted)} re-emission(s) with it first ({retract_total} retractions over all queries), "
        f"as-of-now arm {asof_neg} retractions, planted document in its answer: {asof_planted}; "
        f"commit-to-retrievable p50 {np.percentile(report['stream_ms'], 50):.3f} ms max "
        f"{max(report['stream_ms']):.3f} ms over {FW_STREAM_COMMITS} commits (document subject commit to the add "
        f"returning in the IVF store's operator), planted query re-emitted {planted_ms:.3f} ms after its commit"
    )
    if before_first or not retracted or not reemitted or not seen or asof_neg or asof_planted:
        raise AssertionError("phase 19 (b): the retracting / as-of-now contract failed")

    # -- (c) the rescore kernel at the framework's shape ----------------------
    vecs = searches["ivf"][0][0]
    shape = rescore_at_path_shape(index["ivf"], ivf_search_rescore_args(index["ivf"], vecs), dev)
    log(f"ivf_rescore at the framework's shape {tag}: " + rescore_line(index["ivf"], shape)
        + f"; launches in phase 19 {launches} through the framework (the check's direct searches "
        f"launched {check['launches']} more, not counted)")

    ingest_docs = 4 * N_DOCS
    FW_INGEST.update(direct_s=direct_s, ingest_s=report["ingest_s"])  # phase 24's one-process baseline
    lat = report["retrieve_ms"]
    QA_NUMBERS["framework_retrieve_p50_ms"] = float(np.percentile(lat[1:], 50))  # beside phase 20's retrieve
    log(
        f"framework numbers {tag}: engine ingest of the {N_DOCS} static documents into 4 indexes (parse + "
        f"embed + add through the engine, run start to the last first add) {report['ingest_s']:.3f} s = "
        f"{ingest_docs / report['ingest_s']:.0f} docs/s over the 4; direct TpuEmbedder encode + "
        f"IvfKnnIndex.add {direct_s:.3f} s = {N_DOCS / direct_s:.0f} docs/s; the engine takes "
        f"{report['ingest_s'] / (4 * direct_s):.2f}x the time of 4 direct encode + add calls (the same work); "
        f"retrieve per commit of {BATCH} queries (both stores, subject commit to the last answer, tick "
        f"{FW_COMMIT_MS} ms): first {lat[0]:.3f} ms (it holds the IVF's first build), then p50 "
        f"{QA_NUMBERS['framework_retrieve_p50_ms']:.3f} ms max {max(lat[1:]):.3f} ms over the {len(lat) - 1} "
        f"after it; phase "
        f"5's direct serve p50 exact "
        f"{direct_p50['exact']:.3f} ms IVF {direct_p50['ivf']:.3f} ms (1M rows); "
        + framework_busy(prof, wall_ms, check)
        + (f"; peak allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB" if dev.type == "cuda" else "")
        + f"; phase 19 {_now() - t_phase:.1f} s"
    )
    top = sorted(pw.G.engine_graph.operators, key=lambda o: -o.process_ns)[:8]
    log(f"framework engine operators by host seconds in process() {tag}: "
        + ", ".join(f"{o.name}#{o.id} {o.process_ns / 1e9:.3f} s ({o.rows_in} rows in)" for o in top))
    pw.reset()
    return launches, shape


# -- phase 20: question answering and chat -------------------------------------------
QA_QUESTIONS = 64  # distinct questions: phase 5's first query documents
QA_C1 = 8  # answers at c1, one caller (16 before phase 24)
QA_C16 = 8  # answers at c16 (16 before phase 26); the whole script, phases 21-26 included, keeps its time budget
QA_CALLERS = 16
QA_BURST = 4  # answers of the profiled burst, at c4 (16 at c16 before phase 24, 8 at c8 before phase 28: reading
# that trace took most of it)
QA_RETRIEVES = 16  # /v1/retrieve calls, k = K
QA_TOPK = 6  # search_topk; the reranker scores 4 x 6 = 24 candidates
QA_NEW_TOKENS = 48
QA_COMMIT_MS = 10  # the engine's commit tick while the phase runs
QA_TIMEOUT_S = 300.0
QA_TEMPLATE_WAIT_S = 240.0
QA_TEMPLATES = ("demo_question_answering", "adaptive_rag")
QA_NUMBERS: dict = {}  # phase 19's retrieve p50, read by phase 20


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, route: str, body=None, timeout: float = QA_TIMEOUT_S):
    """(status, parsed JSON or text, t_send, t_recv) of one request through
    ``urllib``, as a client of the REST surface sends it."""
    import urllib.error
    import urllib.request

    data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    t_send = _now()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw, ctype = resp.status, resp.read(), resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as err:
        status, raw, ctype = err.code, err.read(), err.headers.get("Content-Type", "")
    t_recv = _now()
    out = json.loads(raw) if ctype.startswith("application/json") else raw.decode(errors="replace")
    return status, out, t_send, t_recv


def _ok_json(status, out, route: str, shape) -> None:
    if status != 200 or not shape(out):
        raise AssertionError(f"phase 20: {route} answered {status}: {str(out)[:300]}")


def _answer_shape(out) -> bool:
    return (isinstance(out, dict) and set(out) == {"response", "context_docs"} and isinstance(out["response"], str)
            and len(out["context_docs"]) == QA_TOPK
            and all({"text", "metadata", "dist", "rerank_score"} <= set(d) for d in out["context_docs"]))


def _retrieve_shape(out) -> bool:
    return (isinstance(out, list) and len(out) == K and all({"text", "metadata", "dist"} <= set(d) for d in out)
            and all(np.isfinite(d["dist"]) for d in out))


def qa_phase(direct_p50: dict, tag: str):
    """Phase 20 (a): a full-width RAG app behind the port's REST server,
    answering through the engine.  Returns (launches by kernel, the
    rescore at the QA path's shape)."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.run import terminate
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.ops import decode_rows
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder
    from pathway_tpu_torch.xpacks.llm.llms import TpuChat
    from pathway_tpu_torch.xpacks.llm.llms import _messages_to_prompt as messages_to_prompt
    from pathway_tpu_torch.xpacks.llm.prompts import prompt_qa
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    t_phase = _now()
    dev = torch.device(DEVICE)
    pw.reset()
    docs = corpus(N_DOCS)
    questions = [docs[j] for j in query_ids()[:QA_QUESTIONS]]
    emb = TpuEmbedder(dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768, seed=SEED,
                      dtype=torch.bfloat16)
    table = pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict),
                                     [(t, {"path": f"d{i % 16}/{i}.txt"}) for i, t in enumerate(docs)])
    store = DocumentStore(table, retriever_factory=pw.stdlib.indexing.IvfKnnFactory(
        dimension=DIM, embedder=emb, n_probe=1 << 30), splitter=None)
    ce = CrossEncoderModel()  # 256 wide, 4 layers, bf16
    gen = TextGenerator()  # 256 wide, 4 layers, vocab 32,768, bf16
    chat = TpuChat(generator=gen, max_new_tokens=QA_NEW_TOKENS, continuous=True)
    rag = BaseRAGQuestionAnswerer(chat, store, search_topk=QA_TOPK, reranker=CrossEncoderReranker(cross_encoder=ce))

    # the path's steps, timed where the engine calls them (host clock)
    marks = {"insert": [], "search": [], "rerank": [], "decode": []}
    reranked = []  # (question, the 24 candidates, the kept 6)
    lock = threading.Lock()

    def timed(kind, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = _now()
            out = fn(*args, **kwargs)
            with lock:
                marks[kind].append((t0, _now()))
            return out

        return wrapper

    orig_rerank = rag._rerank_docs

    def record_rerank(question, docs_in, keep=None, flags=None):
        out = orig_rerank(question, docs_in, keep=keep, flags=flags)
        with lock:
            reranked.append((question, [dict(d) for d in docs_in], [dict(d) for d in out], list(flags or ())))
        return out

    rag._rerank_docs = record_rerank
    ce.predict = timed("rerank", ce.predict)
    chat.func = timed("decode", chat.func)
    port = _free_port()
    rag.build_server(host="127.0.0.1", port=port)
    ops = _framework_ops(pw)
    if len(ops) != 2:
        raise AssertionError(f"phase 20: {len(ops)} index operators, expected 2 (answer, retrieve)")
    searches = {"answer": [], "retrieve": []}  # (query texts, their vectors, k, replies) per unfiltered search
    key_text = {"answer": {}, "retrieve": {}}  # each index's keys -> the text embedded under it
    querying = threading.local()  # the texts of the search under way, read by the inner index's wrapper
    for name, op in zip(("answer", "retrieve"), ops):
        adapter, inner = op.index, op.index.inner

        def add(keys, values, metadatas, _orig=adapter.add, _book=key_text[name]):
            _book.update(zip((int(key) for key in keys), values))
            return _orig(keys, values, metadatas)

        def query(values, k, filters, _orig=adapter.search):
            querying.texts = list(values)
            return _orig(values, k, filters)

        def search(vectors, k, filters, _orig=inner.search, _book=searches[name]):
            out = _orig(vectors, k, filters)
            if all(f is None for f in filters):
                _book.append((querying.texts, np.stack([np.asarray(v, np.float32) for v in vectors]), k, out))
            return out

        adapter.add = add
        adapter.search = timed("search", query) if name == "answer" else query
        inner.search = search
    index = {name: op.index.inner.index for name, op in zip(("answer", "retrieve"), ops)}
    answer_subject = next(h.__self__ for r, _m, h, _d in rag.server.webserver._routes if r == "/v1/pw_ai_answer")

    run_error = []

    def serve():
        try:
            pw.run(commit_duration_ms=QA_COMMIT_MS, monitoring_level=None)
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
            run_error.append(exc)

    thread = threading.Thread(target=serve, daemon=True, name="phase20-engine")
    report = {}
    try:
        thread.start()
        deadline = _now() + QA_TIMEOUT_S
        while True:
            if run_error or _now() > deadline:
                raise AssertionError(f"phase 20: the server did not come up: {run_error[:1]}")
            try:
                if _http(port, "GET", "/_schema", timeout=5)[0] == 200 and answer_subject._writer is not None:
                    break
            except OSError:
                pass
            time.sleep(0.05)
        answer_subject._writer.insert = timed("insert", answer_subject._writer.insert)
        # warm-up, not measured: the two IVF builds, the decode and rerank shapes
        t0 = _now()
        _ok_json(*_http(port, "POST", "/v1/pw_ai_answer", {"prompt": questions[-1], "return_context_docs": True})[:2],
                 "/v1/pw_ai_answer", _answer_shape)
        _ok_json(*_http(port, "POST", "/v1/retrieve", {"query": questions[-1], "k": K})[:2], "/v1/retrieve",
                 _retrieve_shape)
        report["warm_s"] = _now() - t0
        ingest_s = t0 - t_phase

        # -- the measured window: every kernel count from 0 --------------------
        rescore_shortlist.launches = 0
        decode_rows.tied_readout.launches = 0
        decode_rows.add_layer_norm_rows.launches = 0
        decode_rows.layer_norm_rows.launches = 0
        for book in marks.values():
            book.clear()
        reranked.clear()
        answers = []  # (question, status, out, t_send, t_recv, arm)

        def ask(q, arm):
            status, out, ts, tr = _http(port, "POST", "/v1/pw_ai_answer", {"prompt": q, "return_context_docs": True})
            with lock:
                answers.append((q, status, out, ts, tr, arm))
            return status

        t0 = _now()
        for q in questions[:QA_C1]:
            ask(q, "c1")
        report["c1_wall"] = _now() - t0
        c16_reqs = [questions[i % QA_QUESTIONS] for i in range(QA_C16)]
        qps, c16_lat, _ = drive(lambda q: ask(q, "c16"), c16_reqs, QA_CALLERS)
        # the busy share over one burst of c4 answers: reading a trace of
        # the whole arm (~2M kernels) costs the profiler minutes
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = _now()
            drive(lambda q: ask(q, "burst"), questions[:QA_BURST], QA_BURST)
            torch.cuda.synchronize()
            burst_wall_ms = (_now() - t0) * 1e3
        t_prof = _now()
        report["busy"] = device_busy(prof, burst_wall_ms)
        report["profiler_s"] = _now() - t_prof
        retrieves = []
        for q in questions[QA_C1 : QA_C1 + QA_RETRIEVES]:
            status, out, ts, tr = _http(port, "POST", "/v1/retrieve", {"query": q, "k": K})
            _ok_json(status, out, "/v1/retrieve", _retrieve_shape)
            retrieves.append((q, out, (tr - ts) * 1e3))
        status, summary, _ts, _tr = _http(port, "POST", "/v1/pw_ai_summary", {"text_list": docs[:4]})
        _ok_json(status, summary, "/v1/pw_ai_summary", lambda o: isinstance(o, str) and o.strip())
        status, stats, _ts, _tr = _http(port, "POST", "/v1/statistics", {})
        _ok_json(status, stats, "/v1/statistics", lambda o: isinstance(o, dict) and o.get("file_count") == N_DOCS)
        status, listed, _ts, _tr = _http(port, "POST", "/v1/pw_list_documents", {})
        _ok_json(status, listed, "/v1/pw_list_documents",
                 lambda o: isinstance(o, list) and len(o) == N_DOCS and all("path" in d for d in o))
        launches = {
            "ivf_rescore": rescore_shortlist.launches,
            "tied_readout": decode_rows.tied_readout.launches,
            "add_layer_norm_rows": decode_rows.add_layer_norm_rows.launches + decode_rows.layer_norm_rows.launches,
        }
        # an unreadable body reads as {} (the reference's rule) and is answered;
        # a value that fails inside the pipeline answers 500 JSON; the server
        # stays up; a GET on a POST route is 405
        garbage = _http(port, "POST", "/v1/pw_ai_summary", b"{not json")
        failing = _http(port, "POST", "/v1/pw_ai_summary", {"text_list": 5})
        after = _http(port, "POST", "/v1/statistics", {})
        wrong = _http(port, "GET", "/v1/pw_ai_answer")
        if (garbage[0] != 200 or failing[0] != 500 or not isinstance(failing[1], dict) or "error" not in failing[1]
                or after[0] != 200 or after[1].get("file_count") != N_DOCS or wrong[0] != 405):
            raise AssertionError(f"phase 20: error routes {garbage[:2]} {failing[:2]} {after[:2]} {wrong[0]}")
    finally:
        terminate()
        thread.join(timeout=120)
        chat._decoder.stop()
    if run_error:
        raise run_error[0]
    if thread.is_alive():
        raise AssertionError("phase 20: the engine did not stop")
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"phase 20: a kernel of the QA path was not launched: {launches}")

    # -- checks: every direct call on a stream of its own, after the window ------
    for q, status, out, *_ in answers:
        _ok_json(status, out, "/v1/pw_ai_answer", _answer_shape)
    if len(answers) != QA_C1 + QA_C16 + QA_BURST or len(reranked) != len(answers):
        raise AssertionError(f"phase 20: {len(answers)} answers, {len(reranked)} reranks")
    for name, t in (("answer index", index["answer"]._slabs), ("retrieve index", index["retrieve"]._slabs),
                    ("generator", next(gen.module.parameters())), ("cross-encoder", next(ce.module.parameters())),
                    ("embedder", next(emb._encoder.module.parameters()))):
        if t.device.type != dev.type:
            raise AssertionError(f"phase 20: the {name} lives on {t.device}")
    check_stream = torch.cuda.Stream(dev)
    check_stream.wait_stream(torch.cuda.current_stream(dev))
    solo = {}
    check_s = {}
    with torch.cuda.stream(check_stream), torch.no_grad():
        t0 = _now()
        # the direct path: the questions embedded by the app's embedder, each search
        # row's vector tied to its own question, and the question's candidates
        # read from the index's reply for that vector
        direct = np.asarray(emb.func(np.array(questions, dtype=object)), np.float32)
        candidates = {"answer": {}, "retrieve": {}}  # question -> the texts its searches returned
        embed_err = 0.0
        for name in ("answer", "retrieve"):
            for texts, vecs, k, got in searches[name]:
                want = index[name].search(vecs, k)
                if [list(r) for r in got] != [list(r) for r in want]:
                    raise AssertionError(f"phase 20: the {name} operator's search differs from its index's")
                for text, vec, row in zip(texts, vecs, got):
                    own = int(np.argmin(((direct - vec) ** 2).sum(axis=1)))
                    if questions[own] != text:
                        raise AssertionError(f"phase 20: the {name} operator searched a vector nearer another "
                                             "question's embedding than its own")
                    embed_err = max(embed_err, float(np.abs(direct[own] - vec).max()))
                    candidates[name].setdefault(text, set()).add(
                        tuple(key_text[name][int(key)] for key, _score in row))
        for q, out, _ms in retrieves:
            if tuple(d["text"] for d in out) not in {c[:K] for c in candidates["retrieve"].get(q, ())}:
                raise AssertionError("phase 20: /v1/retrieve differs from the index's top k for its question")
        check_s["searches"] = _now() - t0
        t0 = _now()
        by_question = {}
        for q, docs_in, kept, flags in reranked:
            if len(docs_in) != rag.rerank_candidates or flags:
                raise AssertionError(f"phase 20: {len(docs_in)} candidates reranked, flags {flags}")
            if tuple(d["text"] for d in docs_in) not in candidates["answer"].get(q, ()):
                raise AssertionError("phase 20: a question's reranked candidates are not the index's top "
                                     f"{rag.rerank_candidates} for its own embedding")
            scores = np.asarray(ce.predict([(q, d["text"]) for d in docs_in]), np.float64)
            order = np.argsort(-scores, kind="stable")[:QA_TOPK]
            if [docs_in[int(j)]["text"] for j in order] != [d["text"] for d in kept]:
                raise AssertionError("phase 20: the reranked context differs from the direct cross-encoder order")
            by_question.setdefault(q, set()).add(tuple(d["text"] for d in kept))
        check_s["reranks"] = _now() - t0
        t0 = _now()
        for q, _status, out, *_ in answers:
            ctx = tuple(d["text"] for d in out["context_docs"])
            if ctx not in by_question.get(q, ()):
                raise AssertionError("phase 20: an answer's context_docs are not the reranked candidates")
            if ctx not in solo:
                # the chat renders the QA prompt as one user message
                rendered = messages_to_prompt([{"role": "user", "content": prompt_qa(q, list(ctx))}])
                solo[ctx] = gen.generate([rendered], max_new_tokens=QA_NEW_TOKENS)[0]
            if out["response"] != solo[ctx]:
                raise AssertionError(f"phase 20: an answer differs from the direct generate: {out['response'][:80]!r} "
                                     f"vs {solo[ctx][:80]!r}")
    check_stream.synchronize()
    check_s["solo generates"] = _now() - t0

    # -- the numbers ---------------------------------------------------------------
    def window(kind, t0, t1):
        return [m for m in marks[kind] if t0 <= m[0] and m[1] <= t1]

    split = {"http_queue": [], "tick_wait": [], "embed_search": [], "rerank": [], "decode": [], "other": []}
    for q, _status, _out, ts, tr, arm in answers:
        if arm != "c1":
            continue
        ins, srch, rr, dec = (window(k, ts, tr) for k in ("insert", "search", "rerank", "decode"))
        if len(ins) != 1 or len(srch) != 1 or len(rr) != 1 or len(dec) != 1:
            raise AssertionError(f"phase 20: a c1 answer's steps: {len(ins)} {len(srch)} {len(rr)} {len(dec)}")
        parts = {
            "http_queue": (ins[0][0] - ts) + (tr - dec[0][1]),
            "tick_wait": srch[0][0] - ins[0][1],
            "embed_search": srch[0][1] - srch[0][0],
            "rerank": rr[0][1] - rr[0][0],
            "decode": dec[0][1] - dec[0][0],
        }
        parts["other"] = (tr - ts) - sum(parts.values())
        for key, v in parts.items():
            split[key].append(v * 1e3)
    c1_lat = np.array([(tr - ts) * 1e3 for _q, _s, _o, ts, tr, arm in answers if arm == "c1"])
    tokens = {arm: sum(len(o["response"].split()) for _q, _s, o, _ts, _tr, a in answers if a == arm)
              for arm in ("c1", "c16")}
    dec_s = {arm: sum(m[1] - m[0] for m in marks["decode"]
                      if any(a == arm and ts <= m[0] and m[1] <= tr for _q, _s, _o, ts, tr, a in answers))
             for arm in ("c1", "c16")}
    retrieve_p50 = float(np.percentile([ms for *_r, ms in retrieves], 50))
    fw = QA_NUMBERS.get("framework_retrieve_p50_ms")
    log(
        f"qa (a) {tag}: BaseRAGQuestionAnswerer(search_topk={QA_TOPK}) behind QASummaryRestServer on 127.0.0.1, "
        f"pw.run at a {QA_COMMIT_MS} ms tick: TpuEmbedder (phase 4's encoder) over an IVF DocumentStore of {N_DOCS} "
        f"documents (C={index['answer']._centroids.shape[0]}, full probe), CrossEncoderReranker over "
        f"{rag.rerank_candidates} candidates (CrossEncoderModel 256 wide, 4 layers, bf16), TpuChat(continuous=True) "
        f"over TextGenerator (256 wide, 4 layers, vocab 32768, bf16), {QA_NEW_TOKENS} new tokens; engine start to "
        f"the warm-up {ingest_s:.1f} s, warm-up (the two IVF builds) {report['warm_s']:.1f} s. Checked: every route "
        f"200 with the reference's JSON shape, each operator search == a direct search of its index "
        f"({len(searches['answer'])} answer, {len(searches['retrieve'])} retrieve) on vectors each nearest its own "
        f"question's direct embedding (max abs err {embed_err:.3g}), /v1/retrieve == the index's top {K} for its "
        f"question, each answer's reranked candidates == the index's top {rag.rerank_candidates} for its question "
        f"and its context_docs == the top {QA_TOPK} of CrossEncoderModel.predict over them (stable order), each response == TextGenerator.generate of "
        f"prompt_qa over them called directly ({len(solo)} distinct prompts), garbage body answered as {{}}, a failing "
        f"body 500 JSON and the next request 200, GET on a POST route 405, every model and index on cuda"
    )
    log(
        f"qa numbers {tag}: answer latency (urllib send to receive) c1 p50 {np.percentile(c1_lat, 50):.3f} ms p99 "
        f"{np.percentile(c1_lat, 99):.3f} ms over {QA_C1}; c16 p50 {np.percentile(c16_lat, 50):.3f} ms p99 "
        f"{np.percentile(c16_lat, 99):.3f} ms, {qps:.2f} answers/s over {QA_C16} ({QA_CALLERS} closed-loop callers); "
        f"/v1/retrieve k={K} p50 {retrieve_p50:.3f} ms over {QA_RETRIEVES} (phase 19's retrieve per commit of "
        f"{BATCH}: " + (f"{fw:.3f} ms" if fw is not None else "not run in this invocation")
        + f"; phase 5's direct serve p50 exact {direct_p50['exact']:.3f} ms, IVF {direct_p50['ivf']:.3f} ms); decode "
        f"inside the QA arm {tokens['c1'] / max(dec_s['c1'], 1e-9):.1f} tokens/s at c1, "
        f"{tokens['c16'] / max(dec_s['c16'], 1e-9):.1f} tokens/s at c16 (tokens over the chat calls' seconds; the "
        f"engine answers a tick's rows one after another); c1 split, mean ms: "
        + ", ".join(f"{k} {np.mean(v):.3f}" for k, v in split.items())
        + f" (http_queue: send to the row's insert plus the decode's end to receive; tick_wait: insert to the "
        f"search; other: the engine's row plumbing); a burst of {QA_BURST} answers at c{QA_BURST} under torch.profiler: "
        f"{report['busy']} (the profiler's own read {report['profiler_s']:.1f} s); kernel launches on the QA path "
        f"{launches}; the checks' seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in check_s.items())
        + f"; phase 20 (a) {_now() - t_phase:.1f} s"
    )
    big = max((vecs for _texts, vecs, _k, _got in searches["answer"]), key=len)
    shape = rescore_at_path_shape(index["answer"], ivf_search_rescore_args(index["answer"], big), dev)
    log(f"ivf_rescore at the QA path's shape {tag}: " + rescore_line(index["answer"], shape))
    pw.reset()
    return launches, shape


def template_spec(name: str) -> dict:
    """``templates/<name>.yaml`` as the port's loader parses it, ``!pw.``
    nodes deferred, written in Python for a machine without PyYAML
    (``tests/test_torch_templates.py`` holds it against the parsed file);
    ``yaml_loader.build_template`` builds it as ``load_yaml`` would."""
    from pathway_tpu_torch.internals.yaml_loader import _Deferred

    def node(tag, /, **kwargs):
        return _Deferred(f"pw.{tag}", "map", kwargs)

    store = node(
        "xpacks.llm.document_store.DocumentStore",
        docs=node("io.fs.read", path="$data_dir", format="plaintext_by_file", with_metadata=True, mode="streaming"),
        splitter=node("xpacks.llm.splitters.TokenCountSplitter", max_tokens=120),
        retriever_factory=node("stdlib.indexing.BruteForceKnnFactory",
                               embedder=node("xpacks.llm.embedders.TpuEmbedder", dimension=128, n_layers=2,
                                             max_length=64)),
    )
    llm = node("xpacks.llm.llms.TpuChat", max_new_tokens=16)
    if name == "demo_question_answering":
        qa = node("xpacks.llm.question_answering.BaseRAGQuestionAnswerer", llm=llm, search_topk=3, indexer=store)
    else:
        qa = node("xpacks.llm.question_answering.AdaptiveRAGQuestionAnswerer", llm=llm, indexer=store,
                  n_starting_documents=1, factor=2, max_iterations=3)
    return {"$data_dir": "templates/sample_documents", "$host": "127.0.0.1", "$port": 8000, "host": "$host",
            "port": "$port", "question_answerer": qa}


def template_phase(tag: str) -> None:
    """Phase 20 (b): the demo and adaptive templates served by
    ``python -m pathway_tpu_torch.cli run`` on the card, checked as the
    reference's template tests check them."""
    import importlib.util
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    has_yaml = importlib.util.find_spec("yaml") is not None
    if not has_yaml:
        log("PyYAML absent: template built in Python")
    lines = []
    for name in QA_TEMPLATES:
        port = _free_port()
        if has_yaml:
            cmd = [sys.executable, "-m", "pathway_tpu_torch.cli", "run", f"templates/{name}.yaml", "--port", str(port)]
        else:
            cmd = [sys.executable, os.path.abspath(__file__), "--serve-template", name, str(port)]
        with tempfile.TemporaryFile(mode="w+") as out:
            t0 = _now()
            proc = subprocess.Popen(cmd, cwd=root, stdout=out, stderr=subprocess.STDOUT, text=True)
            try:
                while True:
                    if proc.poll() is not None or _now() - t0 > QA_TEMPLATE_WAIT_S:
                        out.seek(0)
                        raise AssertionError(f"phase 20 (b): {name} did not come up:\n{out.read()[-3000:]}")
                    try:
                        if _http(port, "POST", "/v1/retrieve", {"query": "cats", "k": 1}, timeout=5)[0] == 200:
                            break
                    except OSError:
                        pass
                    time.sleep(0.5)
                up_s = _now() - t0
                status, answer, _ts, t_answer = _http(port, "POST", "/v1/pw_ai_answer", {"prompt": "What do cats do?"})
                if status != 200 or not isinstance(answer, str) or not answer.strip():
                    raise AssertionError(f"phase 20 (b): {name} answered {status}: {answer!r}")
                first_answer_s = t_answer - t0
                status, retrieved, _ts, _tr = _http(port, "POST", "/v1/retrieve", {"query": "anything", "k": 3})
                if status != 200 or len(retrieved) != 3 or not all("text" in d and "metadata" in d for d in retrieved):
                    raise AssertionError(f"phase 20 (b): {name} retrieve {status}: {str(retrieved)[:300]}")
                if name == "demo_question_answering":
                    stats = _http(port, "POST", "/v1/statistics", {})[1]
                    listed = _http(port, "POST", "/v1/pw_list_documents", {})[1]
                    summary = _http(port, "POST", "/v1/pw_ai_summary", {"text_list": ["cats purr", "dogs bark"]})[1]
                    files = {d["path"].rsplit("/", 1)[-1] for d in listed}
                    if (stats.get("file_count", 0) < 3 or not {"animals.txt", "dataflow.txt", "tpu.txt"} <= files
                            or not isinstance(summary, str) or not summary.strip()):
                        raise AssertionError(f"phase 20 (b): demo routes: {stats} {sorted(files)} {summary!r}")
                else:
                    if not any("sample_documents" in d["metadata"]["path"] for d in retrieved):
                        raise AssertionError(f"phase 20 (b): adaptive retrieve: {str(retrieved)[:300]}")
            finally:
                proc.kill()
                proc.wait(timeout=60)
        how = "cli run" if has_yaml else "cli.serve_config of the objects built in Python"
        lines.append(f"{name} ({how}, --device cuda): up in {up_s:.1f} s, first answer {first_answer_s:.1f} s "
                     f"after the start, answer {answer[:40]!r}")
    log(f"qa (b) {tag}: " + "; ".join(lines) + "; the demo's five routes and the adaptive answer checked as "
        "tests/test_templates.py does")


# -- phase 21: durable pipelines ------------------------------------------------------
PS_FILES = 16  # (a) run 1: 16 JSON-lines files of PS_FILE_DOCS documents
PS_FILE_DOCS = 4096
PS_NEW_FILES = 2  # (a) run 2 adds these
PS_COMMITS = 4  # query commits of BATCH per run
PS_COMMIT_MS = 10  # the engine's commit tick
PS_SNAPSHOT_MS = 1  # below the tick: every tick's commit is snapshotted
PS_CRASH_FILES = 4  # (b): 4 files of PS_CRASH_FILE_DOCS, 2 before the kill
PS_CRASH_FILE_DOCS = 1024
PS_CRASH_QUERIES = 64
PS_WORKER_TIMEOUT_S = 240.0
PS_TOL = 2e-2  # bf16 trunk: a document's row moves with the packed batch it is embedded in
PS_MEM_SLACK = 0.10
PS_WORKER_CMD = (sys.executable, os.path.abspath(__file__))  # how arm (b) starts this script


def _ps_embedder():
    """Phase 19's seeded ``TpuEmbedder`` (phase 4's encoder, bf16)."""
    from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder

    return TpuEmbedder(dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768, seed=SEED,
                       dtype=torch.bfloat16)


def _ps_write_docs(folder: str, first: int, texts, per_file: int) -> None:
    """``texts`` as JSON-lines files of ``per_file`` documents, ``doc_id``
    from ``first``; each written beside the folder and moved in whole."""
    os.makedirs(folder, exist_ok=True)
    for f in range(0, len(texts), per_file):
        name = f"part{(first + f) // per_file:03d}.jsonl"
        tmp = os.path.join(os.path.dirname(folder), name + ".part")
        with open(tmp, "w") as out:
            for i, text in enumerate(texts[f : f + per_file]):
                out.write(json.dumps({"doc_id": first + f + i, "text": text}) + "\n")
        os.replace(tmp, os.path.join(folder, name))


def _ps_graph(pw, emb, docs_dir: str, queries, mode: str = "static"):
    """The phase's graph over ``queries`` (a table with a ``query`` column):
    documents read with ``persistent_id="docs"``, embedded once per delta;
    a hybrid DataIndex (IVF at full probe + BM25, reciprocal rank fusion)
    over ``(vector, text)`` and a vector-only DataIndex over the same IVF
    shape.  Returns ``(vecs, {"hybrid": result, "vector": result})``."""
    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str

    mod = pw.stdlib.indexing
    docs = pw.io.jsonlines.read(docs_dir, schema=Doc, mode=mode, persistent_id="docs", name="persist_docs",
                                poll_interval_s=0.1)
    vecs = docs.select(pw.this.doc_id, pw.this.text, vec=emb(pw.this.text))
    vecs = vecs.with_columns(both=pw.make_tuple(pw.this.vec, pw.this.text))
    qs = queries.select(pw.this.query, qvec=emb(pw.this.query))
    qs = qs.with_columns(qboth=pw.make_tuple(pw.this.qvec, pw.this.query))
    full = 1 << 30
    hybrid = mod.DataIndex(vecs, mod.InnerIndex(
        data_column=vecs.both, dimension=DIM,
        factory=mod.HybridIndexFactory([mod.IvfKnnFactory(dimension=DIM, n_probe=full), mod.TantivyBM25Factory()]),
    ))
    vector = mod.DataIndex(vecs, mod.InnerIndex(
        data_column=vecs.vec, dimension=DIM, factory=mod.IvfKnnFactory(dimension=DIM, n_probe=full),
    ))
    out = {}
    for name, index, col in (("hybrid", hybrid, qs.qboth), ("vector", vector, qs.qvec)):
        res = index.query(col, number_of_matches=K)
        out[name] = res.select(query=qs.query, ids=vecs.doc_id, scores=res.score)
    return vecs, out


def _ps_ops(pw):
    """{"hybrid": op, "vector": op}: the graph's two index operators."""
    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator

    ops = [op for op in pw.G.engine_graph.operators if isinstance(op, ExternalIndexOperator)]
    if len(ops) != 2:
        raise AssertionError(f"phase 21: {len(ops)} index operators, expected 2")
    return dict(zip(("hybrid", "vector"), ops))


def _ps_ivf(op):
    """The IvfKnnIndex of an index operator (the hybrid's first sub-index)."""
    index = op.index
    return index.indexes[0].index if hasattr(index, "indexes") else index.index


def _ps_allocated(dev) -> int:
    """``torch.cuda.memory_allocated`` with garbage collected and the
    cuBLAS workspaces released: PyTorch keeps one per (handle, stream) a
    matmul ran on (32 MiB each on this card), which is not the indexes'
    memory."""
    import gc

    if dev.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize(dev)
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated(dev)


def _ps_no_torch(store: str) -> int:
    """Unpickle every blob of the store (each framed record of a chunk)
    and fail on any torch class; returns the records read."""
    import pickle

    from pathway_tpu_torch.persistence.framing import scan

    class NoTorch(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] == "torch":
                raise AssertionError(f"phase 21: a snapshot holds {module}.{name}")
            return super().find_class(module, name)

    n = 0
    for base, _dirs, files in os.walk(store):
        for f in files:
            blob = open(os.path.join(base, f), "rb").read()
            if f.startswith("chunk-"):
                payloads, _intact = scan(blob[4:] if blob.startswith(b"PWC1") else blob)
            else:
                payloads = [blob]
            for p in payloads:
                NoTorch(io.BytesIO(p)).load()
                n += 1
    return n


def _ps_state(book) -> dict:
    """The final answer per query text of an update stream of
    ``(row, diff)``: {query: [(doc_id, score), ...]}."""
    count = {}
    for row, diff in book:
        answer = tuple((int(i), float(s)) for i, s in zip(row["ids"], row["scores"]))
        per_query = count.setdefault(row["query"], {})
        per_query[answer] = per_query.get(answer, 0) + diff
    state = {}
    for query, answers in count.items():
        live = [a for a, n in answers.items() if n > 0]
        if len(live) != 1 or answers[live[0]] != 1:
            raise AssertionError(f"phase 21: {len(live)} live answers for one query")
        state[query] = list(live[0])
    return state


def _ps_rrf(per_index, k: int, k_constant: float = 60.0):
    fused = {}
    for rows in per_index:
        for rank, (key, _s) in enumerate(rows):
            fused[key] = fused.get(key, 0.0) + 1.0 / (k_constant + rank + 1)
    return sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def _ps_exact(ivf, vecs: np.ndarray, k: int, dev, cache: dict):
    """Exact scan of every row the IVF index holds: top ``k`` keys and
    cosine scores per query, on the card (the row matrix is kept in
    ``cache`` per index)."""
    if id(ivf) not in cache:
        keys = list(ivf._rows)
        cache[id(ivf)] = (keys, torch.from_numpy(np.stack([ivf._rows[key] for key in keys])).to(dev))
    keys, mat = cache[id(ivf)]
    q = torch.from_numpy(vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).to(dev)
    scores, idx = torch.topk(q @ mat.t(), k, dim=1)
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
    return [[(keys[j], float(s)) for j, s in zip(ri, rs)] for ri, rs in zip(idx, scores)]


def _ps_run(pw, emb, root: str, store: str, commits, run: int, dev, profile_run: bool):
    """One run of arm (a): the graph over ``root/docs`` and a persisted
    query subject, ``pw.run`` under a filesystem persistence config; the
    driver thread waits for the replayed queries' answers (run 2), then
    puts ``commits`` one at a time.  Checks each operator's answers
    against a direct search of its own index, the IVF side against an
    exact scan, the fused lists against an RRF of the sub-indexes' own
    searches at 2k; returns what the cross-run checks read."""
    from pathway_tpu_torch.io import fs as pw_fs
    from pathway_tpu_torch.io._offsets import connector_monitors
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.persistence.backends import FileBackend
    from pathway_tpu_torch.persistence.engine_state import PersistenceManager
    from pathway_tpu_torch.stdlib.indexing.bm25 import BM25Index
    from torch.profiler import ProfilerActivity, profile

    driver = _FrameworkDriver("phase 21")
    subject, q = _queue_subject(pw, "queries", driver)
    queries = pw.io.python.read(subject, schema=pw.schema_from_types(query=str), atomic_batches=True,
                                persistent_id="queries", name="persist_queries")
    vecs, results = _ps_graph(pw, emb, os.path.join(root, "docs"), queries)
    books = {name: [] for name in results}
    for name, table in results.items():
        def on_change(key, row, time, is_addition, book=books[name], name=name):
            with driver.cond:
                book.append((row, 1 if is_addition else -1))
                driver.arrival.setdefault(name, []).append((_now(), row["query"]))
                driver.cond.notify_all()

        pw.io.subscribe(table, on_change=on_change, on_time_end=driver.on_tick)
    ops = _ps_ops(pw)
    added, searched = {n: [] for n in ops}, {n: [] for n in ops}
    for name, op in ops.items():
        inner = op.index

        def add(keys, values, metadatas, orig=inner.add, name=name):
            orig(keys, values, metadatas)
            with driver.cond:
                added[name].append(_now())
                driver.cond.notify_all()

        def search(values, k, filters, orig=inner.search, name=name):
            t0 = _now()
            out = orig(values, k, filters)
            searched[name].append((list(values), k, out, (_now() - t0) * 1e3))
            return out

        inner.add, inner.search = add, search
    hybrid = ops["hybrid"].index
    bm25_ms = []
    orig_bm25 = BM25Index.search

    def bm25_search(self, values, k, filters):
        t0 = _now()
        try:
            return orig_bm25(self, values, k, filters)
        finally:
            bm25_ms.append((_now() - t0) * 1e3)

    commits_timed, put_bytes = [], [0]
    orig_commit, orig_put = PersistenceManager.commit, FileBackend.put

    def commit(self, ts):
        t0, b0 = _now(), put_bytes[0]
        orig_commit(self, ts)
        commits_timed.append((_now() - t0, put_bytes[0] - b0))

    def put(self, key, value):
        put_bytes[0] += len(value)
        return orig_put(self, key, value)

    parsed = []
    orig_parse = pw_fs._parse_into

    def parse_into(fpath, *args, **kwargs):
        parsed.append(os.path.basename(fpath))
        return orig_parse(fpath, *args, **kwargs)

    report = {}
    n_replayed = BATCH * PS_COMMITS if run == 2 else 0

    def answered(name):
        return len({row["query"] for row, d in books[name] if d > 0})

    def drive():
        driver.wait(lambda: all(added[n] for n in ops), "the documents")
        report["ingest_s"] = max(added[n][0] for n in ops) - report["t_run"]
        if n_replayed:
            driver.wait(lambda: all(answered(n) >= n_replayed for n in ops), "the replayed queries")
        latency = {n: [] for n in ops}
        bm25_per_commit = []
        for c, texts in enumerate(commits):
            n_bm25 = len(bm25_ms)
            q.put([{"query": t} for t in texts])
            want = n_replayed + (c + 1) * BATCH
            driver.wait(lambda: all(answered(n) >= want for n in ops) and len(driver.commit_at.get("queries", ())) > c,
                        f"query commit {c} of run {run}")
            t_commit = driver.commit_at["queries"][c]
            mine = set(texts)
            for n in ops:
                latency[n].append((max(t for t, qt in driver.arrival[n] if qt in mine) - t_commit) * 1e3)
            bm25_per_commit.append(sum(bm25_ms[n_bm25:]))
        report["latency"], report["bm25_ms"] = latency, bm25_per_commit

    def run_driver():
        try:
            drive()
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread after the run
            report["error"] = exc
        finally:
            q.put(None)

    PersistenceManager.commit, FileBackend.put = commit, put
    BM25Index.search, pw_fs._parse_into = bm25_search, parse_into
    before = rescore_shortlist.launches
    config = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(store),
                                                 snapshot_interval_ms=PS_SNAPSHOT_MS)
    thread = threading.Thread(target=run_driver, daemon=True, name=f"phase21-run{run}")
    prof = profile(activities=[ProfilerActivity.CUDA]) if profile_run and dev.type == "cuda" else None
    try:
        if prof is not None:
            prof.__enter__()
        report["t_run"] = _now()
        thread.start()
        try:
            pw.run(commit_duration_ms=PS_COMMIT_MS, persistence_config=config)
        finally:
            driver.stop = True
            thread.join(timeout=60)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (_now() - report["t_run"]) * 1e3
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        PersistenceManager.commit, FileBackend.put = orig_commit, orig_put
        BM25Index.search, pw_fs._parse_into = orig_bm25, orig_parse
        for op in ops.values():  # the checks below search the indexes themselves
            del op.index.add, op.index.search
    launches = rescore_shortlist.launches - before
    if "error" in report:
        raise report["error"]
    first_answer = min(t for n in ops for t, _q in driver.arrival[n])

    # -- checks of the run ----------------------------------------------------------
    ivfs = {n: _ps_ivf(op) for n, op in ops.items()}
    for n, ivf in ivfs.items():
        if ivf._slabs is None or ivf._slabs.device.type != dev.type or ivf._centroids.device.type != dev.type:
            raise AssertionError(f"phase 21: the {n} IVF index lives on {getattr(ivf._slabs, 'device', None)}")
    v_keys, v_cols = vecs._materialize()
    n_rows = len(v_keys)
    doc_ids = [int(x) for x in v_cols["doc_id"]]
    key_set = {int(k) for k in v_keys}
    bm25 = hybrid.indexes[1]
    exact_mats = {}
    for n, ivf in ivfs.items():
        if len(ivf) != n_rows or set(ivf._rows) != key_set:
            raise AssertionError(f"phase 21: the {n} IVF index holds {len(ivf)} rows, the table {n_rows}")
    if len(set(doc_ids)) != n_rows or len(bm25.doc_tokens) != n_rows:
        raise AssertionError(f"phase 21: {n_rows} rows for {len(set(doc_ids))} documents, BM25 {len(bm25.doc_tokens)}")
    states = {n: _ps_state(books[n]) for n in ops}
    n_queries = n_replayed + len(commits) * BATCH
    for n, state in states.items():
        if len(state) != n_queries or any(len(r) != K for r in state.values()):
            raise AssertionError(f"phase 21: run {run}'s {n} arm answered {len(state)} of {n_queries} queries")
    # the engine's searches == a direct search of the operator's index; the
    # IVF side == an exact scan; the fused list == RRF of the sub-indexes'
    # own searches at 2k, taken from inside the direct search
    t_check = _now()
    ivf_mismatch = exact_checked = 0
    hybrid_searches = searched["hybrid"]
    for n, op in ops.items():
        for values, k, got, _ms in searched[n]:
            subs = []
            if n == "hybrid":
                for j, sub in enumerate(hybrid.indexes):
                    def sub_search(vals, kk, filters, orig=sub.search, j=j):
                        rows = orig(vals, kk, filters)
                        subs.append((j, kk, rows))
                        return rows

                    sub.search = sub_search
            try:
                want = op.index.search(values, k, [None] * len(values))
            finally:
                for sub in hybrid.indexes:
                    sub.__dict__.pop("search", None)
            if [list(r) for r in got] != [list(r) for r in want]:
                raise AssertionError(f"phase 21: run {run}'s {n} answers differ from a direct search of its index")
            vec = np.stack([np.asarray(v[0] if n == "hybrid" else v, np.float32) for v in values])
            if n == "hybrid":
                (_j0, k0, vec_rows), (_j1, k1, text_rows) = sorted(subs, key=lambda x: x[0])
                if (k0, k1) != (2 * k, 2 * k):
                    raise AssertionError(f"phase 21: the hybrid searched its sub-indexes at {k0}, {k1}, not {2 * k}")
                for i, row in enumerate(got):
                    fused = _ps_rrf([vec_rows[i], text_rows[i]], k)
                    if [key for key, _ in row] != [key for key, _ in fused] or max(
                            abs(a - b) for (_, a), (_, b) in zip(row, fused)) > 1e-12:
                        raise AssertionError(f"phase 21: run {run}'s fused list differs from the RRF of its "
                                             f"sub-searches")
                exact, ivf_rows = _ps_exact(ivfs[n], vec, 2 * k, dev, exact_mats), vec_rows
            else:
                exact, ivf_rows = _ps_exact(ivfs[n], vec, k, dev, exact_mats), got
            ivf_mismatch += sum(1 for w, g in zip(exact, ivf_rows) if not same_ranking(w, list(g)))
            exact_checked += len(exact)
    if ivf_mismatch:
        raise AssertionError(f"phase 21: run {run}: IVF at full probe != the exact scan on {ivf_mismatch} queries")
    del exact_mats
    check_s = _now() - t_check
    (mon,) = [m for m in connector_monitors() if m.name == "persist_docs" and m.finished]
    out = {
        "states": states, "launches": launches, "ingest_s": report["ingest_s"], "latency": report["latency"],
        "bm25_ms": report["bm25_ms"], "restart_s": first_answer - report["t_run"], "wall_ms": wall_ms,
        "commits": commits_timed, "parsed": parsed, "rows_read": mon.rows_inserted, "n_rows": n_rows,
        "exact_checked": exact_checked, "check_s": check_s, "busy": None, "shape": None, "shape_line": None,
        "ivf_shape_vecs": np.stack([np.asarray(v, np.float32) for v in searched["vector"][-1][0]]),
        "rows": {key: ivfs["vector"]._rows[key].copy() for key in ivfs["vector"]._rows},
        "doc_of_key": dict(zip((int(k) for k in v_keys), doc_ids)),
        "query_vecs": {v[1]: np.asarray(v[0], np.float32) for vals, _k, _g, _ms in hybrid_searches for v in vals},
        "search_ms": {n: [ms for vals, _k, _g, ms in searched[n] if len(vals) == BATCH] for n in ops},
    }
    if profile_run and dev.type == "cuda":
        out["busy"] = device_busy(prof, wall_ms)
        out["shape"] = rescore_at_path_shape(ivfs["vector"], ivf_search_rescore_args(ivfs["vector"],
                                                                                  out["ivf_shape_vecs"]), dev)
        out["shape_line"] = rescore_line(ivfs["vector"], out["shape"])
    return out


def persist_worker(root: str, mode: str, out_csv: str) -> int:
    """Arm (b)'s program: the phase's graph over ``root/docs`` and the
    JSON-lines queries under ``root/queries`` (both persisted), the
    answers written to ``out_csv`` (``.hybrid.csv`` and ``.vector.csv``);
    ``streaming`` runs until killed, ``static`` ends when both folders are
    read.  Persistence comes from the environment
    (``PATHWAY_PERSISTENT_STORAGE``).  Prints ``RESULT {json}`` at the end."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.kernels.build import build_all, build_host
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist

    build_all()
    build_host("tokenize_hash")
    emb = _ps_embedder()
    queries = pw.io.jsonlines.read(os.path.join(root, "queries"), schema=pw.schema_from_types(query=str), mode=mode,
                                   persistent_id="queries", name="persist_worker_queries", poll_interval_s=0.1)
    _vecs, results = _ps_graph(pw, emb, os.path.join(root, "docs"), queries, mode=mode)
    for name, table in results.items():
        flat = table.select(
            pw.this.query,
            ids=pw.apply(lambda t: " ".join(str(int(x)) for x in t), pw.this.ids),
            scores=pw.apply(lambda t: " ".join(repr(float(x)) for x in t), pw.this.scores),
        )
        pw.io.csv.write(flat, f"{out_csv}.{name}.csv")
    ops = _ps_ops(pw)
    pw.run(commit_duration_ms=PS_COMMIT_MS)
    sizes = {n: len(_ps_ivf(op)) for n, op in ops.items()}
    sizes["bm25"] = len(ops["hybrid"].index.indexes[1].doc_tokens)
    print("RESULT " + json.dumps({"rows": sizes, "launches": rescore_shortlist.launches}), flush=True)
    return 0


def _ps_sink(path: str) -> dict:
    """The final answer per query of a worker's CSV sink (an update stream
    with time and diff columns): {query: [(doc_id, score), ...]}."""
    import csv as csv_mod

    latest = {}
    with open(path, newline="") as f:
        for row in csv_mod.DictReader(f):
            t, diff = int(row["time"]), int(row["diff"])
            prev = latest.get(row["query"])
            if diff > 0 and (prev is None or t >= prev[0]):
                latest[row["query"]] = (t, row)
            elif diff < 0 and prev is not None and t > prev[0] and prev[1]["ids"] == row["ids"]:
                latest.pop(row["query"])
    return {
        qt: [(int(i), float(s)) for i, s in zip(row["ids"].split(), row["scores"].split())]
        for qt, (_t, row) in latest.items()
    }


def _ps_worker(root: str, mode: str, out: str, store: str, argv_prefix=()):
    env = dict(os.environ)
    env.update(PATHWAY_PERSISTENT_STORAGE=store, PATHWAY_PERSISTENCE_MODE="PERSISTING",
               PATHWAY_SNAPSHOT_INTERVAL_MS=str(PS_SNAPSHOT_MS), PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    cmd = [*argv_prefix, *PS_WORKER_CMD, "--persist-worker", root, mode, out]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _ps_finish(proc, what: str):
    try:
        out, err = proc.communicate(timeout=PS_WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"phase 21: {what} did not finish in {PS_WORKER_TIMEOUT_S} s")
    results = [json.loads(line[7:]) for line in out.splitlines() if line.startswith("RESULT ")]
    if proc.returncode != 0 or len(results) != 1:
        raise AssertionError(f"phase 21: {what} exited {proc.returncode}:\n{err[-3000:]}")
    return results[0], err


def _ps_same_sinks(want: dict, got: dict, what: str) -> int:
    if set(want) != set(got):
        raise AssertionError(f"phase 21: {what} answered {len(got)} queries, the uninterrupted run {len(want)}")
    bad = [qt for qt in want if not same_ranking(want[qt], got[qt], tie=PS_TOL, atol=PS_TOL)]
    if bad:
        raise AssertionError(f"phase 21: {what} differs from the uninterrupted run on {len(bad)} queries: "
                             f"{want[bad[0]][:3]} vs {got[bad[0]][:3]}")
    return len(want)


def persist_phase(tag: str):
    """Phase 21: durable pipelines.  (a) A hybrid (IVF + BM25, RRF) and a
    vector-only ``DataIndex`` over 65,536 JSON-lines documents and 4
    persisted query commits of 64, run under ``pw.run(persistence_config=
    ...)``, then ``pw.reset()`` and a second run of the same graph over the
    same store with 2 new files and 4 new commits.  Both IVF indexes run at
    full probe on purpose: replay pushes the whole log at once, so the
    restarted index is trained on every row in one go where a first run may
    build and then absorb, and only at full probe must the two layouts give
    the same ranks.  (b) A subprocess on the card killed by SIGKILL after 2
    snapshot commits, restarted, and held against an uninterrupted run;
    then a torn tail of its log.  (c) ``python -m pathway_tpu_torch.cli
    replay`` of (b)'s store.  Returns (rescore launches, the kernel at the
    phase's shape)."""
    import gc
    import pickle
    import shutil
    import signal
    import tempfile

    import pathway_tpu_torch as pw

    t_phase = _now()
    dev = torch.device(DEVICE)
    root = tempfile.mkdtemp(prefix="phase21-")
    try:
        pw.reset()
        docs = corpus(N_DOCS)
        late = [t + f" late{i}" for i, t in enumerate(corpus(PS_NEW_FILES * PS_FILE_DOCS, seed=SEED + 21))]
        qidx = query_ids()
        commits = [[docs[j] for j in qidx[c * BATCH : (c + 1) * BATCH]] for c in range(2 * PS_COMMITS)]
        _ps_write_docs(os.path.join(root, "docs"), 0, docs[: PS_FILES * PS_FILE_DOCS], PS_FILE_DOCS)
        emb = _ps_embedder()
        mem_before = _ps_allocated(dev)
        store = os.path.join(root, "store")
        r1 = _ps_run(pw, emb, root, store, commits[:PS_COMMITS], 1, dev, profile_run=False)
        log(f"persist run 1 {tag}: {r1['wall_ms'] / 1e3:.1f} s, checks {r1['check_s']:.1f} s")
        pw.reset()
        mem_after = _ps_allocated(dev)
        if dev.type == "cuda" and abs(mem_after - mem_before) > PS_MEM_SLACK * max(mem_before, 1):
            raise AssertionError(f"phase 21: after pw.reset() {mem_after} bytes allocated, {mem_before} before run 1")
        _ps_no_torch(store)
        _ps_write_docs(os.path.join(root, "docs"), N_DOCS, late, PS_FILE_DOCS)
        r2 = _ps_run(pw, emb, root, store, commits[PS_COMMITS:], 2, dev, profile_run=True)
        log(f"persist run 2 {tag}: {r2['wall_ms'] / 1e3:.1f} s, checks {r2['check_s']:.1f} s")
        n_records = _ps_no_torch(store)
        new_files = sorted({f"part{(N_DOCS + f) // PS_FILE_DOCS:03d}.jsonl"
                            for f in range(0, len(late), PS_FILE_DOCS)})
        if sorted(r2["parsed"]) != new_files or r2["rows_read"] != len(late):
            raise AssertionError(f"phase 21: run 2's reader opened {sorted(r2['parsed'])} and read "
                                 f"{r2['rows_read']} rows; only {new_files} ({len(late)} rows) are new")
        if r2["n_rows"] != N_DOCS + len(late):
            raise AssertionError(f"phase 21: run 2's index holds {r2['n_rows']} rows")

        # -- restart == a process that never stopped -----------------------------------
        # the restarted rows are run 1's rows (re-embedded: the packed batch moves bf16 rows)
        common = [k for k in r1["rows"] if k in r2["rows"]]
        row_err = max(float(np.max(np.abs(r1["rows"][k] - r2["rows"][k]))) for k in common)
        if len(common) != N_DOCS or row_err > PS_TOL:
            raise AssertionError(f"phase 21: {len(common)} of run 1's rows back, max abs err {row_err}")
        # a replayed query's vector answer is run 1's answer merged with the new documents
        late_keys = [k for k, d in r2["doc_of_key"].items() if d >= N_DOCS]
        late_mat = torch.from_numpy(np.stack([r2["rows"][k] for k in late_keys])).to(dev)
        late_doc = [r2["doc_of_key"][k] for k in late_keys]
        replay_bad = 0
        replayed = [t for c in commits[:PS_COMMITS] for t in c]
        for qt in replayed:
            qv = r2["query_vecs"][qt]
            qv = torch.from_numpy(qv / np.linalg.norm(qv)).to(dev)
            ls, li = torch.topk(late_mat @ qv, K)
            merged = sorted(r1["states"]["vector"][qt] + [(late_doc[j], float(s)) for j, s in
                                                          zip(li.cpu().numpy(), ls.cpu().numpy())],
                            key=lambda r: -r[1])[:K]
            if not same_ranking(merged, r2["states"]["vector"][qt], tie=PS_TOL, atol=PS_TOL):
                replay_bad += 1
        if replay_bad:
            raise AssertionError(f"phase 21: {replay_bad} replayed queries answer otherwise than run 1 with the "
                                 f"new documents merged in")
        late_first = sum(1 for qt in replayed if any(d >= N_DOCS for d, _ in r2["states"]["vector"][qt]))
        c1 = [r[0] for r in r1["commits"]]
        b1 = [r[1] for r in r1["commits"]]
        log(
            f"persist (a) {tag}: run 1 read {PS_FILES} files of {PS_FILE_DOCS} JSON-lines documents and answered "
            f"{PS_COMMITS} commits of {BATCH} queries (k={K}) in a hybrid (IVF full probe + BM25, RRF k=60) and a "
            f"vector-only DataIndex; run 2 after pw.reset() over the same store opened {len(r2['parsed'])} files "
            f"({', '.join(r2['parsed'])}, {r2['rows_read']} rows counted by the connector's monitor), holds "
            f"{r2['n_rows']} rows each key once, re-answered the {len(replayed)} replayed queries (vector arm "
            f"== run 1's answer with the new documents merged in on all, {late_first} with a new document in "
            f"the top {K}; rows back within {row_err:.6f} of run 1's) and answered {PS_COMMITS} new commits; every "
            f"answer of both runs == a direct search of its operator's index, IVF == an exact scan "
            f"({r1['exact_checked'] + r2['exact_checked']} searches), fused == RRF of the sub-searches at 2k; "
            f"index tensors on cuda; allocated {mem_before / 1e6:.1f} MB before run 1, {mem_after / 1e6:.1f} MB "
            f"after its reset (cuBLAS workspaces released before each reading); {n_records} snapshot records "
            f"unpickled, no torch class"
        )

        # -- (b) crash: SIGKILL after 2 snapshot commits, restart, torn tail -------------
        t_b = _now()
        crash, clean = os.path.join(root, "crash"), os.path.join(root, "clean")
        crash_docs = [t + f" crash{i}" for i, t in enumerate(corpus(PS_CRASH_FILES * PS_CRASH_FILE_DOCS,
                                                                     seed=SEED + 22))]
        crash_queries = [crash_docs[(i * 97) % len(crash_docs)] for i in range(PS_CRASH_QUERIES)]
        half = PS_CRASH_FILES // 2 * PS_CRASH_FILE_DOCS
        for folder, n in ((crash, half), (clean, len(crash_docs))):
            _ps_write_docs(os.path.join(folder, "docs"), 0, crash_docs[:n], PS_CRASH_FILE_DOCS)
            os.makedirs(os.path.join(folder, "queries"))
            with open(os.path.join(folder, "queries", "q.jsonl"), "w") as f:
                f.writelines(json.dumps({"query": t}) + "\n" for t in crash_queries)
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the workers share the card: hand back what this process only caches
        clean_proc = _ps_worker(clean, "static", os.path.join(clean, "out"), os.path.join(clean, "store"))
        crash_store = os.path.join(crash, "store")
        proc = _ps_worker(crash, "streaming", os.path.join(crash, "out"), crash_store)
        seen = set()
        deadline = _now() + PS_WORKER_TIMEOUT_S
        while True:
            blob = None
            try:
                blob = open(os.path.join(crash_store, "COMMIT"), "rb").read()
            except OSError:
                pass
            if blob:
                meta = os.path.join(crash_store, "sources", "docs", "METADATA")
                offsets = pickle.loads(open(meta, "rb").read()).get("offsets") if os.path.exists(meta) else None
                if offsets and len(offsets) == PS_CRASH_FILES // 2:
                    seen.add(pickle.loads(blob)["frontier"])
            if len(seen) >= 2:
                break
            if proc.poll() is not None or _now() > deadline:
                proc.kill()
                raise AssertionError(f"phase 21: the crash run ended before 2 snapshot commits:\n"
                                     f"{proc.communicate()[1][-3000:]}")
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        killed_at = _now() - t_b
        _ps_write_docs(os.path.join(crash, "docs"), half, crash_docs[half:], PS_CRASH_FILE_DOCS)
        restarted, _err = _ps_finish(_ps_worker(crash, "static", os.path.join(crash, "out"), crash_store),
                                     "the restarted run")
        clean_res, _err = _ps_finish(clean_proc, "the uninterrupted run")
        n_docs_b = len(crash_docs)
        for res, what in ((restarted, "restarted"), (clean_res, "uninterrupted")):
            if res["rows"] != {"hybrid": n_docs_b, "vector": n_docs_b, "bm25": n_docs_b}:
                raise AssertionError(f"phase 21: the {what} run's indexes hold {res['rows']}")
        n_same = 0
        for arm in ("hybrid", "vector"):
            n_same += _ps_same_sinks(_ps_sink(os.path.join(clean, f"out.{arm}.csv")),
                                     _ps_sink(os.path.join(crash, f"out.{arm}.csv")), f"the restarted run's {arm} sink")

        # -- (c) the command line replays (b)'s store (a copy), while the original's
        # last chunk is torn by a few bytes: replay stops at the last intact record,
        # the log rewinds, and every document is still indexed
        t_c = _now()
        replay_store = os.path.join(root, "replay-store")
        shutil.copytree(crash_store, replay_store)
        replay_proc = _ps_worker(crash, "static", os.path.join(crash, "replay"), replay_store,
                                 argv_prefix=(sys.executable, "-m", "pathway_tpu_torch.cli", "replay",
                                              "--record-path", replay_store))
        chunks = sorted(p for p in os.listdir(os.path.join(crash_store, "sources", "docs")) if p.startswith("chunk-"))
        torn = os.path.join(crash_store, "sources", "docs", chunks[-1])
        blob = open(torn, "rb").read()
        open(torn, "wb").write(blob[:-5])
        torn_proc = _ps_worker(crash, "static", os.path.join(crash, "torn"), crash_store)
        replayed_res, _err = _ps_finish(replay_proc, "cli replay")
        replay_s = _now() - t_c
        torn_res, torn_err = _ps_finish(torn_proc, "the run over a torn log")
        for arm in ("hybrid", "vector"):
            _ps_same_sinks(_ps_sink(os.path.join(crash, f"out.{arm}.csv")),
                           _ps_sink(os.path.join(crash, f"replay.{arm}.csv")), f"cli replay's {arm} sink")
        if "corrupt tail" not in torn_err or torn_res["rows"] != {"hybrid": n_docs_b, "vector": n_docs_b,
                                                                   "bm25": n_docs_b}:
            raise AssertionError(f"phase 21: over the torn log the indexes hold {torn_res['rows']}")
        n_records_b = _ps_no_torch(crash_store)
        log(
            f"persist (b, c) {tag}: a worker on the card (4 files of {PS_CRASH_FILE_DOCS} documents, {BATCH} "
            f"queries, hybrid and vector sinks) killed by SIGKILL {killed_at:.1f} s in, after 2 snapshot commits "
            f"with 2 files read; 2 files written while it was down; the restart's sinks == an uninterrupted "
            f"run's on {n_same} answers (ties within {PS_TOL}), {n_docs_b} documents indexed once; "
            f"`python -m pathway_tpu_torch.cli replay --record-path` over a copy of that store answered the "
            f"same in {replay_s:.1f} s; meanwhile the original's last chunk torn by 5 bytes: replay stopped at the last intact record (logged), "
            f"the log rewound, all {n_docs_b} documents indexed; {n_records_b} records unpickled, no torch class; "
            f"worker rescore launches {restarted['launches']} + {clean_res['launches']} + "
            f"{replayed_res['launches']} + {torn_res['launches']}; arms (b, c) {_now() - t_b:.1f} s"
        )

        # -- numbers ---------------------------------------------------------------------
        lat = {n: r1["latency"][n] + r2["latency"][n] for n in ("hybrid", "vector")}
        search = {n: r1["search_ms"][n] + r2["search_ms"][n] for n in ("hybrid", "vector")}
        c2 = [r[0] for r in r2["commits"]]
        b2 = [r[1] for r in r2["commits"]]
        cold, restart = r1["ingest_s"], r2["restart_s"]
        busy = r2["busy"] or "busy share not measured"
        log(
            f"persist numbers {tag}: cold ingest (run 1: read + embed + add into both indexes, run start to the "
            f"later first add) {cold:.3f} s = {N_DOCS / cold:.0f} docs/s; snapshot commits run 1 {len(c1)} "
            f"(first {b1[0]} bytes in {c1[0] * 1e3:.3f} ms, then mean {np.mean(b1[1:]):.0f} bytes in "
            f"{np.mean(c1[1:]) * 1e3:.3f} ms), run 2 {len(c2)} (first {b2[0]} bytes in {c2[0] * 1e3:.3f} ms, "
            f"then mean {np.mean(b2[1:]):.0f} bytes in {np.mean(c2[1:]) * 1e3:.3f} ms); restart (run 2: pw.run "
            f"to its first answer, replaying {N_DOCS} documents through the embedder and both adds, "
            f"{len(late)} new, and the IVF builds of the first search) {restart:.3f} s, restart / cold "
            f"{restart / cold:.2f} (run 2's ingest alone, to the later first add: {r2['ingest_s']:.3f} s); "
            f"retrieve per commit of "
            f"{BATCH} (subject commit to the last answer; both arms answer in one tick) p50 "
            f"{np.percentile(lat['hybrid'][1:], 50):.3f} ms max {max(lat['hybrid'][1:]):.3f} after the first "
            f"({lat['hybrid'][0]:.3f} ms: it holds the IVF builds); the operators' search of {BATCH} queries: "
            f"hybrid p50 {np.percentile(search['hybrid'], 50):.3f} ms, vector-only p50 "
            f"{np.percentile(search['vector'], 50):.3f} ms, the BM25 side's host ms per commit p50 "
            f"{np.percentile(r1['bm25_ms'] + r2['bm25_ms'], 50):.3f}; run 2 "
            f"{busy}; rescore launches on the persist path {r1['launches'] + r2['launches']} (run 1 "
            f"{r1['launches']}, run 2 {r2['launches']}, the checks' direct searches not counted); phase 21 "
            f"{_now() - t_phase:.1f} s"
        )
        shape = r2["shape"]
        log(f"ivf_rescore at the persist path's shape {tag}: {r2['shape_line']}")
        launches = r1["launches"] + r2["launches"]
        if launches == 0:
            raise AssertionError("phase 21: the persist path launched no rescore kernel")
        return launches, shape
    finally:
        pw.reset()
        shutil.rmtree(root, ignore_errors=True)


# -- phase 22: time on the card -----------------------------------------------------------
TM_HOUR = 3600.0
TM_PER_HOUR = 4096  # documents per simulated hour: one document commit each
TM_CUTOFF_HOURS = 3  # common_behavior(cutoff=3 h, keep_results=False): at most 4 hours alive
TM_TOPICS = 8  # (b): topic labels, document i has topic i % 8
TM_HOP = 900.0  # (b): sliding windows of an hour every 15 minutes
TM_JOIN_DOCS = 64  # (b): each query joins the documents of the span TM_JOIN_DOCS documents take
TM_GRAPH_DOCS = 1024  # (c): documents of the neighbour graph (cut from 8,192: the engine's pagerank
# takes host time per edge and step: PERF.md §4)
TM_PR_STEPS = 5
TM_COMMIT_MS = 10
TM_EXACT_TOL = 1e-4  # the IVF's f32 kernel sums in another order than the exact matmul


def _tm_doc_of(md) -> int:
    return int(getattr(md, "value", md)["doc"])


def _tm_upstream(table, stop) -> list:
    """The operators between the engine table ``stop`` and ``table``'s
    producer: the windowed chain of a windowby."""
    seen, order, todo = set(), [], [table._engine_table.producer]
    while todo:
        op = todo.pop()
        if op is None or op.id in seen:
            continue
        seen.add(op.id)
        order.append(op)
        todo.extend(t.producer for t in op.inputs if t is not stop)
    return sorted(order, key=lambda o: o.id)


def _tm_exact(vec_of_doc, alive, queries: np.ndarray, k: int, dev):
    """Exact top-``k`` over the embeddings of the ``alive`` documents, on
    ``dev``: per query [(doc, cosine), ...]."""
    docs = sorted(alive)
    mat = torch.from_numpy(np.stack([vec_of_doc[d] for d in docs])).to(dev)
    mat = mat / mat.norm(dim=1, keepdim=True).clamp_min(1e-30)
    q = torch.from_numpy(queries).to(dev)
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-30)
    s, i = torch.topk(q @ mat.t(), min(k, len(docs)), dim=1)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    return [[(docs[j], float(v)) for j, v in zip(row_i, row_s)] for row_i, row_s in zip(i, s)]


def temporal_retrieval(pw, emb, docs, times, per_hour: int, dev):
    """Phase 22 (a): a windowed ``DataIndex`` over the IVF factory at full
    probe.  Returns the report, the documents' embeddings and the IVF."""
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist

    cuda = dev.type == "cuda"
    n = len(docs)
    hours = n // per_hour
    dim = emb.get_embedding_dimension()
    driver = _FrameworkDriver("phase 22 (a)")

    class Query(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        query: str

    doc_subject, doc_q = _queue_subject(pw, "docs", driver)
    query_subject, query_q = _queue_subject(pw, "queries", driver)
    stream = pw.io.python.read(doc_subject, schema=pw.schema_from_types(doc=int, data=str, t=float),
                               atomic_batches=True, name="temporal_docs")
    queries = pw.io.python.read(query_subject, schema=Query, atomic_batches=True, name="temporal_queries")
    # each document is its own instance: its one-hour window lives until
    # the clock passes the window's end + 3 hours, then it is retracted
    alive = pw.temporal.windowby(
        stream, stream.t, window=pw.temporal.tumbling(TM_HOUR), instance=pw.this.doc,
        behavior=pw.temporal.common_behavior(cutoff=TM_CUTOFF_HOURS * TM_HOUR, keep_results=False),
    ).reduce(doc=pw.this.doc, data=pw.reducers.any(pw.this.data))
    vecs = alive.select(pw.this.doc, vec=emb(pw.this.data), meta=pw.apply(lambda d: {"doc": d}, pw.this.doc))
    mod = pw.stdlib.indexing
    index = mod.DataIndex(vecs, mod.InnerIndex(
        data_column=vecs.vec, metadata_column=vecs.meta, dimension=dim,
        factory=mod.IvfKnnFactory(dimension=dim, n_probe=1 << 30, device=None if cuda else dev),
    ))
    qs = queries.select(pw.this.qid, qvec=emb(pw.this.query))
    res = index.query_as_of_now(qs.qvec, number_of_matches=K)
    answers = res.select(qid=qs.qid, docs=vecs.doc, scores=res.score)
    pw.io.subscribe(answers, on_change=driver.on_change("answers"), on_time_end=driver.on_tick)
    chain = _tm_upstream(alive, stream._engine_table)
    (op,) = [o for o in pw.G.engine_graph.operators if isinstance(o, ExternalIndexOperator)]
    inner, ivf = op.index, op.index.index

    doc_of_key, live, vec_of_doc = {}, {}, {}
    removal = {"s": 0.0, "rows": 0, "calls": 0}
    searches = []  # (query vectors, k, rows) per search
    orig_add, orig_remove, orig_search = inner.add, inner.remove, inner.search

    def add(keys, values, metadatas):
        orig_add(keys, values, metadatas)
        with driver.cond:
            for key, value, md in zip(keys, values, metadatas):
                doc = _tm_doc_of(md)
                doc_of_key[int(key)] = live[int(key)] = doc
                vec_of_doc[doc] = np.asarray(value, np.float32)
            driver.cond.notify_all()

    def remove(keys):
        t0 = _now()
        orig_remove(keys)
        spent = _now() - t0
        with driver.cond:
            removal["s"] += spent
            removal["rows"] += len(keys)
            removal["calls"] += 1
            for key in keys:
                live.pop(int(key), None)
            driver.cond.notify_all()

    def search(values, k, filters):
        out = orig_search(values, k, filters)
        searches.append((np.stack([np.asarray(v, np.float32) for v in values]), k, out))
        return out

    inner.add, inner.remove, inner.search = add, remove, search
    qidx = query_ids()
    report = {"latency_ms": [], "alive": [], "index_rows": [], "searches_of": []}

    def drive():
        for c in range(hours):
            lo = c * per_hour
            doc_q.put([{"doc": i, "data": docs[i], "t": times[i]} for i in range(lo, lo + per_hour)])
            want = set(range(max(0, c - TM_CUTOFF_HOURS) * per_hour, (c + 1) * per_hour))
            driver.wait(lambda: len(driver.commit_at.get("docs", ())) > c and set(live.values()) == want,
                        f"document commit {c} and its retractions")
            report["alive"].append(want)
            report["index_rows"].append(len(ivf))
            n_before = len(searches)
            query_q.put([{"qid": c * BATCH + b, "query": docs[qidx[c * BATCH + b] % n]} for b in range(BATCH)])
            driver.wait(lambda: len(driver.answers.get("answers", {})) >= (c + 1) * BATCH
                        and len(driver.commit_at.get("queries", ())) > c, f"query commit {c}")
            last = max(t for t, _k, _d in driver.arrival["answers"])
            report["latency_ms"].append((last - driver.commit_at["queries"][c]) * 1e3)
            report["searches_of"].append(list(range(n_before, len(searches))))

    def run_driver():
        try:
            drive()
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread after the run
            report["error"] = exc
        finally:
            for q in (doc_q, query_q):
                q.put(None)

    rescore_shortlist.launches = 0
    thread = threading.Thread(target=run_driver, daemon=True, name="phase22-driver")
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        t_run = _now()
        thread.start()
        try:
            pw.run(commit_duration_ms=TM_COMMIT_MS)
        finally:
            driver.stop = True
            thread.join(timeout=60)
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (_now() - t_run) * 1e3
    report["launches"] = rescore_shortlist.launches
    if "error" in report:
        raise report["error"]

    # -- checks --------------------------------------------------------------
    bad_rank = late = 0
    for c, (want, rows_in) in enumerate(zip(report["alive"], report["index_rows"])):
        if rows_in != len(want):
            raise AssertionError(f"phase 22 (a): after commit {c} the index holds {rows_in} rows, "
                                 f"{len(want)} documents are alive")
        if len(report["searches_of"][c]) != 1:
            raise AssertionError(f"phase 22 (a): query commit {c} searched {len(report['searches_of'][c])} times")
        qv, k, rows = searches[report["searches_of"][c][0]]
        exact = _tm_exact(vec_of_doc, want, qv, k, dev)
        got_docs = []
        for got, ref in zip(rows, exact):
            got = [(doc_of_key[int(key)], float(score)) for key, score in got]
            got_docs.append(tuple(doc for doc, _s in got))
            late += sum(1 for doc, _s in got if doc not in want)
            bad_rank += not same_ranking(ref, got, tie=1e-5, atol=TM_EXACT_TOL)
        answered = sorted(
            tuple(int(d) for d in ev[-1][1]["docs"])
            for ev in driver.answers["answers"].values() if ev[-1][1]["qid"] // BATCH == c
        )
        if answered != sorted(got_docs):
            raise AssertionError(f"phase 22 (a): commit {c}'s answers differ from its index's search")
    retracted = sum(1 for evs in driver.answers["answers"].values() for e in evs if e[2] < 0)
    if bad_rank or late or retracted:
        raise AssertionError(f"phase 22 (a): {bad_rank} answers differ from the exact search over the alive "
                             f"documents, {late} hold a document past the cutoff, {retracted} retracted")
    if cuda and (report["launches"] == 0 or ivf._slabs.device.type != "cuda"):
        raise AssertionError("phase 22 (a): the windowed IVF launched no rescore kernel on the card")
    report.update(wall_ms=wall_ms, removal=removal, chain=chain, stats=dict(ivf.stats),
                  busy=device_busy(prof, wall_ms) if cuda else "busy share not measured (CPU)",
                  queries=searches[report["searches_of"][-1][0]][0])
    return report, vec_of_doc, ivf


def temporal_joins(pw, times, per_hour: int):
    """Phase 22 (b): sliding-window counts per topic, an asof join of
    timestamped queries onto them and an interval join of each query with
    the documents of its last ``TM_JOIN_DOCS`` documents' span, held
    against a plain Python loop.  Returns the report."""
    import bisect

    n = len(times)
    hours = n // per_hour
    span = TM_JOIN_DOCS * TM_HOUR / per_hour
    driver = _FrameworkDriver("phase 22 (b)")

    class TimedQuery(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        t: float
        topic: str

    doc_subject, doc_q = _queue_subject(pw, "docs", driver)
    query_subject, query_q = _queue_subject(pw, "queries", driver)
    docs = pw.io.python.read(doc_subject, schema=pw.schema_from_types(doc=int, t=float, topic=str),
                             atomic_batches=True, name="temporal_join_docs")
    queries = pw.io.python.read(query_subject, schema=TimedQuery, atomic_batches=True, name="temporal_join_queries")
    counts = pw.temporal.windowby(
        docs, docs.t, window=pw.temporal.sliding(hop=TM_HOP, duration=TM_HOUR), instance=pw.this.topic
    ).reduce(topic=pw.this.topic, end=pw.this._pw_window_end, n=pw.reducers.count())
    latest = pw.temporal.asof_join(
        queries, counts, queries.t, counts.end, queries.topic == counts.topic
    ).select(qid=queries.qid, end=counts.end, n=counts.n)
    pairs = pw.temporal.interval_join(
        queries, docs, queries.t, docs.t, pw.temporal.interval(-span, 0.0)
    ).select(qid=queries.qid, doc=docs.doc)
    pw.io.subscribe(latest, on_change=driver.on_change("latest"), on_time_end=driver.on_tick)
    q_rows = []
    step = TM_HOUR / BATCH
    report = {"commit_ms": []}

    def drive():
        for c in range(hours):
            lo = c * per_hour
            doc_q.put([{"doc": i, "t": times[i], "topic": f"topic{i % TM_TOPICS}"} for i in range(lo, lo + per_hour)])
            driver.wait(lambda: len(driver.commit_at.get("docs", ())) > c, f"document commit {c}")
            batch = [{"qid": c * BATCH + j, "t": c * TM_HOUR + (j + 0.5) * step, "topic": f"topic{j % TM_TOPICS}"}
                     for j in range(BATCH)]
            q_rows.extend(batch)
            query_q.put(batch)
            driver.wait(lambda: len(driver.answers.get("latest", {})) >= (c + 1) * BATCH, f"query commit {c}")
            report["commit_ms"].append((max(t for t, _k, _d in driver.arrival["latest"])
                                        - driver.commit_at["docs"][c]) * 1e3)

    def run_driver():
        try:
            drive()
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread after the run
            report["error"] = exc
        finally:
            for q in (doc_q, query_q):
                q.put(None)

    thread = threading.Thread(target=run_driver, daemon=True, name="phase22b-driver")
    t_run = _now()
    thread.start()
    try:
        pw.run(commit_duration_ms=TM_COMMIT_MS)
    finally:
        driver.stop = True
        thread.join(timeout=60)
    wall_s = _now() - t_run
    if "error" in report:
        raise report["error"]

    # -- the plain Python loop over the same rows ------------------------------
    by_topic = {}
    for i, t in enumerate(times):
        by_topic.setdefault(f"topic{i % TM_TOPICS}", []).append(t)
    want_latest, want_pairs = {}, set()
    for q in q_rows:
        ts = by_topic[q["topic"]]
        end = float(np.floor(q["t"] / TM_HOP) * TM_HOP)
        while True:  # the latest sliding window ending at or before the query that holds a document
            cnt = bisect.bisect_left(ts, end) - bisect.bisect_left(ts, end - TM_HOUR)
            if cnt or end - TM_HOUR < ts[0]:
                break
            end -= TM_HOP
        want_latest[q["qid"]] = (end, cnt) if cnt else (None, None)
        lo_i, hi_i = bisect.bisect_left(times, q["t"] - span), bisect.bisect_right(times, q["t"])
        want_pairs.update((q["qid"], i) for i in range(lo_i, hi_i))
    _k, cols = latest._materialize()
    got_latest = {int(qid): (None if e is None else float(e), None if c_ is None else int(c_))
                  for qid, e, c_ in zip(cols["qid"], cols["end"], cols["n"])}
    _k, cols = pairs._materialize()
    got_pairs = {(int(q), int(d)) for q, d in zip(cols["qid"], cols["doc"])}
    if got_latest != want_latest or got_pairs != want_pairs:
        bad = sum(1 for q in want_latest if got_latest.get(q) != want_latest[q])
        raise AssertionError(f"phase 22 (b): {bad} asof answers and {len(got_pairs ^ want_pairs)} interval pairs "
                             "differ from the plain loop")
    report.update(wall_s=wall_s, host_s=sum(o.process_ns for o in pw.G.engine_graph.operators) / 1e9,
                  commits=2 * hours, queries=len(q_rows), pairs=len(want_pairs),
                  pairs_per_query=len(want_pairs) / len(q_rows), span=span, windows=len(counts._materialize()[0]))
    return report


def temporal_graphs(pw, vec_of_doc, times, n_graph: int, dev):
    """Phase 22 (c): the top-10 neighbour graph of ``n_graph`` documents
    from an IVF on ``dev`` at full probe; ``pw.graphs.pagerank`` against a
    float64 numpy power iteration, ``bellman_ford`` against scipy's
    shortest paths, ``retrieve_prev_next_values`` over the documents sorted
    by time against numpy.  Returns the report."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist

    out = {}
    t0 = _now()
    launches0 = rescore_shortlist.launches
    vecs = np.stack([vec_of_doc[d] for d in range(n_graph)])
    ivf = IvfKnnIndex(vecs.shape[1], metric="cos", device=dev)
    ivf.add(list(range(n_graph)), vecs)
    ivf.build()
    full = ivf._centroids.shape[0]
    edges = []
    for lo in range(0, n_graph, 512):
        for i, row in enumerate(ivf.search(vecs[lo : lo + 512], K + 1, n_probe=full)):
            edges.extend([(lo + i, int(key), float(score)) for key, score in row if int(key) != lo + i][:K])
    if len(edges) != K * n_graph:
        raise AssertionError(f"phase 22 (c): {len(edges)} edges for {n_graph} documents")
    out.update(knn_s=_now() - t0, launches=rescore_shortlist.launches - launches0, edges=len(edges), clusters=full)
    a_idx = np.array([e[0] for e in edges])
    b_idx = np.array([e[1] for e in edges])
    w = np.array([e[2] for e in edges], np.float64)
    if float((1.0 - w).min()) <= 0.0:
        raise AssertionError("phase 22 (c): a neighbour at cosine 1 (a zero-length edge)")

    def graph_tables():
        vs = pw.debug.table_from_rows(
            pw.schema_from_types(doc=int, is_source=bool), [(i, i == 0) for i in range(n_graph)]
        ).with_id_from(pw.this.doc)
        raw = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int, w=float), edges)
        return vs, raw.select(u=vs.pointer_from(raw.a), v=vs.pointer_from(raw.b), dist=1.0 - raw.w)

    def by_doc(vs, table, column):
        keys, cols = vs._materialize()
        doc_of = {int(k): int(d) for k, d in zip(keys, cols["doc"])}
        keys, cols = table._materialize()
        got = np.full(n_graph, np.nan)
        got[[doc_of[int(k)] for k in keys]] = cols[column].astype(np.float64)
        return got

    # pagerank: 5 unrolled steps against a float64 power iteration of the same formula
    pw.reset()
    t0 = _now()
    vs, etab = graph_tables()
    ranks = pw.graphs.pagerank(etab, steps=TM_PR_STEPS)
    pw.run(monitoring_level=None)
    out["pagerank_s"] = _now() - t0
    got = by_doc(vs, ranks, "rank")
    outdeg = np.bincount(a_idx, minlength=n_graph).astype(np.float64)
    r = np.ones(n_graph)
    for _ in range(TM_PR_STEPS):
        inflow = np.zeros(n_graph)
        np.add.at(inflow, b_idx, 0.85 * r[a_idx] / outdeg[a_idx])
        r = 0.15 + inflow
    out["pagerank_err"] = float(np.nanmax(np.abs(got - r)))
    if np.isnan(got).any() or out["pagerank_err"] > 1e-9:
        raise AssertionError(f"phase 22 (c): pagerank differs from the power iteration by {out['pagerank_err']}")

    # Bellman-Ford from document 0 with weights 1 - score, against scipy
    pw.reset()
    t0 = _now()
    vs, etab = graph_tables()
    dists = pw.graphs.bellman_ford(vs, etab)
    pw.run(monitoring_level=None)
    out["bellman_ford_s"] = _now() - t0
    got = by_doc(vs, dists, "dist_from_source")
    want = shortest_path(csr_matrix((1.0 - w, (a_idx, b_idx)), shape=(n_graph, n_graph)), method="D",
                         directed=True, indices=0)
    fin = np.isfinite(want)
    out["bf_reached"] = int(fin.sum())
    out["bf_err"] = float(np.abs(got[fin] - want[fin]).max())
    if np.isnan(got).any() or not np.array_equal(np.isfinite(got), fin) or out["bf_err"] > 1e-9:
        raise AssertionError(f"phase 22 (c): bellman_ford differs from scipy (max err {out['bf_err']})")

    # prev / next values over the documents sorted by time, one in 16 holding a value
    pw.reset()
    t0 = _now()
    base = pw.debug.table_from_rows(
        pw.schema_from_types(doc=int, t=float, v=object),
        [(i, float(times[i]), i if i % 16 == 0 else None) for i in range(n_graph)],
    )
    ordered = base.sort(key=base.t)
    walked = pw.stdlib.indexing.sorting.retrieve_prev_next_values(
        base.select(prev=ordered.prev, next=ordered.next, value=base.v)
    )
    pw.run(monitoring_level=None)
    out["prev_next_s"] = _now() - t0
    bkeys, bcols = base._materialize()
    key_of = {int(d): int(k) for k, d in zip(bkeys, bcols["doc"])}
    order = np.argsort(np.asarray(times[:n_graph]), kind="stable")
    has = order % 16 == 0
    pos = np.arange(n_graph)
    prev_pos = np.maximum.accumulate(np.where(has, pos, -1))
    next_pos = np.minimum.accumulate(np.where(has, pos, n_graph)[::-1])[::-1]
    want_pn = {
        key_of[int(order[j])]: (
            key_of[int(order[prev_pos[j]])] if prev_pos[j] >= 0 else None,
            key_of[int(order[next_pos[j]])] if next_pos[j] < n_graph else None,
        )
        for j in range(n_graph)
    }
    wkeys, wcols = walked._materialize()
    got_pn = {
        int(k): (None if p is None else int(p), None if q is None else int(q))
        for k, p, q in zip(wkeys, wcols["prev_value"], wcols["next_value"])
    }
    if got_pn != want_pn:
        raise AssertionError(f"phase 22 (c): {sum(got_pn.get(k) != v for k, v in want_pn.items())} prev / next "
                             "values differ from numpy")
    return out


def temporal_phase(tag: str, dev=None, emb=None, docs=None, per_hour: int = TM_PER_HOUR,
                   n_graph: int = TM_GRAPH_DOCS):
    """Phase 22: time on the card, all through ``import pathway_tpu_torch
    as pw``: (a) a windowed retrieval index, (b) temporal joins over the
    same streams, (c) ``pw.iterate`` and the graphs over the card's
    neighbour graph.  Returns (rescore launches on the temporal path, the
    kernel at the phase's shape)."""
    import pathway_tpu_torch as pw

    t_phase = _now()
    dev = dev or torch.device(DEVICE)
    cuda = dev.type == "cuda"
    pw.reset()
    if cuda:
        torch.cuda.empty_cache()
    docs = docs if docs is not None else corpus(N_DOCS)
    emb = emb or _ps_embedder()
    times = [i * TM_HOUR / per_hour for i in range(len(docs))]
    hours = len(docs) // per_hour
    n_graph = min(n_graph, len(docs))

    # -- (a) windowed retrieval ------------------------------------------------
    t0 = _now()
    ra, vec_of_doc, ivf = temporal_retrieval(pw, emb, docs, times, per_hour, dev)
    lat = ra["latency_ms"]
    by_name = {}
    for o in ra["chain"]:
        by_name[o.name] = by_name.get(o.name, 0) + o.process_ns / 1e6
    dead = int(torch.isneginf(ivf._bias).sum()) if ivf._bias is not None else 0  # removed rows and pad
    log(
        f"temporal (a) {tag}: {len(docs)} documents at {per_hour} per simulated hour in {hours} commits through "
        f"windowby(tumbling 1 h, instance=doc, cutoff 3 h, keep_results=False) into a full-probe IVF DataIndex, "
        f"{BATCH} queries (k={K}) after each commit: the index held the alive count after every commit "
        f"({max(ra['index_rows'])} at most), every answer == an exact search over the alive documents' embeddings "
        f"on the card rank by rank (ties within 1e-5), none past the cutoff, none retracted; retrieve per query "
        f"commit first {lat[0]:.3f} ms (the IVF's first build), then p50 {np.percentile(lat[1:], 50):.3f} ms "
        f"p99 {np.percentile(lat[1:], 99):.3f} ms over {len(lat) - 1}; the windowed chain's host ms per document "
        f"commit {sum(by_name.values()) / hours:.3f} ("
        + ", ".join(f"{k} {v / hours:.3f}" for k, v in sorted(by_name.items()))
        + f"); index removals {ra['removal']['s'] * 1e3 / hours:.3f} ms per commit ({ra['removal']['rows']} rows in "
        f"{ra['removal']['calls']} calls); IVF retrains {ra['stats'].get('retrains', 0)}, absorbs "
        f"{ra['stats'].get('absorbs', 0)}, builds {ra['stats'].get('sync_builds', 0)}; -inf bias slots (removed rows "
        f"and pad) at the end {dead} of {0 if ivf._bias is None else ivf._bias.numel()} slots ({len(ivf)} live); {ra['busy']}; "
        f"rescore launches {ra['launches']}; (a) {_now() - t0:.1f} s"
    )
    shape = None
    if cuda:
        shape = rescore_at_path_shape(ivf, ivf_search_rescore_args(ivf, ra["queries"]), dev)
        log(f"ivf_rescore at the temporal shape {tag}: " + rescore_line(ivf, shape)
            + f"; {dead} -inf bias slots (removed rows and pad) in the slabs; launches in (a) {ra['launches']}")

    # -- (b) temporal joins over the same streams (host) ------------------------
    pw.reset()
    rb = temporal_joins(pw, times, per_hour)
    log(
        f"temporal (b) {tag}: windowby(sliding hop 15 min, 1 h, instance=topic) counts ({rb['windows']} windows of "
        f"{TM_TOPICS} topics), asof_join of {rb['queries']} timestamped queries onto their topic's latest window, "
        f"interval_join of each with the documents of its last {rb['span']:.2f} s ({rb['pairs_per_query']:.2f} "
        f"documents per query, {rb['pairs']} pairs) == a plain Python loop; document commit to the last asof "
        f"answer of its query commit p50 {np.percentile(rb['commit_ms'], 50):.3f} ms max {max(rb['commit_ms']):.3f} "
        f"ms; operators' host {rb['host_s'] * 1e3 / rb['commits']:.3f} ms per commit over {rb['commits']} commits; "
        f"(b) {rb['wall_s']:.1f} s"
    )

    # -- (c) pw.iterate and the graphs over the card's neighbour graph ----------
    pw.reset()
    rc = temporal_graphs(pw, vec_of_doc, times, n_graph, dev)
    log(
        f"temporal (c) {tag}: top-{K} neighbour graph of {n_graph} documents from the IVF on the card at full probe "
        f"(C={rc['clusters']}, {rc['launches']} rescore launches) {rc['knn_s']:.3f} s; pagerank {TM_PR_STEPS} steps "
        f"over {rc['edges']} edges {rc['pagerank_s']:.3f} s, max err {rc['pagerank_err']:.3e} against float64 numpy; "
        f"bellman_ford (weights 1 - score) {rc['bellman_ford_s']:.3f} s, {rc['bf_reached']} reached, max err "
        f"{rc['bf_err']:.3e} against scipy; retrieve_prev_next_values over the documents sorted by time "
        f"{rc['prev_next_s']:.3f} s == numpy; phase 22 {_now() - t_phase:.1f} s"
    )
    pw.reset()
    return ra["launches"] + rc["launches"], shape


# -- phase 23: the rest of the host API over an async retrieval path -----------------
HA_COMMITS = 16  # (a): query commits of BATCH through pw.io.python
HA_COMMIT_MS = 10  # the engine's commit tick while the phase runs
HA_TOL = PS_TOL  # bf16 trunk: a query's row moves with the batch the scheduler packs it in
HA_MIN_SCORE = 0.85  # (b): the SQL's WHERE on score
HA_TOP = 16  # (b): ORDER BY n DESC, doc LIMIT HA_TOP
HA_WAIT_S = 300.0


def _ha_hits(pw, answers):
    """The answers table (qid, docs, scores) flattened to one row per hit:
    (qid, qptr = the answer row's id, doc, score)."""
    pairs = answers.select(
        qid=pw.this.qid, qptr=answers.id, hit=pw.apply(lambda d, s: tuple(zip(d, s)), pw.this.docs, pw.this.scores)
    )
    flat = pairs.flatten(pairs.hit)
    return flat.select(
        qid=pw.this.qid, qptr=pw.this.qptr, doc=pw.apply_with_type(lambda h: int(h[0]), int, pw.this.hit),
        score=pw.apply_with_type(lambda h: float(h[1]), float, pw.this.hit),
    )


def _ha_sql(pw, hits):
    """(b)'s two queries: the documents hit above ``HA_MIN_SCORE`` with
    their counts and best scores, and the ``HA_TOP`` most hit of them."""
    grouped = pw.sql(
        f"SELECT doc, COUNT(*) AS n, MAX(score) AS best FROM hits WHERE score > {HA_MIN_SCORE} GROUP BY doc",
        hits=hits,
    )
    top = pw.sql(f"SELECT doc, n, best FROM g ORDER BY n DESC, doc ASC LIMIT {HA_TOP}", g=grouped)
    return grouped, top


def _ha_plain_sql(answers: dict):
    """The same two queries as a plain Python count over
    ``{qid: [(doc, score), ...]}``."""
    count, best = {}, {}
    for row in answers.values():
        for doc, score in row:
            if score > HA_MIN_SCORE:
                count[doc] = count.get(doc, 0) + 1
                best[doc] = max(best.get(doc, score), score)
    grouped = sorted((doc, count[doc], best[doc]) for doc in count)
    return grouped, sorted(grouped, key=lambda r: (-r[1], r[0]))[:HA_TOP]


def _ha_sql_rows(table) -> list:
    _keys, cols = table._materialize()
    return sorted((int(d), int(n), float(b)) for d, n, b in zip(cols["doc"], cols["n"], cols["best"]))


def _ha_answers(table) -> dict:
    """``{qid: [(doc, score), ...]}`` of an answers table."""
    _keys, cols = table._materialize()
    return {
        int(q): [(int(d), float(s)) for d, s in zip(ds, ss)]
        for q, ds, ss in zip(cols["qid"], cols["docs"], cols["scores"])
    }


def _ha_chase(pw, answers, hit_table):
    """A row transformer over the hits: each hit chases its ``qptr`` to its
    query's answer row for the query id and its rank there."""

    @pw.transformer
    class chase:
        class queries(pw.ClassArg):
            qid = pw.input_attribute()
            docs = pw.input_attribute()

        class hits(pw.ClassArg):
            qptr = pw.input_attribute()
            doc = pw.input_attribute()

            @pw.output_attribute
            def query(self):
                return self.transformer.queries[self.qptr].qid

            @pw.output_attribute
            def rank(self):
                return list(self.transformer.queries[self.qptr].docs).index(self.doc)

    return chase(queries=answers, hits=hit_table).hits


def _ha_timed_tick_ends(ops, book: dict) -> None:
    """Add each operator's ``on_tick_end`` seconds to ``book["ns"]`` (the
    row transformer works there; ``process_ns`` counts ``process`` only)."""
    for op in ops:
        inner = op.on_tick_end

        def on_tick_end(ts, _inner=inner):
            t0 = time.perf_counter_ns()
            try:
                return _inner(ts)
            finally:
                book["ns"] += time.perf_counter_ns() - t0

        op.on_tick_end = on_tick_end


def hostapi_retrieval(pw, emb, docs, dev, commits: int = HA_COMMITS):
    """Phase 23 (a) and (b): the async retrieval path and the host API over
    its answers.  Returns the report (the IVF, the scheduler's stats, the
    checks' inputs, timings)."""
    import concurrent.futures

    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.serve import ServeScheduler

    cuda = dev.type == "cuda"
    n = len(docs)
    encoder = emb._encoder
    t0 = _now()
    with torch.no_grad():
        mat = torch.cat([encoder.encode_to_device(docs[i : i + ENCODE_CHUNK]) for i in range(0, n, ENCODE_CHUNK)])
    ivf = IvfKnnIndex(mat.shape[1], metric="cos", device=dev)
    ivf.build_from_matrix(list(range(n)), mat)
    ivf.n_probe = ivf._centroids.shape[0]
    del mat
    if cuda:
        torch.cuda.synchronize()
    setup_s = _now() - t0
    fused = FusedEncodeSearch(encoder, ivf, k=K)
    sched = ServeScheduler(fused, name="hostapi", result_cache=None)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=BATCH, thread_name_prefix="hostapi-wait")
    qidx = query_ids()
    texts = [docs[qidx[i] % n] for i in range(commits * BATCH)]
    driver = _FrameworkDriver("phase 23")

    class Query(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        query: str

    class Answer(pw.Schema):
        qid: int
        docs: tuple
        scores: tuple

    class Retrieve(pw.AsyncTransformer):
        output_schema = Answer

        async def invoke(self, qid, query):
            import asyncio

            ticket = sched.submit([query])
            result = await asyncio.get_running_loop().run_in_executor(pool, ticket.result, HA_WAIT_S)
            (row,) = result
            return {"qid": qid, "docs": tuple(int(k) for k, _s in row), "scores": tuple(float(s) for _k, s in row)}

    subject, query_q = _queue_subject(pw, "queries", driver)
    queries = pw.io.python.read(subject, schema=Query, atomic_batches=True, name="hostapi_queries")
    answers = Retrieve(input_table=queries).successful
    pw.io.subscribe(answers, on_change=driver.on_change("answers"), on_time_end=driver.on_tick)
    first_b = len(pw.G.engine_graph.operators)
    hits = _ha_hits(pw, answers)
    grouped, top = _ha_sql(pw, hits)
    chased = _ha_chase(pw, answers, hits)
    handle = pw.export_table(answers)
    b_ops = pw.G.engine_graph.operators[first_b:]
    tick_ends = {"ns": 0}
    _ha_timed_tick_ends(b_ops, tick_ends)
    report = {"latency_ms": []}

    def drive():
        for c in range(commits):
            query_q.put([{"qid": c * BATCH + b, "query": texts[c * BATCH + b]} for b in range(BATCH)])
            driver.wait(lambda: len(driver.answers.get("answers", {})) >= (c + 1) * BATCH
                        and len(driver.commit_at.get("queries", ())) > c, f"the answers of query commit {c}")
            last = max(t for t, _k, _d in driver.arrival["answers"])
            report["latency_ms"].append((last - driver.commit_at["queries"][c]) * 1e3)

    def run_driver():
        try:
            drive()
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread after the run
            report["error"] = exc
        finally:
            query_q.put(None)

    rescore_shortlist.launches = 0
    thread = threading.Thread(target=run_driver, daemon=True, name="phase23-driver")
    try:
        with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
            t_run = _now()
            thread.start()
            try:
                pw.run(commit_duration_ms=HA_COMMIT_MS)
            finally:
                driver.stop = True
                thread.join(timeout=60)
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (_now() - t_run) * 1e3
        report["launches"] = rescore_shortlist.launches
        if "error" in report:
            raise report["error"]
        first_commit = driver.commit_at["queries"][0]
        last_answer = max(t for t, _k, _d in driver.arrival["answers"])
        report.update(
            answers_per_s=commits * BATCH / (last_answer - first_commit), wall_ms=wall_ms,
            busy=device_busy(prof, wall_ms) if cuda else "busy share not measured (CPU)", setup_s=setup_s,
            sched=dict(sched.stats), b_host_ms=(sum(op.process_ns for op in b_ops) + tick_ends["ns"]) / 1e6,
            n_clusters=int(ivf._centroids.shape[0]),
        )

        # -- (a) checks: every row arrived, each == a direct search of its query --------
        got = _ha_answers(answers)
        if sorted(got) != list(range(commits * BATCH)):
            raise AssertionError(f"phase 23 (a): {len(got)} of {commits * BATCH} answers arrived")
        retracted = sum(1 for evs in driver.answers["answers"].values() for e in evs if e[2] < 0)
        bad = []
        for c in range(commits):
            direct = fused(texts[c * BATCH : (c + 1) * BATCH])
            for b, want in enumerate(direct):
                qid = c * BATCH + b
                if not same_ranking([(int(k), float(s)) for k, s in want], got[qid], tie=HA_TOL, atol=HA_TOL):
                    bad.append(qid)
        if bad or retracted:
            raise AssertionError(f"phase 23 (a): {len(bad)} answers differ from a direct search (first qids "
                                 f"{bad[:5]}), {retracted} retracted")
        if cuda and report["launches"] == 0:
            raise AssertionError("phase 23 (a): the async retrieval path launched no rescore kernel")

        # -- (b) checks: pw.sql and the transformer == plain loops ------------------------
        want_grouped, want_top = _ha_plain_sql(got)
        got_grouped, got_top = _ha_sql_rows(grouped), _ha_sql_rows(top)
        if got_grouped != want_grouped or got_top != sorted(want_top):
            raise AssertionError(f"phase 23 (b): pw.sql gave {len(got_grouped)} groups / top {got_top[:3]}, a plain "
                                 f"count {len(want_grouped)} / {want_top[:3]}")
        _keys, hcols = hits._materialize()
        hit_of = {int(k): (int(q), int(d)) for k, q, d in zip(_keys, hcols["qid"], hcols["doc"])}
        ckeys, ccols = chased._materialize()
        chased_of = {int(k): (int(q), int(r)) for k, q, r in zip(ckeys, ccols["query"], ccols["rank"])}
        want_chase = {key: (q, [doc for doc, _s in got[q]].index(d)) for key, (q, d) in hit_of.items()}
        if chased_of != want_chase or len(hit_of) != sum(len(r) for r in got.values()):
            raise AssertionError(f"phase 23 (b): the transformer gave {len(chased_of)} rows, a plain loop "
                                 f"{len(want_chase)}; {sum(1 for k in want_chase if chased_of.get(k) != want_chase[k])} "
                                 "differ")
        scores = np.array([s for row in got.values() for _d, s in row])
        report.update(groups=len(got_grouped), hits=len(hit_of), top=got_top, passed=int((scores > HA_MIN_SCORE).sum()),
                      score_q=np.percentile(scores, [10, 50, 90]))

        # -- (b) export / import into a fresh graph, the same pw.sql -----------------------
        snapshot = {int(row[0]): [(int(d), float(s)) for d, s in zip(row[1], row[2])] for _k, row in handle.snapshot()}
        if snapshot != got:
            raise AssertionError("phase 23 (b): the exported snapshot differs from the answers")
        pw.reset()
        t_imp = _now()
        imported = pw.import_table(handle)
        g2, top2 = _ha_sql(pw, _ha_hits(pw, imported))
        pw.run(commit_duration_ms=HA_COMMIT_MS)
        report["import_s"] = _now() - t_imp
        if _ha_sql_rows(g2) != want_grouped or _ha_sql_rows(top2) != sorted(want_top):
            raise AssertionError("phase 23 (b): pw.sql over the imported answers differs from the exported snapshot's "
                                 "plain count")
    finally:
        sched.stop()
        pool.shutdown(wait=True)
    report.update(ivf=ivf, texts=texts, encoder=encoder)
    return report


def hostapi_phase(tag: str, dev=None, emb=None, docs=None, commits: int = HA_COMMITS):
    """Phase 23: the rest of the framework's host API over an async
    retrieval path, all through ``import pathway_tpu_torch as pw``.
    Returns (rescore launches on the host-API path, the kernel at the
    phase's shape)."""
    import pathway_tpu_torch as pw

    t_phase = _now()
    dev = dev or torch.device(DEVICE)
    cuda = dev.type == "cuda"
    pw.reset()
    if cuda:
        torch.cuda.empty_cache()
    docs = docs if docs is not None else corpus(N_DOCS)
    emb = emb or _ps_embedder()
    r = hostapi_retrieval(pw, emb, docs, dev, commits)
    lat, st = r["latency_ms"], r["sched"]
    batches = max(st["batches"], 1)
    log(
        f"hostapi (a) {tag}: {len(docs)} documents encoded into a full-probe IVF (C={r['n_clusters']}) in "
        f"{r['setup_s']:.3f} s; {commits * BATCH} queries in {commits} commits of {BATCH} through pw.io.python into "
        f"a pw.AsyncTransformer whose invoke submits to a ServeScheduler over FusedEncodeSearch: every answer arrived "
        f"and the run returned, every answer == a direct search of its query (keys up to ties, scores within "
        f"{HA_TOL}); {r['answers_per_s']:.1f} answers/s; commit to the last answer p50 "
        f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms over {len(lat)} (the first commit "
        f"{lat[0]:.3f} ms; the rest p50 {np.percentile(lat[1:], 50):.3f} p99 {np.percentile(lat[1:], 99):.3f} ms); "
        f"scheduler {st['batches']} batches, "
        f"{st['items'] / batches:.2f} items and {st['items_dispatched'] / batches:.2f} unique per batch, "
        f"{st.get('solo', 0)} solo; {r['busy']}; rescore launches {r['launches']}"
    )
    log(
        f"hostapi (b) {tag}: over the {r['hits']} hits in the same run (scores p10 / p50 / p90 "
        + " / ".join(f"{q:.4f}" for q in r["score_q"])
        + f"), pw.sql (WHERE score > {HA_MIN_SCORE}: {r['passed']} hits; GROUP BY "
        f"doc with COUNT(*) and MAX(score): {r['groups']} documents; ORDER BY n DESC, doc LIMIT {HA_TOP}: top "
        f"{r['top'][:1]}) == a plain count, a pw.transformer chasing each hit to its query's row == a plain loop; "
        f"host {r['b_host_ms'] / commits:.3f} ms per commit (the operators' process and tick ends); export_table, "
        f"then import_table in a fresh graph and the same pw.sql == the snapshot's plain count in "
        f"{r['import_s']:.3f} s"
    )
    shape = None
    if cuda:
        ivf = r["ivf"]
        b = max(1, min(BATCH, round(st["items_dispatched"] / batches)))
        qv = np.asarray(r["encoder"].encode(r["texts"][:b]), dtype=np.float32)
        shape = rescore_at_path_shape(ivf, ivf_search_rescore_args(ivf, qv), dev)
        log(f"ivf_rescore at the hostapi shape {tag}: " + rescore_line(ivf, shape)
            + f"; launches in (a) {r['launches']}")
    log(f"hostapi {tag}: rescore launches {r['launches']}; phase 23 {_now() - t_phase:.1f} s")
    pw.reset()
    return r["launches"], shape


# -- phase 24: the multi-process engine -------------------------------------------
CL_RANKS = 2  # ranks of `cli spawn --processes 2`, sharing the one card
CL_FILES = 16  # JSON-lines files of the documents, split over the ranks by crc32(name) % 2
CL_LOCAL_SHARDS = 4  # logical data shards per rank of the mesh index: 8 in all
CL_COMMITS = 4  # query commits of BATCH through the REST front
CL_COMMIT_MS = 10  # the engine's commit tick
CL_TIMEOUT_S = 300.0  # a cluster arm past this is killed and the phase fails
CL_TOL = 2e-2  # bf16 trunk: a row moves with the packed batch it is embedded in (phase 19's rule)
CL_HB_S = 0.2  # the kill arm's exchange heartbeat and its timeout
CL_HB_TIMEOUT_S = 2.0
CL_KILL_FILES = 4  # the kill arm's csv files of CL_KILL_ROWS words
CL_KILL_ROWS = 256
CL_ROUTE = "/v1/retrieve"


def _cl_embedder(dev):
    """Phase 19's ``TpuEmbedder`` on the card; a small f32 one on the CPU
    (a debug run of the phase)."""
    from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder

    if dev.type == "cuda":
        return _ps_embedder()
    return TpuEmbedder(dimension=64, n_layers=1, n_heads=4, max_length=64, vocab_size=32768, seed=SEED,
                       dtype=torch.float32, device="cpu")


def _cl_answer(query, ivf_ids, ivf_scores, mesh_ids, mesh_scores) -> dict:
    return {"query": query, "ivf": [[int(i) for i in ivf_ids], [float(s) for s in ivf_scores]],
            "mesh": [[int(i) for i in mesh_ids], [float(s) for s in mesh_scores]]}


def _cl_tensors_on(index, dev_type: str) -> list:
    """Names of ``index``'s tensors (blocks of a mesh included) not on
    ``dev_type``."""
    off = []
    for name, v in vars(index).items():
        items = v if isinstance(v, (list, tuple)) else [v]
        for t in items:
            if isinstance(t, torch.Tensor) and t.device.type != dev_type:
                off.append(name)
    return sorted(set(off))


def _cl_timed_plane():
    """Wrap the exchange plane's collectives and close with host timers:
    ms and calls per collective, the tick rounds, and the plane's
    ``pathway_exchange_*`` samples taken just before it closes."""
    from pathway_tpu_torch.parallel.exchange import ExchangePlane

    book = {"ms": 0.0, "calls": 0, "rounds": 0, "samples": []}
    for name in ("all_to_all", "gather", "broadcast"):
        fn = getattr(ExchangePlane, name)

        def timed(self, edge, seq, *a, _fn=fn, **kw):
            t = time.perf_counter()
            try:
                return _fn(self, edge, seq, *a, **kw)
            finally:
                book["ms"] += (time.perf_counter() - t) * 1e3
                book["calls"] += 1
                book["rounds"] += edge == "tick"

        setattr(ExchangePlane, name, timed)
    close = ExchangePlane.close

    def closing(self):
        if not self._closed:
            book["samples"] = [(n, dict(lab), v) for _k, n, lab, v in self.observe_metrics()]
        close(self)

    ExchangePlane.close = closing
    return book


def cluster_worker(out_dir: str, docs_dir: str, rest_port: int, device: str) -> int:
    """One rank of phase 24 (``cli spawn`` sets the topology): the
    documents through partitioned ``pw.io.jsonlines`` readers into one
    ``TpuEmbedder``, a full-probe IVF ``DataIndex`` (every rank holds
    every row) and an exact one over a mesh spanning the ranks, a
    wordcount by key exchange, and the queries through the REST front on
    rank 0.  Writes ``rank<r>.json``; rank 0 also the checks."""
    import pathway_tpu_torch as pw
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator
    from pathway_tpu_torch.internals.run import terminate
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel.mesh import Mesh, local_shards, make_mesh

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_start = _now()
    dist.maybe_initialize()
    rank = dist.process_id()
    mesh = make_mesh(devices=[dev] * CL_LOCAL_SHARDS)
    emb = _cl_embedder(dev)
    dim = emb.get_embedding_dimension()
    book = _cl_timed_plane()

    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str

    with open(os.path.join(docs_dir, "..", "n_docs")) as f:
        n_docs = int(f.read())
    mod = pw.stdlib.indexing
    docs = pw.io.jsonlines.read(docs_dir, schema=Doc, mode="static", name="cluster_docs")
    vecs = docs.select(pw.this.doc_id, vec=emb(pw.this.text))
    words = docs.select(w=pw.apply(lambda t: tuple(t.split()), pw.this.text)).flatten(pw.this.w)
    counts = words.groupby(pw.this.w).reduce(pw.this.w, n=pw.reducers.count())
    ivf_index = mod.DataIndex(vecs, mod.InnerIndex(
        data_column=vecs.vec, dimension=dim, factory=mod.IvfKnnFactory(dimension=dim, n_probe=1 << 30, device=dev)))
    mesh_index = mod.DataIndex(vecs, mod.InnerIndex(
        data_column=vecs.vec, dimension=dim,
        factory=mod.TpuKnnFactory(dimension=dim, mesh=mesh, reserved_space=n_docs)))
    queries, writer = pw.io.http.rest_connector(
        host="127.0.0.1", port=rest_port, route=CL_ROUTE, schema=pw.schema_from_types(query=str),
        delete_completed_queries=True)
    qs = queries.select(pw.this.query, qvec=emb(pw.this.query))
    hits = {}
    for name, index in (("ivf", ivf_index), ("mesh", mesh_index)):
        res = index.query_as_of_now(qs.qvec, number_of_matches=K)
        hits[name] = res.select(ids=vecs.doc_id, scores=res.score)
    resp = qs.select(result=pw.apply(_cl_answer, qs.query, hits["ivf"].ids, hits["ivf"].scores,
                                     hits["mesh"].ids, hits["mesh"].scores))
    writer(resp)

    # what rank 0's sinks see (the other rank registers the same operators)
    answers, qvecs, wc = {}, {}, {}
    state = {"ingest_s": None, "linger": 0}

    def on_answer(key, row, time, is_addition):
        if is_addition:
            answers[row["result"]["query"]] = row["result"]

    def on_query(key, row, time, is_addition):
        if is_addition:
            qvecs[row["query"]] = np.asarray(row["qvec"], dtype=np.float32)

    def on_count(key, row, time, is_addition):
        if is_addition:
            wc[row["w"]] = int(row["n"])

    ops = []

    def on_tick(time_):
        if not ops:
            ops.extend(op for op in pw.G.engine_graph.operators if isinstance(op, ExternalIndexOperator))
        if state["ingest_s"] is None and ops and all(len(op.index.index) >= n_docs for op in ops):
            if cuda:
                torch.cuda.synchronize()
            state["ingest_s"] = _now() - t_run
            if rank == 0:
                with open(os.path.join(out_dir, "ready.part"), "w") as f:
                    json.dump({"ingest_s": state["ingest_s"]}, f)
                os.replace(os.path.join(out_dir, "ready.part"), os.path.join(out_dir, "ready"))
        if rank == 0 and os.path.exists(os.path.join(out_dir, "done")):
            state["linger"] += 1
            if state["linger"] >= 3:
                terminate()

    pw.io.subscribe(resp, on_change=on_answer if rank == 0 else None)
    pw.io.subscribe(qs, on_change=on_query if rank == 0 else None)
    pw.io.subscribe(counts, on_change=on_count if rank == 0 else None, on_time_end=on_tick)

    rescore_shortlist.launches = 0
    t_run = _now()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        pw.run(monitoring_level=None, commit_duration_ms=CL_COMMIT_MS)
        if cuda:
            torch.cuda.synchronize()
    wall_ms = (_now() - t_run) * 1e3
    launches = rescore_shortlist.launches
    busy = device_busy(prof, wall_ms) if cuda else "busy share not measured (the CPU)"
    ops = [op for op in pw.G.engine_graph.operators if isinstance(op, ExternalIndexOperator)]
    ivf, mx = ops[0].index.index, ops[1].index.index
    bytes_out = sum(v for n, lab, v in book["samples"] if n == "pathway_exchange_bytes_total"
                    and lab["direction"] == "out")
    bytes_in = sum(v for n, lab, v in book["samples"] if n == "pathway_exchange_bytes_total"
                   and lab["direction"] == "in")
    out = {
        "rank": rank, "ranks": dist.process_count(), "backend": dist.data_backend(), "launches": launches,
        "busy": busy, "wall_s": wall_ms / 1e3, "ingest_s": state["ingest_s"], "start_s": t_run - t_start,
        "index_rows": [len(ivf), len(mx)], "mesh_local": local_shards(mesh), "mesh_shards": mesh.shape["data"],
        "off_device": {"ivf": _cl_tensors_on(ivf, dev.type), "mesh": _cl_tensors_on(mx, dev.type)},
        "exchange": {"ms": book["ms"], "calls": book["calls"], "rounds": book["rounds"], "bytes_out": bytes_out,
                     "bytes_in": bytes_in},
        "ivf_clusters": int(ivf._centroids.shape[0]), "ivf_m_pad": int(ivf._M_pad),
        # host ms in process() of the operators that took the most
        "ops_ms": [[op.name, op.process_ns / 1e6] for op in sorted(
            pw.G.engine_graph.operators, key=lambda op: -op.process_ns)[:6]],
    }
    # the mesh index searched directly on both ranks (SPMD), with rank 0's
    # query vectors in answer order
    qtexts = dist.broadcast_obj(sorted(qvecs) if rank == 0 else None, name="p24-queries")
    qmat = dist.broadcast_obj(np.stack([qvecs[t] for t in qtexts]) if rank == 0 else None, name="p24-qvecs")
    direct = []
    for b in range(0, len(qmat), BATCH):
        direct.extend(mx.search(qmat[b : b + BATCH], K))
    # the fused serve path over the same mesh: the winners' keys gathered on
    # the device and made whole by one collective, booked as one dispatch
    # and one fetch per stage-1 serve on each rank
    from pathway_tpu_torch.ops.dispatch_counter import DispatchCounter
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    serve = FusedEncodeSearch(emb._encoder, mx, k=K)
    with DispatchCounter() as c:
        fused = serve(qtexts[:BATCH])
    out["fused"] = {"dispatches": c.dispatches, "fetches": c.fetches,
                    "rows": [[[int(k), np.float32(v).view(np.uint32).item()] for k, v in r] for r in fused]}
    if rank == 0:
        checks = {}
        # the documents' vectors as the index operators saw them (every row:
        # their mirrors), in the mesh index's slot order
        mirror = ops[0].mirrors[0]
        names = ops[0].inputs[0].column_names
        vcol, icol = names.index(next(n for n in names if "vec" in n)), None
        for j, n in enumerate(names):
            if "doc_id" in n:
                icol = j
        slots = sorted(mx.key_to_slot.items(), key=lambda kv: kv[1])
        doc_keys = [k for k, _s in slots]
        mat = np.stack([np.asarray(mirror.get(k)[vcol], dtype=np.float32) for k in doc_keys])
        doc_id_of = {k: int(mirror.get(k)[icol]) for k in doc_keys}
        # (1) each IVF answer == an exact search over the same embeddings
        m = torch.from_numpy(mat).to(dev)
        m = m / torch.linalg.vector_norm(m, dim=1, keepdim=True)
        q = torch.from_numpy(qmat).to(dev)
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        s, i = torch.topk(q @ m.t(), K, dim=1)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        bad_ivf = 0
        for qi, t in enumerate(qtexts):
            want = [(doc_id_of[doc_keys[int(i[qi, j])]], float(s[qi, j])) for j in range(K)]
            got = list(zip(*answers[t]["ivf"])) if t in answers else []
            bad_ivf += not same_ranking(want, got, tie=CL_TOL, atol=CL_TOL)
        checks["ivf_vs_exact_mismatches"] = bad_ivf
        # (2) the mesh index spanning the ranks == one process's 8-shard mesh,
        # bit for bit, on the same vectors in the same slots
        one = DeviceKnnIndex(dim, metric="cos", initial_capacity=mx.capacity, mesh=Mesh([[dev]] * mx.n_shards),
                             device=dev)
        one.add(doc_keys, mat)
        ref = []
        for b in range(0, len(qmat), BATCH):
            ref.extend(one.search(qmat[b : b + BATCH], K))
        checks["mesh_vs_one_process_equal"] = [[(k, np.float32(v).view(np.uint32).item()) for k, v in r] for r in direct] \
            == [[(k, np.float32(v).view(np.uint32).item()) for k, v in r] for r in ref]
        # the mesh answers through the REST front == the direct search's keys
        bad_mesh = 0
        for qi, t in enumerate(qtexts):
            want = [(doc_id_of[k], v) for k, v in direct[qi]]
            got = list(zip(*answers[t]["mesh"])) if t in answers else []
            bad_mesh += not same_ranking(want, got, tie=CL_TOL, atol=CL_TOL)
        checks["mesh_rest_vs_direct_mismatches"] = bad_mesh
        checks["fused_vs_direct_mismatches"] = sum(
            not same_ranking(direct[qi], [(k, float(np.uint32(b).view(np.float32))) for k, b in row],
                             tie=CL_TOL, atol=CL_TOL)
            for qi, row in enumerate(out["fused"]["rows"]))
        # (3) the wordcount == a plain Counter over the documents
        from collections import Counter

        texts = []
        for name in sorted(os.listdir(docs_dir)):
            with open(os.path.join(docs_dir, name)) as f:
                texts.extend(json.loads(line)["text"] for line in f)
        checks["wordcount_equal"] = wc == dict(Counter(w for t in texts for w in t.split()))
        checks["answers"] = len(answers)
        out["checks"] = checks
        out["answers"] = answers
        # (4) the rescore at the cluster path's shape, against its plain version
        if cuda:
            out["shape"] = rescore_at_path_shape(ivf, ivf_search_rescore_args(ivf, qmat[:BATCH]), dev)
            out["shape_line"] = rescore_line(ivf, out["shape"])
    with open(os.path.join(out_dir, f"rank{rank}.json.part"), "w") as f:
        json.dump(out, f)
    os.replace(os.path.join(out_dir, f"rank{rank}.json.part"), os.path.join(out_dir, f"rank{rank}.json"))
    dist.barrier("p24-done")
    dist.shutdown()
    return 0


def cluster_kill_worker(data_dir: str, out_csv: str) -> int:
    """One rank of phase 24's kill arm: a streaming wordcount over csv
    files (partitioned readers, one sink on rank 0) that never stops by
    itself."""
    import pathway_tpu_torch as pw

    class Row(pw.Schema):
        word: str

    rows = pw.io.csv.read(data_dir, schema=Row, mode="streaming", poll_interval_s=0.05)
    counts = rows.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.csv.write(counts, out_csv)
    pw.run(monitoring_level=None, commit_duration_ms=50)
    return 0


def _cl_post(port: int, text: str):
    """One ``/v1/retrieve`` request: ``(ms, status, answer)``."""
    import urllib.request

    t = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{CL_ROUTE}", data=json.dumps({"query": text}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=CL_TIMEOUT_S) as resp:
        body = json.loads(resp.read())
        return (time.perf_counter() - t) * 1e3, resp.status, body


def _cl_kill_start(root: str) -> dict:
    """Start the kill arm's two ranks (a streaming wordcount, off the
    card); they run while the cluster arm does."""
    from pathway_tpu_torch.cli import _topology_env

    data_dir = os.path.join(root, "kill_data")
    os.makedirs(data_dir, exist_ok=True)
    words = list(_WORDS[:16])
    for part in range(CL_KILL_FILES):
        path = os.path.join(data_dir, f"part{part:02d}.csv")
        with open(path + ".tmp", "w") as f:
            f.write("word\n" + "".join(words[(part * 7 + i) % len(words)] + "\n" for i in range(CL_KILL_ROWS)))
        os.replace(path + ".tmp", path)
    out_csv = os.path.join(root, "kill_out.csv")
    port = _free_port()
    procs = []
    for rank in range(CL_RANKS):
        env = _topology_env(rank, CL_RANKS, port)
        env.update(PATHWAY_EXCHANGE_HEARTBEAT=str(CL_HB_S), PATHWAY_EXCHANGE_HEARTBEAT_TIMEOUT=str(CL_HB_TIMEOUT_S))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cluster-kill-worker", data_dir, out_csv], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    return {"procs": procs, "out_csv": out_csv}


def _cl_kill_finish(arm: dict) -> dict:
    """Once the stream has counted every row: SIGKILL of rank 1, then the
    time until rank 0 exits and its status (70: it lost its peer)."""
    import signal

    procs, out_csv = arm["procs"], arm["out_csv"]
    try:
        deadline = time.monotonic() + CL_TIMEOUT_S
        want = CL_KILL_FILES * CL_KILL_ROWS
        while True:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("phase 24 kill arm: a rank exited before the kill: "
                                     + " | ".join(p.stderr.read()[-1500:] for p in procs if p.poll() is not None))
            latest = {}
            if os.path.exists(out_csv):
                with open(out_csv) as f:
                    for line in f.readlines()[1:]:
                        w, n, _t, diff = line.strip().split(",")
                        if diff == "1":
                            latest[w] = int(n)
            if sum(latest.values()) >= want:
                break
            if time.monotonic() > deadline:
                raise AssertionError("phase 24 kill arm: the stream made no progress")
            time.sleep(0.05)
        t0 = time.monotonic()
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait()
        while time.monotonic() - t0 < 30 and procs[0].poll() is None:
            time.sleep(0.01)
        detect_s = time.monotonic() - t0
        rc0 = procs[0].poll()
        err = procs[0].stderr.read() if rc0 is not None else ""
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"rc0": rc0, "detect_s": detect_s, "err": err[-600:]}


def cluster_phase(tag: str, dev=None, n_docs: int = N_DOCS, fw_ingest=None):
    """Phase 24: the multi-process engine — two ranks of this script
    through ``python -m pathway_tpu_torch.cli spawn --processes 2`` on the
    one card, then the kill arm.  Returns (the rescore's launches per rank,
    the kernel at the cluster path's shape)."""
    import concurrent.futures
    import shutil
    import tempfile

    t_phase = _now()
    dev = dev or torch.device(DEVICE)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="p24-")
    try:
        docs_dir = os.path.join(root, "docs")
        texts = corpus(n_docs)
        _ps_write_docs(docs_dir, 0, texts, n_docs // CL_FILES)
        with open(os.path.join(root, "n_docs"), "w") as f:
            f.write(str(n_docs))
        out_dir = os.path.join(root, "out")
        os.makedirs(out_dir)
        # the kill arm's ranks start now and stream off the card while the
        # cluster arm runs; the kill comes after it
        kill_arm = _cl_kill_start(root)
        rest_port, first_port = _free_port(), _free_port()
        here = os.path.dirname(os.path.abspath(__file__))
        log_path = os.path.join(root, "spawn.log")
        with open(log_path, "w") as spawn_log:
            spawn = subprocess.Popen(
                [sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "--processes", str(CL_RANKS),
                 "--first-port", str(first_port), sys.executable, os.path.abspath(__file__), "--cluster-worker",
                 out_dir, docs_dir, str(rest_port), dev.type],
                cwd=here, stdout=spawn_log, stderr=subprocess.STDOUT,
            )

        def failed(what: str):
            if spawn.poll() is None:
                spawn.kill()
                spawn.wait()
            with open(log_path) as f:
                raise AssertionError(f"phase 24: {what}\n{f.read()[-6000:]}")

        deadline = time.monotonic() + CL_TIMEOUT_S
        while not os.path.exists(os.path.join(out_dir, "ready")):
            if spawn.poll() is not None or time.monotonic() > deadline:
                failed("the ranks did not ingest the documents")
            time.sleep(0.05)
        ready_s = _now() - t_phase
        with open(os.path.join(out_dir, "ready")) as f:
            ingest_s = json.load(f)["ingest_s"]
        # documents' own texts as queries, distinct over the phase (7919 is prime)
        batches = [[texts[((b * BATCH + i) * 7919) % n_docs] for i in range(BATCH)] for b in range(CL_COMMITS)]
        commit_ms, request_ms, http = [], [], {}
        with concurrent.futures.ThreadPoolExecutor(BATCH) as pool:
            for texts_b in batches:
                t = time.perf_counter()
                got = list(pool.map(lambda s: _cl_post(rest_port, s), texts_b))
                commit_ms.append((time.perf_counter() - t) * 1e3)
                for text, (ms, status, body) in zip(texts_b, got):
                    request_ms.append(ms)
                    if status != 200 or not isinstance(body, dict) or body.get("query") != text:
                        failed(f"bad answer {status} {str(body)[:200]}")
                    http[text] = body
        open(os.path.join(out_dir, "done"), "w").close()
        try:
            rc = spawn.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            failed("the ranks did not stop")
        if rc != 0:
            failed(f"cli spawn exited {rc}")
        ranks = []
        for r in range(CL_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        cluster_s = _now() - t_phase
        r0 = ranks[0]
        ck = r0["checks"]
        n_q = CL_COMMITS * BATCH
        problems = []
        if [r["ranks"] for r in ranks] != [CL_RANKS] * CL_RANKS or [r["backend"] for r in ranks] != ["gloo"] * 2:
            problems.append(f"topology {[(r['ranks'], r['backend']) for r in ranks]}")
        if any(r["index_rows"] != [n_docs, n_docs] for r in ranks):
            problems.append(f"index rows {[r['index_rows'] for r in ranks]} != {n_docs} on each rank")
        if any(r["mesh_shards"] != CL_RANKS * CL_LOCAL_SHARDS for r in ranks):
            problems.append("mesh shards")
        if any(r["off_device"]["ivf"] or r["off_device"]["mesh"] for r in ranks):
            problems.append(f"index tensors off {dev.type}: {[r['off_device'] for r in ranks]}")
        if ck["answers"] != n_q or len(http) != n_q:
            problems.append(f"{ck['answers']} answers on rank 0's sink, {len(http)} over HTTP, of {n_q}")
        if any(http[t] != r0["answers"].get(t) for t in http):
            problems.append("an HTTP answer differs from rank 0's sink")
        if ck["ivf_vs_exact_mismatches"]:
            problems.append(f"{ck['ivf_vs_exact_mismatches']} IVF answers differ from an exact search")
        if not ck["mesh_vs_one_process_equal"]:
            problems.append("the mesh index over 2 ranks differs from one process's 8-shard mesh")
        if ck["mesh_rest_vs_direct_mismatches"]:
            problems.append(f"{ck['mesh_rest_vs_direct_mismatches']} mesh answers differ from its direct search")
        if ranks[0]["fused"]["rows"] != ranks[1]["fused"]["rows"] or ck["fused_vs_direct_mismatches"]:
            problems.append(f"the fused serve over the mesh: ranks agree {ranks[0]['fused']['rows'] == ranks[1]['fused']['rows']}, "
                            f"{ck['fused_vs_direct_mismatches']} rows differ from the direct search")
        if any((r["fused"]["dispatches"], r["fused"]["fetches"]) != (1, 1) for r in ranks):
            problems.append(f"fused serve dispatches + fetches per rank "
                            f"{[(r['fused']['dispatches'], r['fused']['fetches']) for r in ranks]} != 1 + 1")
        if not ck["wordcount_equal"]:
            problems.append("the wordcount differs from a plain Counter")
        if cuda and any(r["launches"] < 1 for r in ranks):
            problems.append(f"rescore launches per rank {[r['launches'] for r in ranks]}")
        if problems:
            failed("; ".join(problems))

        t_kill = _now()
        kill = _cl_kill_finish(kill_arm)
        kill_s = _now() - t_kill
        if kill["rc0"] != 70 or kill["detect_s"] > CL_HB_TIMEOUT_S:
            raise AssertionError(f"phase 24 kill arm: rank 0 rc {kill['rc0']} after {kill['detect_s']:.3f} s "
                                 f"(want 70 within {CL_HB_TIMEOUT_S} s): {kill['err']}")
    finally:
        for p in kill_arm["procs"] if "kill_arm" in locals() else ():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)

    base = (f"phase 19's one process in this run: direct encode + IVF add {fw_ingest['direct_s']:.3f} s, the engine "
            f"into 4 indexes {fw_ingest['ingest_s']:.3f} s" if fw_ingest else "phase 19's one process not run here")
    log(
        f"cluster {tag}: {CL_RANKS} ranks of this script through `python -m pathway_tpu_torch.cli spawn --processes "
        f"{CL_RANKS}` on one card ({ranks[0]['backend']} data plane, TCP exchange plane), {n_docs} documents as "
        f"{CL_FILES} JSON-lines files read by partitioned pw.io.jsonlines readers; one TpuEmbedder shared by a "
        f"full-probe IVF DataIndex (C={r0['ivf_clusters']}, M_pad {r0['ivf_m_pad']}; rows per rank "
        f"{[r['index_rows'][0] for r in ranks]}) and an exact DataIndex over a mesh of {r0['mesh_shards']} shards "
        f"({CL_LOCAL_SHARDS} per rank, local {[r['mesh_local'] for r in ranks]}), a wordcount groupby, "
        f"{n_q} queries in {CL_COMMITS} commits of {BATCH} through the REST front on rank 0 ({CL_ROUTE}): every "
        f"answer 200 and == rank 0's sink, IVF == an exact search over the same embeddings (keys up to ties, scores "
        f"within {CL_TOL}), the mesh's direct search == one process's 8-shard mesh bit for bit and its REST answers "
        f"== that search, FusedEncodeSearch over the same mesh equal on both ranks and == that search in 1 dispatch + "
        f"1 fetch per stage-1 serve on each rank (the key planes' collective inside the dispatch), the wordcount "
        f"== a plain Counter, every index tensor on {dev.type}"
    )
    log(
        f"cluster numbers {tag}: ingest (run start to both index operators holding every row) "
        + " / ".join(f"{r['ingest_s']:.3f}" for r in ranks) + f" s on ranks 0 / 1 against {base}; ranks up and "
        f"ingested {ready_s:.1f} s after the spawn; retrieve per commit of {BATCH} through the REST front p50 "
        f"{np.percentile(commit_ms, 50):.3f} ms p99 {np.percentile(commit_ms, 99):.3f} ms ("
        + ", ".join(f"{v:.3f}" for v in commit_ms) + f"), per request p50 {np.percentile(request_ms, 50):.3f} ms "
        f"p99 {np.percentile(request_ms, 99):.3f} ms; exchange plane per rank (pathway_exchange_bytes_total, host "
        f"timers around its collectives) "
        + "; ".join(
            f"rank {r['rank']}: {r['exchange']['rounds']} tick rounds, {r['exchange']['calls']} collectives, "
            f"{r['exchange']['bytes_out'] / max(1, r['exchange']['rounds']):.0f} bytes out and "
            f"{r['exchange']['ms'] / max(1, r['exchange']['rounds']):.3f} ms per round "
            f"({r['exchange']['bytes_out'] / 1e6:.3f} MB out, {r['exchange']['bytes_in'] / 1e6:.3f} MB in)"
            for r in ranks)
        + "; busy per rank: " + "; ".join(f"rank {r['rank']} {r['busy']} over its {r['wall_s']:.3f} s run"
                                         for r in ranks)
        + f"; rescore launches per rank {[r['launches'] for r in ranks]}; host ms in process() of the costliest "
        "operators per rank: " + "; ".join(
            f"rank {r['rank']} " + ", ".join(f"{name} {ms:.1f}" for name, ms in r["ops_ms"]) for r in ranks)
    )
    shape = r0.get("shape")
    if shape is not None:
        log(f"ivf_rescore at the cluster shape {tag}: {r0['shape_line']}")
    log(
        f"cluster kill arm {tag}: SIGKILL of rank 1 during a streaming wordcount (heartbeat {CL_HB_S} s, timeout "
        f"{CL_HB_TIMEOUT_S} s; its ranks started with the cluster arm and streamed off the card beside it): rank 0 "
        f"exited with status {kill['rc0']} (lost peer) {kill['detect_s']:.3f} s after the kill; {kill_s:.1f} s after "
        f"the cluster arm; phase 24 {_now() - t_phase:.1f} s (the cluster arm {cluster_s:.1f} s)"
    )
    return [r["launches"] for r in ranks], shape


# -- phase 25: a CDC feed into a live vector index ---------------------------------
CX_OBJECTS = 16  # JSON-lines objects in the bucket, N_DOCS / 16 documents each
CX_PARTITIONS = 4  # partitions of the CDC and query topics
CX_COMMITS = 4  # CDC commits, each followed by a query commit of BATCH
CX_UPDATES = 1024  # document updates over the CDC commits
CX_DELETES = 1024  # document deletes over the CDC commits
CX_RE_DELETES = 64  # of each later commit's deletes, documents the commit before updated
CX_COMMIT_MS = 10  # the engine's commit tick
CX_WAIT_S = 300.0
CX_ENDPOINT = "http://127.0.0.1:4317"  # the recording opentelemetry below never connects
CX_BUCKET, CX_PREFIX = "cx-corpus", "documents/"
CX_CDC_TOPIC, CX_QUERY_TOPIC, CX_ANSWER_TOPIC = "cx.public.documents", "cx.queries", "cx.answers"
CX_BROKER = "cx-broker:9092"


class _CxBroker:
    """The phase's Kafka broker: each topic an append-only log of
    ``(partition, offset, value)`` over ``CX_PARTITIONS`` partitions (by
    key), read from the start by every consumer (``auto.offset.reset =
    earliest``) until the topic is closed; produced messages are kept by
    topic."""

    def __init__(self):
        self.cond = threading.Condition()
        self.logs, self.closed, self.offsets, self.produced = {}, set(), {}, {}

    def publish(self, topic: str, items) -> None:
        """One commit of ``(key, JSON-able value)``: partition ``key %
        CX_PARTITIONS``, the partitions interleaved as a broker serves them."""
        with self.cond:
            offsets = self.offsets.setdefault(topic, [0] * CX_PARTITIONS)
            msgs = []
            for key, value in items:
                p = key % CX_PARTITIONS
                msgs.append((offsets[p], p, json.dumps(value).encode()))
                offsets[p] += 1
            self.logs.setdefault(topic, []).extend((p, o, v) for o, p, v in sorted(msgs))
            self.cond.notify_all()

    def close(self) -> None:
        with self.cond:
            self.closed.update(self.logs)
            self.closed.update((CX_CDC_TOPIC, CX_QUERY_TOPIC))
            self.cond.notify_all()

    def consume(self, topic: str):
        i = 0
        while True:
            with self.cond:
                while i >= len(self.logs.get(topic, ())) and topic not in self.closed:
                    self.cond.wait(0.05)
                log = self.logs.get(topic, [])
                if i >= len(log):
                    return
                batch, i = log[i:], len(log)
            for p, o, v in batch:
                yield types.SimpleNamespace(partition=p, offset=o, value=v)

    def modules(self, bucket: dict, pg_log: list, spans: list) -> dict:
        """The client modules the phase's connectors import: ``kafka``,
        ``boto3`` over ``bucket`` ({key: (etag, bytes)}), ``psycopg2``
        logging to ``pg_log``, and an ``opentelemetry`` whose tracer
        records finished spans in ``spans``."""
        import contextlib

        broker = self

        class KafkaConsumer:
            def __init__(self, topic, **kw):
                assert kw.get("bootstrap_servers") == CX_BROKER, kw
                self._it = broker.consume(topic)

            def __iter__(self):
                return self._it

        class KafkaProducer:
            def __init__(self, **kw):
                assert kw.get("bootstrap_servers") == CX_BROKER, kw

            def send(self, topic, payload):
                with broker.cond:
                    broker.produced.setdefault(topic, []).append(payload)

            def flush(self):
                pass

        class S3:
            def get_paginator(self, op):
                assert op == "list_objects_v2"
                return types.SimpleNamespace(paginate=lambda Bucket, Prefix: [{"Contents": [
                    {"Key": key, "ETag": etag} for key, (etag, _b) in sorted(bucket.items())
                    if Bucket == CX_BUCKET and key.startswith(Prefix)]}])

            def download_file(self, bkt, key, local):
                with open(local, "wb") as f:
                    f.write(bucket[key][1])

        class Cursor:
            def execute(self, sql, params):
                pg_log.append((" ".join(sql.split()), tuple(params)))

        class Conn:
            def cursor(self):
                return Cursor()

            def commit(self):
                pass

            def close(self):
                pass

        class Span:
            def __init__(self):
                self.attrs = {}

            def set_attribute(self, key, value):
                self.attrs[key] = value

        class Tracer:
            @contextlib.contextmanager
            def start_as_current_span(self, name):
                span = Span()
                yield span
                spans.append((name, dict(span.attrs)))

        class Meter:
            def create_observable_gauge(self, *a, **k):
                pass

            create_observable_counter = create_observable_gauge

        def module(name, **attrs):
            mod = types.ModuleType(name)
            mod.__dict__.update(attrs)
            return mod

        trace = module("opentelemetry.trace", get_tracer=lambda name: Tracer())
        metrics = module("opentelemetry.metrics", get_meter=lambda name: Meter())
        return {
            "kafka": module("kafka", KafkaConsumer=KafkaConsumer, KafkaProducer=KafkaProducer),
            "boto3": module("boto3", client=lambda service, **kw: S3()),
            "psycopg2": module("psycopg2", connect=lambda **kw: Conn()),
            "opentelemetry": module("opentelemetry", trace=trace, metrics=metrics),
            "opentelemetry.trace": trace,
            "opentelemetry.metrics": metrics,
            "opentelemetry.sdk": module("opentelemetry.sdk"),
            "opentelemetry.sdk.resources": module("opentelemetry.sdk.resources", Resource=types.SimpleNamespace(
                create=lambda attrs: attrs)),
        }


def _cx_bucket(docs) -> dict:
    """The bucket: ``CX_OBJECTS`` JSON-lines objects of the documents,
    each with an etag."""
    import hashlib

    per = len(docs) // CX_OBJECTS
    bucket = {}
    for o in range(CX_OBJECTS):
        body = "".join(json.dumps({"doc_id": i, "text": docs[i]}) + "\n"
                       for i in range(o * per, (o + 1) * per)).encode()
        bucket[f"{CX_PREFIX}part{o:03d}.jsonl"] = (hashlib.md5(body).hexdigest(), body)
    return bucket


def _cx_changes(docs, n_updates: int, n_deletes: int, commits: int):
    """The CDC commits: per commit ``(updates, deletes)``, an update
    ``(doc, before, after)``, a delete ``(doc, before)``; from commit 1 on
    the first ``CX_RE_DELETES`` deletes are documents the commit before
    updated (their before image the updated text)."""
    rng = np.random.default_rng(SEED + 25)
    order = rng.permutation(len(docs)).tolist()
    upd, dele = order[:n_updates], order[n_updates : n_updates + n_deletes]
    per_u, per_d = n_updates // commits, n_deletes // commits
    text = dict(enumerate(docs))
    out, prev = [], []
    fresh_deletes = iter(dele)
    for c in range(commits):
        updates = [(d, text[d], f"{text[d]} revised{c}") for d in upd[c * per_u : (c + 1) * per_u]]
        re_del = prev[: min(CX_RE_DELETES, per_d)] if c else []
        deletes = [(d, after) for d, _b, after in re_del]
        deletes += [(d, text[d]) for d in itertools.islice(fresh_deletes, per_d - len(deletes))]
        for d, _b, after in updates:
            text[d] = after
        out.append((updates, deletes))
        prev = updates
    return out


def _cx_envelope(doc: int, op: str, before=None, after=None) -> dict:
    payload = {"op": op, "source": {"table": "documents"}, "ts_ms": 0}
    if before is not None:
        payload["before"] = {"doc_id": doc, "text": before}
    if after is not None:
        payload["after"] = {"doc_id": doc, "text": after}
    return {"payload": payload}


def _cx_graph(pw, emb, dev, cuda: bool):
    """The phase's graph: the bulk documents from S3, the CDC feed applied
    (debezium after images over them, its deletes through a second
    consumer group of the same topic), the live documents embedded into a
    full-probe IVF ``DataIndex``, queries from Kafka answered as of now,
    the answers out to Kafka and to a Postgres snapshot."""
    import zlib

    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str

    class Envelope(pw.Schema):
        payload: dict

    class Query(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        query: str

    def field(payload, *path):
        value = getattr(payload, "value", payload)
        for p in path:
            value = (value or {}).get(p)
        return value

    settings = {"bootstrap.servers": CX_BROKER, "auto.offset.reset": "earliest"}
    bulk = pw.io.s3.read(f"s3://{CX_BUCKET}/{CX_PREFIX}", format="json", schema=Doc, mode="static", name="cx_bulk")
    changed = pw.io.debezium.read({**settings, "group.id": "cx-index"}, CX_CDC_TOPIC, schema=Doc, name="cx_cdc")
    raw = pw.io.kafka.read({**settings, "group.id": "cx-tombstones"}, CX_CDC_TOPIC, schema=Envelope, format="json",
                           name="cx_cdc_raw")
    deleted = raw.select(op=pw.apply(field, pw.this.payload, "op"),
                         doc_id=pw.apply(lambda p: int(field(p, "before", "doc_id")), pw.this.payload))
    deleted = deleted.filter(pw.this.op == "d").with_id_from(pw.this.doc_id)
    live = bulk.update_rows(changed).difference(deleted)
    vecs = live.select(pw.this.doc_id, vec=emb(pw.this.text),
                       meta=pw.apply(lambda d, t: {"doc": int(d), "crc": zlib.crc32(t.encode())}, pw.this.doc_id,
                                     pw.this.text))
    mod = pw.stdlib.indexing
    index = mod.DataIndex(vecs, mod.InnerIndex(
        data_column=vecs.vec, metadata_column=vecs.meta, dimension=emb.get_embedding_dimension(),
        factory=mod.IvfKnnFactory(dimension=emb.get_embedding_dimension(), n_probe=1 << 30,
                                  device=None if cuda else dev),
    ))
    queries = pw.io.kafka.read({**settings, "group.id": "cx-queries"}, CX_QUERY_TOPIC, schema=Query, format="json",
                               name="cx_queries")
    qs = queries.select(pw.this.qid, qvec=emb(pw.this.query))
    res = index.query_as_of_now(qs.qvec, number_of_matches=K)
    answers = res.select(qid=qs.qid, docs=vecs.doc_id, scores=res.score).select(
        pw.this.qid, docs=pw.apply(lambda ds: tuple(int(d) for d in ds), pw.this.docs),
        scores=pw.apply(lambda ss: tuple(float(s) for s in ss), pw.this.scores))
    pw.io.kafka.write(answers, settings, topic_name=CX_ANSWER_TOPIC)
    pw.io.postgres.write_snapshot(answers, {"host": "cx-db", "dbname": "answers"}, "cx_answers", primary_key=["qid"])
    return answers


def connectors_retrieval(pw, emb, docs, dev, commits: int = CX_COMMITS):
    """Phase 25's run: the graph over the fake bucket, broker, database
    and tracer, driven commit by commit; returns the report."""
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist

    cuda = dev.type == "cuda"
    n = len(docs)
    broker, pg_log, spans = _CxBroker(), [], []
    bucket = _cx_bucket(docs)
    changes = _cx_changes(docs, CX_UPDATES * n // N_DOCS, CX_DELETES * n // N_DOCS, commits)
    fakes = broker.modules(bucket, pg_log, spans)
    saved = {name: sys.modules.get(name) for name in fakes}
    sys.modules.update(fakes)
    config = pw.get_config()
    endpoint = config.monitoring_server
    from pathway_tpu_torch.observe import recorder

    spans_on, telemetry = recorder._spans_on, recorder._telemetry
    driver = _FrameworkDriver("phase 25")
    report = {"cdc_ms": [], "latency_ms": [], "alive": [], "index_rows": [], "searches_of": [], "fresh": [],
              "fresh_first": 0, "updates": sum(len(u) for u, _d in changes),
              "deletes": sum(len(d) for _u, d in changes)}
    try:
        pw.set_monitoring_config(server_endpoint=CX_ENDPOINT)
        t_build = _now()
        answers = _cx_graph(pw, emb, dev, cuda)
        pw.io.subscribe(answers, on_change=driver.on_change("answers"), on_time_end=driver.on_tick)
        (op,) = [o for o in pw.G.engine_graph.operators if isinstance(o, ExternalIndexOperator)]
        inner, ivf = op.index, op.index.index
        live, vec_of_key, doc_of_key = {}, {}, {}  # key -> (doc, crc), its vector, its document
        searches = []
        orig_add, orig_remove, orig_search = inner.add, inner.remove, inner.search

        def add(keys, values, metadatas):
            orig_add(keys, values, metadatas)
            with driver.cond:
                for key, value, md in zip(keys, values, metadatas):
                    md = getattr(md, "value", md)
                    live[int(key)] = (int(md["doc"]), int(md["crc"]))
                    doc_of_key[int(key)] = int(md["doc"])
                    vec_of_key[int(key)] = np.asarray(value, np.float32)
                driver.cond.notify_all()

        def remove(keys):
            orig_remove(keys)
            with driver.cond:
                for key in keys:
                    live.pop(int(key), None)
                driver.cond.notify_all()

        def search(values, k, filters):
            out = orig_search(values, k, filters)
            searches.append((np.stack([np.asarray(v, np.float32) for v in values]), k, out))
            return out

        inner.add, inner.remove, inner.search = add, remove, search
        report["build_s"] = _now() - t_build
        import zlib

        want = {d: zlib.crc32(t.encode()) for d, t in enumerate(docs)}
        qidx = query_ids()

        def state():
            return {doc: crc for doc, crc in live.values()}

        def drive():
            driver.wait(lambda: state() == want, "the bulk documents in the index")
            report["ingest_s"] = _now() - report["t_run"]
            for c, (updates, deletes) in enumerate(changes):
                for d, _b, after in updates:
                    want[d] = zlib.crc32(after.encode())
                for d, _b in deletes:
                    want.pop(d)
                t_cdc = _now()
                broker.publish(CX_CDC_TOPIC, [(d, _cx_envelope(d, "u", before, after)) for d, before, after in updates]
                               + [(d, _cx_envelope(d, "d", before)) for d, before in deletes])
                driver.wait(lambda: state() == want, f"CDC commit {c} in the index")
                report["cdc_ms"].append((_now() - t_cdc) * 1e3)
                report["alive"].append({key: vec_of_key[key] for key in live})
                report["index_rows"].append((len(ivf), len(want)))
                n_before = len(searches)
                fresh = [after for _d, _b, after in updates[: BATCH // 2]]
                texts = fresh + [docs[qidx[c * BATCH + b] % n] for b in range(BATCH - len(fresh))]
                report["fresh"].append([d for d, _b, _a in updates[: BATCH // 2]])
                t_q = _now()
                broker.publish(CX_QUERY_TOPIC, [(b, {"qid": c * BATCH + b, "query": text})
                                                for b, text in enumerate(texts)])
                driver.wait(lambda: len(driver.answers.get("answers", {})) >= (c + 1) * BATCH,
                            f"the answers of query commit {c}")
                last = max(t for t, _k, _d in driver.arrival["answers"])
                report["latency_ms"].append((last - t_q) * 1e3)
                report["searches_of"].append(list(range(n_before, len(searches))))

        def run_driver():
            try:
                drive()
            except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread after the run
                report["error"] = exc
            finally:
                broker.close()

        rescore_shortlist.launches = 0
        thread = threading.Thread(target=run_driver, daemon=True, name="phase25-driver")
        with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
            report["t_run"] = t_run = _now()
            thread.start()
            try:
                pw.run(commit_duration_ms=CX_COMMIT_MS)
            finally:
                driver.stop = True
                thread.join(timeout=60)
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (_now() - t_run) * 1e3
        report["launches"] = rescore_shortlist.launches
        if "error" in report:
            raise report["error"]
        report.update(wall_ms=wall_ms, stats=dict(ivf.stats),
                      busy=device_busy(prof, wall_ms) if cuda else "busy share not measured (CPU)")

        # -- checks ---------------------------------------------------------------
        deleted_docs = set()
        bad_rank = gone = 0
        max_err = 0.0
        for c, (alive, (rows_in, n_alive)) in enumerate(zip(report["alive"], report["index_rows"])):
            deleted_docs.update(d for d, _b in changes[c][1])
            if rows_in != n_alive or len(alive) != n_alive:
                raise AssertionError(f"phase 25: after CDC commit {c} the index holds {rows_in} rows "
                                     f"({len(alive)} keys), {n_alive} documents are alive")
            # the Kafka source has no atomic commit: a query commit's rows may
            # land in more than one tick, each tick one search
            if not report["searches_of"][c]:
                raise AssertionError(f"phase 25: query commit {c} searched no time")
            rows = []
            for si in report["searches_of"][c]:
                qv, k, part = searches[si]
                exact = _tm_exact(alive, set(alive), qv, k, dev)
                for got, ref in zip(part, exact):
                    got = [(int(key), float(score)) for key, score in got]
                    gone += sum(1 for key, _s in got if key not in alive)
                    bad_rank += not same_ranking(ref, got, tie=1e-5, atol=TM_EXACT_TOL)
                    max_err = max([max_err] + [abs(a[1] - b[1]) for a, b in zip(ref, got)])
                rows.extend(part)
            answered = {ev[-1][1]["qid"]: ev[-1][1]["docs"] for ev in driver.answers["answers"].values()
                        if ev[-1][1]["qid"] // BATCH == c}
            if sorted(answered.values()) != sorted(tuple(doc_of_key[int(key)] for key, _s in r) for r in rows):
                raise AssertionError(f"phase 25: commit {c}'s answers differ from its index's search")
            if any(d in deleted_docs for docs_ in answered.values() for d in docs_):
                raise AssertionError(f"phase 25: commit {c} answered a deleted document")
            report["fresh_first"] += sum(1 for b, d in enumerate(report["fresh"][c])
                                         if answered[c * BATCH + b] and answered[c * BATCH + b][0] == d)
        retracted = sum(1 for evs in driver.answers["answers"].values() for e in evs if e[2] < 0)
        if bad_rank or gone or retracted:
            raise AssertionError(f"phase 25: {bad_rank} answers differ from the exact search over the alive "
                                 f"documents, {gone} hits not alive, {retracted} retracted")
        events = [(t, row, diff) for evs in driver.answers["answers"].values() for t, row, diff in evs]
        want_kafka = sorted(json.dumps({"qid": int(row["qid"]), "docs": list(row["docs"]),
                                        "scores": list(row["scores"]), "time": t, "diff": diff}, sort_keys=True)
                            for t, row, diff in events)
        got_kafka = sorted(json.dumps(json.loads(p), sort_keys=True) for p in broker.produced.get(CX_ANSWER_TOPIC, ()))
        ins = ("INSERT INTO cx_answers (qid, docs, scores) VALUES (%s, %s, %s) ON CONFLICT (qid) DO UPDATE SET "
               "docs = EXCLUDED.docs, scores = EXCLUDED.scores")
        want_pg = sorted(((ins, (row["qid"], row["docs"], row["scores"])) if diff > 0
                          else ("DELETE FROM cx_answers WHERE qid = %s", (row["qid"],)))
                         for _t, row, diff in events)
        if got_kafka != want_kafka or sorted(pg_log) != want_pg:
            raise AssertionError(f"phase 25: {len(got_kafka)} Kafka messages and {len(pg_log)} Postgres statements, "
                                 f"a plain loop over the {len(events)} answer events gives {len(want_kafka)} and "
                                 f"{len(want_pg)} (equal: {got_kafka == want_kafka}, {sorted(pg_log) == want_pg})")
        graph = {"operators": len(pw.G.engine_graph.operators), "tables": len(pw.G.engine_graph.tables)}
        if spans != [("pathway.run", graph)]:
            raise AssertionError(f"phase 25: spans {spans}, expected one pathway.run span with {graph}")
        off = _cl_tensors_on(ivf, "cuda") if cuda else []
        if cuda and (report["launches"] == 0 or off):
            raise AssertionError(f"phase 25: {report['launches']} rescore launches, index tensors off the card: {off}")
        report.update(max_err=max_err, events=len(events), kafka=len(got_kafka), pg=len(pg_log), graph=graph,
                      n_clusters=int(ivf._centroids.shape[0]), searches=[len(of) for of in report["searches_of"]],
                      queries=np.concatenate([searches[si][0] for si in report["searches_of"][-1]]),
                      dead=int(torch.isneginf(ivf._bias).sum()) if ivf._bias is not None else 0,
                      slots=0 if ivf._bias is None else int(ivf._bias.numel()), alive_end=len(ivf),
                      bucket_bytes=sum(len(b) for _e, b in bucket.values()))
        return report, ivf
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
        pw.set_monitoring_config(server_endpoint=endpoint)
        recorder._spans_on, recorder._telemetry = spans_on, telemetry


def connectors_phase(tag: str, dev=None, emb=None, docs=None, commits: int = CX_COMMITS):
    """Phase 25: a CDC feed into a live vector index, all through ``import
    pathway_tpu_torch as pw`` and the client-gated connectors over fake
    clients.  Returns (rescore launches on the connectors path, the kernel
    at the phase's shape)."""
    import pathway_tpu_torch as pw

    t_phase = _now()
    dev = dev or torch.device(DEVICE)
    cuda = dev.type == "cuda"
    pw.reset()
    if cuda:
        torch.cuda.empty_cache()
    docs = docs if docs is not None else corpus(N_DOCS)
    emb = emb or _cl_embedder(dev)
    r, ivf = connectors_retrieval(pw, emb, docs, dev, commits)
    lat, cdc = r["latency_ms"], r["cdc_ms"]
    log(
        f"connectors {tag}: {len(docs)} documents in {CX_OBJECTS} JSON-lines objects ({r['bucket_bytes']} bytes, "
        f"etag offsets) through pw.io.s3.read into a full-probe IVF DataIndex (C={r['n_clusters']}) by the "
        f"TpuEmbedder, ingest {r['ingest_s']:.3f} s from pw.run; then {commits} CDC commits on a {CX_PARTITIONS}-"
        f"partition Kafka topic through pw.io.debezium.read ({r['updates']} updates and {r['deletes']} deletes, "
        f"deletes also through a second consumer group's pw.io.kafka.read), each followed by {BATCH} queries "
        f"from a Kafka topic answered as of now (k={K}) out through pw.io.kafka.write and "
        f"pw.io.postgres.write_snapshot, under pw.run's telemetry: the index held the alive count after every "
        f"commit ({r['alive_end']} at the end), every answer (searches per query commit {r['searches']}: a Kafka "
        f"commit may span ticks) == an exact search over the alive documents' "
        f"embeddings on the card rank by rank (ties within 1e-5, scores within {TM_EXACT_TOL}; max diff "
        f"{r['max_err']:.2e}), no deleted document "
        f"returned, none retracted; {r['fresh_first']} of {sum(map(len, r['fresh']))} queries equal to a just-updated "
        f"text found that document first; {r['kafka']} Kafka messages and {r['pg']} Postgres statements == a plain "
        f"loop over the {r['events']} answer events; one pathway.run span with {r['graph']}; CDC commit to "
        f"retrievable " + ", ".join(f"{ms:.3f}" for ms in cdc) + f" ms; retrieve per query commit (first to last "
        f"answer) " + ", ".join(f"{ms:.3f}" for ms in lat) + f" ms, p50 {np.percentile(lat, 50):.3f} p99 "
        f"{np.percentile(lat, 99):.3f} ms; the first commit apart (the first IVF search and query embed) p50 "
        f"{np.percentile(lat[1:], 50):.3f} p99 {np.percentile(lat[1:], 99):.3f} ms; -inf bias slots at the end {r['dead']} of {r['slots']}; IVF "
        f"retrains {r['stats'].get('retrains', 0)}, absorbs {r['stats'].get('absorbs', 0)}; graph build "
        f"{r['build_s']:.3f} s; {r['busy']}; rescore launches {r['launches']}"
    )
    shape = None
    if cuda:
        shape = rescore_at_path_shape(ivf, ivf_search_rescore_args(ivf, r["queries"]), dev)
        log(f"ivf_rescore at the connectors shape {tag}: " + rescore_line(ivf, shape)
            + f"; {r['dead']} -inf bias slots in the slabs; launches {r['launches']}")
    log(f"connectors {tag}: phase 25 {_now() - t_phase:.1f} s")
    pw.reset()
    return r["launches"], shape


# -- phase 26: the sanitized serve, ingest and decode ------------------------------
AN_CALLERS = 16  # closed-loop single-query callers
AN_REQUESTS = 256  # requests of the burst, over AN_QUERIES queries
AN_QUERIES = 64
AN_FRESH = 1024  # fresh documents committed (added, then absorbed) during the burst
AN_COMMIT_AFTER = 64  # answers served before the commit lands
AN_TIES = 32  # of the fresh documents, copies of query texts: their answers change at the commit
AN_SYNC_BATCHES = 32  # scheduler batches under torch.cuda.set_sync_debug_mode("warn"), after a warm-up
AN_TOL = 2e-2  # bf16 trunk: a query's row moves with the batch the scheduler packs it in (phase 23's rule)
AN_TIMEOUT_S = 300.0  # the worker past this is killed and the phase fails
AN_ENV = {
    "PATHWAY_LOCK_SANITIZER": "1", "PATHWAY_LOCK_SANITIZER_RAISE": "1",
    "PATHWAY_DONATION_GUARD": "1", "PATHWAY_DONATION_GUARD_STRICT": "1",
}


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def _pkg_rel(path: str) -> str:
    """``.../pathway_tpu_torch/ops/serving.py`` -> ``pathway_tpu_torch/ops/serving.py``."""
    parts = path.replace(os.sep, "/").split("/")
    if "pathway_tpu_torch" not in parts:
        return path
    return "/".join(parts[len(parts) - 1 - parts[::-1].index("pathway_tpu_torch"):])


def _sync_site() -> tuple:
    """The port's frames on the calling thread's stack, innermost first, as
    ``(module path, function qualname)``: where a sync was made.  Closures
    keep their definer's name, lambdas and generator expressions the
    function they sit in.  A stack without a frame of the port names its
    thread and its frames instead."""
    frame = sys._getframe(1)
    ours, outside = [], []
    while frame is not None:
        name = frame.f_code.co_filename
        if os.sep + "pathway_tpu_torch" + os.sep in name and os.sep + "analysis" + os.sep not in name:
            qual = frame.f_code.co_qualname.replace(".<locals>", "")
            ours.append((_pkg_rel(name), ".".join(q for q in qual.split(".") if not q.startswith("<"))))
        elif not name.endswith(("warnings.py", "chip_smoke.py")):
            outside.append(f"{os.path.basename(name)}:{frame.f_lineno}:{frame.f_code.co_qualname}")
        frame = frame.f_back
    if ours:
        return tuple(ours[:12])
    return ((f"outside the port ({threading.current_thread().name})", " < ".join(outside[:8])),)


def analysis_worker(out_path: str, dev=None, encoder=None, gen=None, n_docs: int = N_DOCS) -> int:
    """Phase 26's interpreter (``--analysis-worker OUT``), started with the
    lock sanitizer and the in-place-write guard armed, both raising: (a)
    serve under a concurrent commit, (b) decode, (c) the sanitizer's
    counts and edges, (d) syncs under the sync debug mode.  Writes its
    report to ``OUT`` as JSON; any failure is a nonzero exit."""
    import warnings

    from pathway_tpu_torch.analysis import sanitizer
    from pathway_tpu_torch.cache import PrefixKVCache
    from pathway_tpu_torch.kernels.build import build_all, build_host
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.ops import decode_rows, dispatch_counter, donation_guard
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.serve import ContinuousDecoder, ServeScheduler

    t_phase = _now()
    dev = dev or torch.device(DEVICE)
    cuda = dev.type == "cuda"
    if not (sanitizer.installed() and donation_guard.enabled() and donation_guard.strict_mode()):
        raise AssertionError("phase 26: the lock sanitizer or the strict in-place-write guard is not armed")
    if cuda:
        build_all()
    build_host("tokenize_hash")
    report = {"locks_at_import": sanitizer.stats()["locks_tracked"]}

    # -- (a) serve under the sanitizer, a commit landing mid-burst ----------------
    encoder = encoder or SentenceEncoder(
        dimension=DIM, n_layers=6, n_heads=6, max_length=128, vocab_size=32768, seed=SEED, dtype=torch.bfloat16,
    )
    docs = corpus(n_docs)
    t0 = _now()
    with torch.no_grad():
        mat = torch.cat([encoder.encode_to_device(docs[i : i + ENCODE_CHUNK]) for i in range(0, n_docs, ENCODE_CHUNK)])
    ivf = IvfKnnIndex(mat.shape[1], metric="cos", device=dev, absorb_threshold=AN_FRESH)
    ivf.build_from_matrix(list(range(n_docs)), mat)
    ivf.n_probe = ivf._centroids.shape[0]
    del mat
    if cuda:
        torch.cuda.synchronize()
    report["setup_s"] = _now() - t0
    qidx = query_ids()
    queries = [docs[qidx[i] % n_docs] for i in range(AN_QUERIES)]
    fresh = [queries[2 * i] for i in range(AN_TIES)] + [
        t + " fresh" for t in corpus(AN_FRESH - AN_TIES, seed=SEED + 26)
    ]
    fresh_keys = list(range(n_docs, n_docs + AN_FRESH))
    with torch.no_grad():
        fresh_vecs = torch.cat(
            [encoder.encode_to_device(fresh[i : i + ENCODE_CHUNK]) for i in range(0, AN_FRESH, ENCODE_CHUNK)]
        ).float().cpu().numpy()
    fused = FusedEncodeSearch(encoder, ivf, k=K)
    before = fused(queries)
    sched = ServeScheduler(fused, name="analysis", result_cache=None)
    answers = {}
    errors = []
    served = threading.Semaphore(0)
    commit = {}

    def caller(c: int) -> None:
        try:
            for j in range(c, AN_REQUESTS, AN_CALLERS):
                q = j % AN_QUERIES
                (row,) = sched.serve([queries[q]])
                answers[j] = (q, [(int(k), float(sc)) for k, sc in row])
                served.release()
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    def committer() -> None:
        try:
            for _ in range(AN_COMMIT_AFTER):
                served.acquire()
            commit["at_answers"] = len(answers)
            t = _now()
            ivf.add(fresh_keys, fresh_vecs)
            commit["add_ms"] = (_now() - t) * 1e3
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    rescore_shortlist.launches = 0
    try:
        threads = [threading.Thread(target=caller, args=(c,), name=f"phase26-caller-{c}") for c in range(AN_CALLERS)]
        threads.append(threading.Thread(target=committer, name="phase26-commit"))
        t_burst = _now()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=AN_TIMEOUT_S)
        report["burst_s"] = _now() - t_burst
        launches_a = rescore_shortlist.launches
        if errors:
            raise errors[0]
        report["absorb_wait_s"] = wait_maintenance(ivf)
        after = fused(queries)
        verdict = {"before": 0, "after": 0, "both": 0}
        bad = []
        for j, (q, got) in sorted(answers.items()):
            b = same_ranking([(int(k), float(sc)) for k, sc in before[q]], got, tie=AN_TOL, atol=AN_TOL)
            a = same_ranking([(int(k), float(sc)) for k, sc in after[q]], got, tie=AN_TOL, atol=AN_TOL)
            verdict["both" if a and b else "before" if b else "after" if a else "neither"] = (
                verdict.get("both" if a and b else "before" if b else "after" if a else "neither", 0) + 1
            )
            if not (a or b):
                bad.append(j)
        if len(answers) != AN_REQUESTS or bad:
            raise AssertionError(f"phase 26 (a): {len(answers)} of {AN_REQUESTS} answers, {len(bad)} equal to neither "
                                 f"the index before the commit nor after it (first {bad[:5]})")
        placed = sum(1 for key in fresh_keys if key in ivf._slot_of_key)
        changed = sum(1 for q in range(AN_QUERIES) if [k for k, _ in before[q]] != [k for k, _ in after[q]])
        if placed + len(ivf._tail) < AN_FRESH or ivf.stats["absorbs"] < 1 or changed == 0:
            raise AssertionError(f"phase 26 (a): absorbs {ivf.stats['absorbs']}, {placed} fresh rows placed, the "
                                 f"commit changed {changed} queries' answers")
        if cuda and launches_a == 0:
            raise AssertionError("phase 26 (a): the sanitized serve launched no rescore kernel")
        st = dict(sched.stats)
    finally:
        sched.stop()
    report.update(
        answers=len(answers), verdict=verdict, commit=commit, placed=placed, changed=changed, sched=st,
        n_clusters=int(ivf._centroids.shape[0]), launches_a=launches_a,
    )

    # -- (b) decode under the sanitizer ---------------------------------------------
    gen = gen or TextGenerator(kv_cache=PrefixKVCache(block=16), eos_id=None, seed=2)  # 256 wide, 4 layers, bf16
    prompts = decode_prompts()
    t0 = _now()
    solo = [gen.generate([p], max_new_tokens=DEC_BUDGET)[0] for p in prompts]
    eng = ContinuousDecoder(gen, slots=DEC_SLOTS, step_bucket=DEC_BUCKET, kv_width=DEC_WIDTH, name="analysis-decode")
    try:
        for name in ("layer_norm_rows", "add_layer_norm_rows", "tied_readout"):
            getattr(decode_rows, name).launches = 0
        tickets = [eng.submit(p, max_new_tokens=DEC_BUDGET) for p in prompts]
        outs = [t.result(timeout=TICKET_TIMEOUT_S) for t in tickets]
        launches_b = {name: getattr(decode_rows, name).launches for name in ("add_layer_norm_rows", "tied_readout")}
    finally:
        eng.stop()
    bad = [i for i, (o, w) in enumerate(zip(outs, solo)) if str(o) != w or getattr(o, "degraded", ())]
    if bad:
        raise AssertionError(f"phase 26 (b): {len(bad)} of {len(prompts)} decode outputs differ from solo generate "
                             f"(first prompt {bad[0]})")
    if cuda and min(launches_b.values()) == 0:
        raise AssertionError(f"phase 26 (b): decode row kernels launched {launches_b}")
    report.update(decode_s=_now() - t0, launches_b=launches_b)

    # the kernels against their plain versions at this phase's shapes
    ln = gen.module.blocks[0].ln_0
    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    x = (torch.randn(DEC_SLOTS, 1, gen.config.d_model, generator=g, device=dev) * 3).to(torch.bfloat16)
    delta = torch.randn(DEC_SLOTS, 1, gen.config.d_model, generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn(DEC_SLOTS, gen.config.d_model, generator=g, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        s_k, y_k = decode_rows.add_layer_norm_rows(x, delta, ln.weight, ln.bias, torch.float32)
        s_p, y_p = decode_rows.add_layer_norm_reference(x, delta, ln.weight, ln.bias, torch.float32)
        ln_err = max(float((s_k.float() - s_p.float()).abs().max()), float((y_k - y_p).abs().max()))
        ro_err = float((decode_rows.tied_readout(h, gen._table) - decode_rows.tied_readout_reference(h, gen._table))
                       .abs().max())
        decode_k = {
            "add_layer_norm_rows": {"max_abs_err": ln_err, "ms": None, "plain_ms": None},
            "tied_readout": {"max_abs_err": ro_err, "ms": None, "plain_ms": None},
        }
        if cuda:
            decode_k["add_layer_norm_rows"].update(
                ms=timed_ms(lambda: decode_rows.add_layer_norm_rows(x, delta, ln.weight, ln.bias, torch.bfloat16), 20),
                plain_ms=timed_ms(
                    lambda: decode_rows.add_layer_norm_reference(x, delta, ln.weight, ln.bias, torch.bfloat16), 20),
            )
            decode_k["tied_readout"].update(
                ms=timed_ms(lambda: decode_rows.tied_readout(h, gen._table), 20),
                plain_ms=timed_ms(lambda: decode_rows.tied_readout_reference(h, gen._table), 20),
            )
    if ln_err > LN_ATOL or ro_err > READOUT_ATOL:
        raise AssertionError(f"phase 26 (b): add_layer_norm_rows err {ln_err}, tied_readout err {ro_err}")
    report["decode_kernels"] = decode_k

    # -- (d) runtime syncs under the sync debug mode ---------------------------------
    sched = ServeScheduler(fused, name="analysis-sync", result_cache=None)
    batches = [[docs[(i * 7919 + j * 131) % n_docs] for j in range(BATCH)] for i in range(AN_SYNC_BATCHES + 4)]
    syncs = {}
    try:
        for texts in batches[:4]:  # warm-up: first-call work stays out of the count
            sched.serve(texts)
        if cuda:
            torch.cuda.synchronize()
        counter = dispatch_counter.install()
        n0 = sched.stats.get("batches", 0)

        def on_warning(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" in str(message):
                site = _sync_site()
                syncs[site] = syncs.get(site, 0) + 1

        # the mode does not report a host wait on a CUDA event or stream (the
        # fetch of device.to_host): those waits are recorded beside it
        waited = {}
        waits = [(torch.cuda.Event, "synchronize"), (torch.cuda.Stream, "synchronize"), (torch.cuda, "synchronize")]
        saved = [getattr(owner, attr) for owner, attr in waits]

        def recording(orig):
            def wait(*a, **kw):
                site = _sync_site()
                waited[site] = waited.get(site, 0) + 1
                return orig(*a, **kw)
            return wait

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            for (owner, attr), orig in zip(waits, saved):
                setattr(owner, attr, recording(orig))
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                for texts in batches[4:]:
                    sched.serve(texts)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
                for (owner, attr), orig in zip(waits, saved):
                    setattr(owner, attr, orig)
        n_batches = sched.stats.get("batches", 0) - n0
        dispatches, fetches = counter.snapshot()
        dispatch_counter.uninstall()
    finally:
        sched.stop()
    report["sync"] = {
        "batches": n_batches, "dispatches_booked": dispatches, "fetches_booked": fetches,
        "sites": [[list(map(list, site)), n] for site, n in sorted(syncs.items(), key=lambda kv: str(kv[0]))],
        "waits": [[list(map(list, site)), n] for site, n in sorted(waited.items(), key=lambda kv: str(kv[0]))],
    }

    # -- (c) the sanitizer's counts and edges, the guard's violations ---------------
    report["sanitizer"] = sanitizer.stats()
    report["edges"] = sanitizer.edges()
    report["donation"] = donation_guard.stats()
    report["worker_s"] = _now() - t_phase
    with open(out_path, "w") as fh:
        json.dump(report, fh)

    # the rescore kernel at (a)'s shape, against its plain version (after the counts)
    report["shape"], report["shape_line"] = None, "not measured (CPU)"
    if cuda:
        b = max(1, min(BATCH, round(st.get("items_dispatched", AN_REQUESTS) / max(st.get("batches", 1), 1))))
        qv = np.asarray(encoder.encode(queries[:b]), dtype=np.float32)
        report["shape"] = rescore_at_path_shape(ivf, ivf_search_rescore_args(ivf, qv), dev)
        report["shape_line"] = rescore_line(ivf, report["shape"])
    report["worker_s"] = _now() - t_phase
    with open(out_path, "w") as fh:
        json.dump(report, fh)
    return 0


def _an_static(out: dict) -> None:
    """The port's static lock graph and hidden-sync fetch scopes, for phase
    26's runtime-vs-static checks (run beside the worker)."""
    try:
        import pathway_tpu_torch
        from pathway_tpu_torch.analysis.hidden_sync import fetch_scopes
        from pathway_tpu_torch.analysis.lock_order import static_graph

        pkg = os.path.dirname(os.path.abspath(pathway_tpu_torch.__file__))
        t0 = _now()
        out["graph"] = static_graph([pkg])
        out["scopes"] = {(_pkg_rel(p), q): kind for (p, q), kind in fetch_scopes([pkg]).items()}
        out["static_s"] = _now() - t0
    except BaseException as exc:  # noqa: BLE001 - re-raised by the phase
        out["error"] = exc


def analysis_phase(tag: str):
    """Phase 26: serve, ingest and decode in a fresh interpreter with the
    runtime lock-order sanitizer and the in-place-write guard armed, both
    raising; the sanitizer's runtime edges against the static lock graph,
    the syncs the sync debug mode reports against the hidden-sync rule's
    fetch scopes.  Returns (launches by kernel, the rescore kernel at the
    phase's shape, the decode kernels' records)."""
    import tempfile

    t_phase = _now()
    static = {}
    th = threading.Thread(target=_an_static, args=(static,), name="phase26-static")
    th.start()
    env = dict(os.environ, **AN_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "analysis.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--analysis-worker", out_path], env=env,
            capture_output=True, text=True, timeout=AN_TIMEOUT_S,
        )
        for line in proc.stdout.splitlines():
            print(line, flush=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-8000:])
            raise AssertionError(f"phase 26: the sanitized worker exited {proc.returncode}")
        with open(out_path) as fh:
            r = json.load(fh)
    th.join()
    if "error" in static:
        raise static["error"]
    out = analysis_checks(r, static, tag)
    log(f"analysis {tag}: phase 26 {_now() - t_phase:.1f} s (worker {r['worker_s']:.1f} s, static analysis "
        f"{static['static_s']:.1f} s beside it)")
    return out


def analysis_checks(r: dict, static: dict, tag: str):
    """Phase 26's checks and lines over the worker's report ``r`` and the
    static side ``static`` (``_an_static``)."""
    from pathway_tpu_torch.analysis.lock_order import runtime_edge_report

    san, don = r["sanitizer"], r["donation"]
    vio = san["violations"]
    if any(vio.values()) or san["locks_tracked"] <= 0 or san["edges_observed"] <= 0 or don["violations"]:
        raise AssertionError(f"phase 26 (c): sanitizer {san}, in-place-write guard violations {don['violations']}")
    edges = [tuple(e) for e in r["edges"]]
    rep = runtime_edge_report(edges, static["graph"])
    if rep["inconsistent"]:
        raise AssertionError(f"phase 26 (c): runtime edges against the rank table: {rep['inconsistent']}")
    scopes = static["scopes"]

    def attributed(entries):
        """Each sync to the innermost frame of its stack that the lint lists
        as a fetch scope: ``(path, qual, n, how the lint counts it)``."""
        out = []
        for frames, n in entries:
            hit = next(((p, q) for p, q in frames if (p, q) in scopes), None)
            p, q = hit or tuple(frames[0])
            out.append((p, q, n, scopes.get(hit, "unknown to the lint")))
        return out

    sy = r["sync"]
    sites, waits = attributed(sy["sites"]), attributed(sy["waits"])
    unknown = [e for e in sites + waits if e[3] not in ("booked", "waived")]
    v = r["verdict"]
    n_sync, n_wait = sum(e[2] for e in sites), sum(e[2] for e in waits)
    log(
        f"analysis (a) {tag}: under PATHWAY_LOCK_SANITIZER=1 and PATHWAY_DONATION_GUARD=1 (both raising), "
        f"{N_DOCS} documents encoded into a full-probe IVF (C={r['n_clusters']}) in {r['setup_s']:.3f} s; "
        f"{AN_CALLERS} closed-loop callers sent {r['answers']} single-query requests over {AN_QUERIES} queries to a "
        f"ServeScheduler over FusedEncodeSearch (k={K}) in {r['burst_s']:.3f} s while a second thread committed "
        f"{AN_FRESH} fresh documents after answer {r['commit'].get('at_answers')} (add {r['commit'].get('add_ms', 0):.3f} ms; "
        f"absorbed, {r['placed']} placed, {r['absorb_wait_s']:.3f} s waited after the burst): every answer == a direct "
        f"search of its query (keys up to ties, scores within {AN_TOL}) against the index before the commit "
        f"({v.get('before', 0)} only), after it ({v.get('after', 0)} only) or both ({v.get('both', 0)}); the commit "
        f"changed {r['changed']} of {AN_QUERIES} queries' answers; scheduler {r['sched'].get('batches')} batches; "
        f"rescore launches {r['launches_a']}"
    )
    dk = r["decode_kernels"]
    log(
        f"analysis (b) {tag}: a ContinuousDecoder burst of {len(decode_prompts())} greedy prompts ({DEC_BUDGET} tokens) "
        f"on the default TextGenerator == solo generate, prompt for prompt, in {r['decode_s']:.3f} s; launches "
        f"{r['launches_b']}; add_layer_norm_rows at [{DEC_SLOTS}, 1, 256] bf16 err {dk['add_layer_norm_rows']['max_abs_err']:.2e} "
        f"kernel {_ms(dk['add_layer_norm_rows']['ms'])} plain {_ms(dk['add_layer_norm_rows']['plain_ms'])}; "
        f"tied_readout at M={DEC_SLOTS} err {dk['tied_readout']['max_abs_err']:.2e} kernel "
        f"{_ms(dk['tied_readout']['ms'])} plain {_ms(dk['tied_readout']['plain_ms'])} (20 calls between CUDA events)"
    )
    log(
        f"analysis (c) {tag}: violations {vio}; locks tracked {san['locks_tracked']} ({r['locks_at_import']} at "
        f"import), runtime edges {len(edges)}, every one rank-consistent; the static graph "
        f"({len(static['graph']['edges'])} edges, {len(static['graph']['sites'])} sites, {static['static_s']:.1f} s) "
        f"lacks {len(rep['missing'])}: {rep['missing']}; in-place-write guard: violations {don['violations']}, "
        f"writes {don['written']}"
    )
    log(
        f"analysis (d) {tag}: {sy['batches']} scheduler batches under torch.cuda.set_sync_debug_mode(\"warn\"): "
        f"{n_sync} syncs reported ({n_sync / max(sy['batches'], 1):.2f} per batch) and {n_wait} host waits on CUDA "
        f"events or streams ({n_wait / max(sy['batches'], 1):.2f} per batch) beside {sy['fetches_booked']} fetches "
        f"and {sy['dispatches_booked']} dispatches booked by ops/dispatch_counter.py "
        f"({sy['fetches_booked'] / max(sy['batches'], 1):.2f} fetches per batch); sync sites: "
        + ("; ".join(f"{p}:{q} x{n} ({how})" for p, q, n, how in sites) or "none") + "; wait sites: "
        + ("; ".join(f"{p}:{q} x{n} ({how})" for p, q, n, how in waits) or "none")
    )
    if unknown:
        raise AssertionError(f"phase 26 (d): syncs outside every fetch scope the hidden-sync rule books or waives: "
                             f"{unknown}")
    log(f"ivf_rescore at the analysis shape {tag}: " + r["shape_line"] + f"; launches {r['launches_a']}")
    return {"ivf_rescore": r["launches_a"], **r["launches_b"]}, r["shape"], dk


# -- phase 27: the native host runtime, then a CSV-fed index --------------------------
NV_FILES = 16  # (a): the N_DOCS documents as CSV files of N_DOCS / 16 rows each
NV_CRLF_FILE = 3  # this file's lines end in "\r\n", the others' in "\n"
NV_INDEX_FILES = 4  # (b): the first 4 files (16,384 documents) feed the index
NV_COMMITS = 4  # (b): query commits of BATCH through pw.io.python
NV_COMMIT_MS = 10  # the engine's commit tick while (b) runs
NV_FRAME_BYTES = 256 << 20  # (a): the framing blob, in warmstate.chunk_bytes chunks
NV_EVENTS = 65_536  # (a): frames of one persisted event's payload each
NV_TOL = 1e-4  # phase 19's: scores within 1e-4, keys free only between scores tied within 1e-5
NV_TURNS = ("native", "plain", "plain", "native")


def _nv_files(docs, n_files: int = NV_FILES):
    """The documents as CSV files (bytes) of ``doc_id,text,score``: every
    5th text holds a comma, every 7th doubled quotes, every 11th a
    newline; file ``NV_CRLF_FILE`` ends its lines in ``\\r\\n``."""
    import csv

    scores = np.random.default_rng(SEED + 27).standard_normal(len(docs))
    per = len(docs) // n_files
    files = []
    for f in range(n_files):
        out = io.StringIO()
        writer = csv.writer(out, lineterminator="\r\n" if f == NV_CRLF_FILE else "\n")
        writer.writerow(["doc_id", "text", "score"])
        for i in range(f * per, (f + 1) * per):
            text = docs[i]
            if i % 5 == 0:
                text = text.replace(" ", ", ", 1)
            if i % 7 == 0:
                text += ' "quoted"'
            if i % 11 == 0:
                text = text.replace(" ", "\n", 1)
            writer.writerow([i, text, repr(float(scores[i]))])
        files.append(out.getvalue().encode())
    return files


def _nv_csv_module_rows(data: bytes):
    """What ``pw.io.fs`` read a plain CSV file into before the native
    scanner: the decoded file through ``csv.reader``, blank lines
    skipped."""
    import csv

    return [row for row in csv.reader(io.StringIO(data.decode("utf-8", errors="replace"), newline="")) if row]


def _nv_turns(fns: dict):
    """Host seconds of each version in the turns ``NV_TURNS``, each turn
    after a full garbage collection, and each version's result of its
    first turn."""
    import gc

    times, results = {name: [] for name in fns}, {}
    for name in NV_TURNS:
        gc.collect()
        t0 = time.perf_counter()
        out = fns[name]()
        times[name].append(time.perf_counter() - t0)
        results.setdefault(name, out)
        del out
    return times, results


def _nv_line(what: str, times: dict) -> str:
    return f"{what}: native " + " / ".join(f"{s:.4f}" for s in times["native"]) + " s, plain " + " / ".join(
        f"{s:.4f}" for s in times["plain"]) + " s"


def native_host(docs, frame_bytes: int = NV_FRAME_BYTES, n_events: int = NV_EVENTS):
    """Phase 27 (a): the native host runtime against its plain versions on
    this host, in turns native, plain, plain, native; every native result
    must equal the plain one.  Returns ``(lines, seconds by measurement,
    the CSV files)``."""
    import pickle
    import struct
    import zlib

    from pathway_tpu_torch import config as port_config
    from pathway_tpu_torch import native
    from pathway_tpu_torch.native import fallback
    from pathway_tpu_torch.persistence.framing import frame, frame_all, scan, scan_views

    if not native.available():
        raise AssertionError("phase 27: the native library is disabled")
    files = _nv_files(docs)
    lines, secs = [], {}

    def check(what, results, same=None):
        same = same or (lambda a, b: a == b)
        if not same(results["native"], results["plain"]):
            raise AssertionError(f"phase 27 (a): {what}: the native result differs from the plain one")

    # CSV: native.csv_rows against the csv module, over the 16 files
    times, res = _nv_turns({"native": lambda: [native.csv_rows(b) for b in files],
                            "plain": lambda: [_nv_csv_module_rows(b) for b in files]})
    check("csv_rows", res)
    n_rows = sum(len(rows) - 1 for rows in res["native"])
    if n_rows != len(docs):
        raise AssertionError(f"phase 27 (a): {n_rows} rows read back from the CSV files of {len(docs)} documents")
    secs["csv_rows"] = times
    lines.append(_nv_line(f"csv_rows against the csv module, {len(files)} files, {n_rows} rows, "
                          f"{sum(map(len, files))} bytes", times))

    # typed parse of the id and score cells
    cells = {"id": [], "score": []}
    for b in files:
        rcs, off, ln, _q = native.csv_scan(b)
        first = rcs[1:-1]  # each data row's first cell (the header row apart)
        cells["id"].append((b, off[first], ln[first]))
        cells["score"].append((b, off[first + 2], ln[first + 2]))
    for fn, col in (("parse_int64", "id"), ("parse_float64", "score")):
        times, res = _nv_turns({
            "native": lambda fn=fn, col=col: [getattr(native, fn)(*c) for c in cells[col]],
            "plain": lambda fn=fn, col=col: [getattr(fallback, fn)(*c) for c in cells[col]],
        })
        check(fn, res, lambda a, b: all(np.array_equal(x[1], y[1]) and np.array_equal(x[0].view(np.int64),
                                                                                     y[0].view(np.int64))
                                        for x, y in zip(a, b)))
        if not all(bool(ok.all()) for _v, ok in res["native"]):
            raise AssertionError(f"phase 27 (a): {fn} refused a cell of the {col} column")
        secs[fn] = times
        lines.append(_nv_line(f"{fn} over the {sum(len(c[1]) for c in cells[col])} {col} cells", times))

    # framing: a warm-state blob of chunk_bytes frames
    chunk = port_config.get("warmstate.chunk_bytes")
    payload = np.random.default_rng(SEED + 28).bytes(frame_bytes)
    view = memoryview(payload)
    chunks = [view[o : o + chunk] for o in range(0, frame_bytes, chunk)]
    blob = frame_all(chunks)
    times, res = _nv_turns({"native": lambda: native.crc32(blob), "plain": lambda: zlib.crc32(blob)})
    check("crc32", res)
    secs["crc32"] = times
    lines.append(_nv_line(f"crc32 of a {len(blob)}-byte blob", times))

    def native_views():
        offs, lens, consumed = native.frame_scan(blob)
        bview = memoryview(blob)
        return [bview[o : o + n] for o, n in zip(offs.tolist(), lens.tolist())], consumed == len(blob)

    times, res = _nv_turns({"native": native_views, "plain": lambda: scan_views(blob)})
    check("frame_scan", res, lambda a, b: a[1] and b[1] and len(a[0]) == len(b[0]) == len(chunks)
          and all(x == y for x, y in zip(a[0], b[0])))
    secs["frame_scan"] = times
    lines.append(_nv_line(f"frame_scan (walk and CRCs, then views) against scan_views (CRCs on up to 8 threads), "
                          f"{len(chunks)} frames of {chunk} bytes", times))

    def native_frame(p):
        return struct.pack("<II", len(p), native.crc32(p)) + p

    times, res = _nv_turns({"native": lambda: b"".join(native_frame(c) for c in chunks),
                            "plain": lambda: b"".join(frame(c) for c in chunks)})
    check("frame of chunks", res)
    secs["frame_chunks"] = times
    lines.append(_nv_line(f"frame of the {len(chunks)} chunks (native.crc32 against zlib.crc32)", times))
    del blob, res, chunks, view, payload

    # framing: a persisted source's log, one frame per event
    events = [pickle.dumps((1, i, (f"row{i}",)), protocol=pickle.HIGHEST_PROTOCOL) for i in range(n_events)]
    times, res = _nv_turns({"native": lambda: b"".join(native_frame(p) for p in events),
                            "plain": lambda: b"".join(frame(p) for p in events)})
    check("frame of events", res)
    secs["frame_events"] = times
    log_blob = res["plain"]
    lines.append(_nv_line(f"frame of {n_events} events of {sum(map(len, events)) // n_events} bytes", times))
    times, res = _nv_turns({"native": lambda: scan(log_blob),
                            "plain": lambda: ([v.tobytes() for v in scan_views(log_blob)[0]], True)})
    check("scan of events", res)
    if res["native"][0] != events:
        raise AssertionError("phase 27 (a): the events did not come back from their frames")
    secs["scan_events"] = times
    lines.append(_nv_line(f"framing.scan (native.frame_scan) against scan_views + copies, {n_events} event frames",
                          times))
    return lines, secs, files


def native_index(pw, emb, files, dev, commits: int = NV_COMMITS):
    """Phase 27 (b): the first ``NV_INDEX_FILES`` CSV files through
    ``pw.io.fs.read`` into a full-probe IVF ``DataIndex`` by the embedder,
    then ``commits`` query commits of BATCH through ``pw.io.python``.
    Returns the report."""
    import tempfile

    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist

    cuda = dev.type == "cuda"
    files = files[:NV_INDEX_FILES]
    want_rows = sorted((int(r[0]), r[1], float(r[2])) for b in files for r in _nv_csv_module_rows(b)[1:])
    texts = {d: t for d, t, _s in want_rows}
    doc_ids = sorted(texts)
    qidx = query_ids()
    queries = [texts[doc_ids[qidx[i] % len(doc_ids)]] for i in range(commits * BATCH)]
    driver = _FrameworkDriver("phase 27")
    report = {"latency_ms": [], "searches_of": []}
    with tempfile.TemporaryDirectory(prefix="native-csv-") as folder:
        for f, b in enumerate(files):
            with open(os.path.join(folder, f"part{f:02d}.csv"), "wb") as out:
                out.write(b)

        class Doc(pw.Schema):
            doc_id: int = pw.column_definition(primary_key=True)
            text: str
            score: float

        class Query(pw.Schema):
            qid: int = pw.column_definition(primary_key=True)
            query: str

        t_build = _now()
        docs_t = pw.io.fs.read(folder, format="csv", schema=Doc, mode="static", name="native_csv")
        vecs = docs_t.select(pw.this.doc_id, vec=emb(pw.this.text),
                             meta=pw.apply(lambda d: {"doc": int(d)}, pw.this.doc_id))
        mod = pw.stdlib.indexing
        dim = emb.get_embedding_dimension()
        index = mod.DataIndex(vecs, mod.InnerIndex(
            data_column=vecs.vec, metadata_column=vecs.meta, dimension=dim,
            factory=mod.IvfKnnFactory(dimension=dim, n_probe=1 << 30, device=None if cuda else dev),
        ))
        subject, query_q = _queue_subject(pw, "queries", driver)
        qs = pw.io.python.read(subject, schema=Query, atomic_batches=True, name="native_queries")
        qs = qs.select(pw.this.qid, qvec=emb(pw.this.query))
        res = index.query_as_of_now(qs.qvec, number_of_matches=K)
        answers = res.select(qid=qs.qid, docs=vecs.doc_id, scores=res.score).select(
            pw.this.qid, docs=pw.apply(lambda ds: tuple(int(d) for d in ds), pw.this.docs),
            scores=pw.apply(lambda ss: tuple(float(s) for s in ss), pw.this.scores))
        pw.io.subscribe(answers, on_change=driver.on_change("answers"), on_time_end=driver.on_tick)
        (op,) = [o for o in pw.G.engine_graph.operators if isinstance(o, ExternalIndexOperator)]
        inner, ivf = op.index, op.index.index
        vec_of_key, doc_of_key, searches = {}, {}, []
        orig_add, orig_search = inner.add, inner.search

        def add(keys, values, metadatas):
            orig_add(keys, values, metadatas)
            with driver.cond:
                for key, value, md in zip(keys, values, metadatas):
                    doc_of_key[int(key)] = int(getattr(md, "value", md)["doc"])
                    vec_of_key[int(key)] = np.asarray(value, np.float32)
                driver.cond.notify_all()

        def search(values, k, filters):
            out = orig_search(values, k, filters)
            searches.append((np.stack([np.asarray(v, np.float32) for v in values]), k, out))
            return out

        inner.add, inner.search = add, search
        report["build_s"] = _now() - t_build

        def drive():
            driver.wait(lambda: len(doc_of_key) >= len(want_rows), "the CSV documents in the index")
            report["ingest_s"] = _now() - report["t_run"]
            for c in range(commits):
                n_before = len(searches)
                query_q.put([{"qid": c * BATCH + b, "query": queries[c * BATCH + b]} for b in range(BATCH)])
                driver.wait(lambda: len(driver.answers.get("answers", {})) >= (c + 1) * BATCH
                            and len(driver.commit_at.get("queries", ())) > c, f"the answers of query commit {c}")
                last = max(t for t, _k, _d in driver.arrival["answers"])
                report["latency_ms"].append((last - driver.commit_at["queries"][c]) * 1e3)
                report["searches_of"].append(list(range(n_before, len(searches))))

        def run_driver():
            try:
                drive()
            except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread after the run
                report["error"] = exc
            finally:
                query_q.put(None)

        rescore_shortlist.launches = 0
        thread = threading.Thread(target=run_driver, daemon=True, name="phase27-driver")
        report["t_run"] = t_run = _now()
        thread.start()
        try:
            pw.run(commit_duration_ms=NV_COMMIT_MS)
        finally:
            driver.stop = True
            thread.join(timeout=60)
        if cuda:
            torch.cuda.synchronize()
        report["run_s"] = _now() - t_run
        report["launches"] = rescore_shortlist.launches
        if "error" in report:
            raise report["error"]

    # -- checks ---------------------------------------------------------------------
    _keys, cols = docs_t._materialize()
    got_rows = sorted((int(d), str(t), float(s)) for d, t, s in zip(cols["doc_id"], cols["text"], cols["score"]))
    if got_rows != want_rows:
        raise AssertionError(f"phase 27 (b): the engine read {len(got_rows)} rows, the csv module "
                             f"{len(want_rows)}; {sum(a != b for a, b in zip(got_rows, want_rows))} differ")
    if len(ivf) != len(want_rows):
        raise AssertionError(f"phase 27 (b): the index holds {len(ivf)} rows, the files {len(want_rows)}")
    keys = sorted(vec_of_key)
    bad = 0
    max_err = 0.0
    answered = {}
    for evs in driver.answers["answers"].values():
        for _t, row, diff in evs:
            if diff > 0:
                answered[int(row["qid"])] = tuple(row["docs"])
    for c in range(commits):
        if not report["searches_of"][c]:
            raise AssertionError(f"phase 27 (b): query commit {c} searched no time")
        rows = []
        for si in report["searches_of"][c]:
            qv, k, part = searches[si]
            exact = _tm_exact(vec_of_key, keys, qv, k, dev)
            for got, ref in zip(part, exact):
                got = [(int(key), float(score)) for key, score in got]
                bad += not same_ranking(ref, got, tie=1e-5, atol=NV_TOL)
                max_err = max([max_err] + [abs(a[1] - b[1]) for a, b in zip(ref, got)])
            rows.extend(part)
        mine = sorted(answered[q] for q in answered if q // BATCH == c)
        if mine != sorted(tuple(doc_of_key[int(key)] for key, _s in r) for r in rows):
            raise AssertionError(f"phase 27 (b): commit {c}'s answers differ from its index's search")
    retracted = sum(1 for evs in driver.answers["answers"].values() for e in evs if e[2] < 0)
    if bad or retracted or len(answered) != commits * BATCH:
        raise AssertionError(f"phase 27 (b): {bad} answers differ from the exact search over the documents' "
                             f"embeddings, {retracted} retracted, {len(answered)} of {commits * BATCH} answered")
    first = sum(1 for q, docs_ in answered.items() if docs_ and texts[docs_[0]] == queries[q])
    off = _cl_tensors_on(ivf, "cuda") if cuda else []
    if cuda and (report["launches"] == 0 or off):
        raise AssertionError(f"phase 27 (b): {report['launches']} rescore launches, index tensors off the card: {off}")
    report.update(max_err=max_err, rows=len(got_rows), first=first, n_clusters=int(ivf._centroids.shape[0]),
                  searches=[len(of) for of in report["searches_of"]],
                  queries=np.concatenate([searches[si][0] for si in report["searches_of"][-1]]))
    return report, ivf


def native_phase(tag: str, dev=None, emb=None, docs=None, frame_bytes: int = NV_FRAME_BYTES,
                 n_events: int = NV_EVENTS, commits: int = NV_COMMITS):
    """Phase 27: the native host runtime on this host (a), then a CSV-fed
    index on the card (b).  Returns (rescore launches on the CSV path, the
    kernel at the phase's shape, the host seconds of (a))."""
    import pathway_tpu_torch as pw

    t_phase = _now()
    dev = dev or torch.device(DEVICE)
    cuda = dev.type == "cuda"
    docs = docs if docs is not None else corpus(N_DOCS)
    lines, secs, files = native_host(docs, frame_bytes, n_events)
    for line in lines:
        log(f"native host (a) on this host ({os.cpu_count()} cores) {tag}: {line}")
    pw.reset()
    if cuda:
        torch.cuda.empty_cache()
    emb = emb or _cl_embedder(dev)
    r, ivf = native_index(pw, emb, files, dev, commits)
    lat = r["latency_ms"]
    log(
        f"native csv index (b) {tag}: {r['rows']} documents in {NV_INDEX_FILES} CSV files (one with CRLF endings; "
        f"quoted commas, doubled quotes and newlines) through pw.io.fs.read == the csv module's rows; the TpuEmbedder into a full-probe IVF DataIndex (C={r['n_clusters']}), ingest {r['ingest_s']:.3f} s "
        f"from pw.run; {commits} query commits of {BATCH} through pw.io.python (k={K}, {NV_COMMIT_MS} ms tick): every "
        f"answer == an exact search over the documents' embeddings (ties within 1e-5, scores within {NV_TOL}; max "
        f"diff {r['max_err']:.2e}; searches per commit {r['searches']}), {r['first']} of {commits * BATCH} found "
        f"their own document first; commit to the last answer " + ", ".join(f"{ms:.3f}" for ms in lat)
        + f" ms; graph build {r['build_s']:.3f} s, run {r['run_s']:.3f} s; rescore launches {r['launches']}"
    )
    shape = None
    if cuda:
        shape = rescore_at_path_shape(ivf, ivf_search_rescore_args(ivf, r["queries"]), dev)
        log(f"ivf_rescore at the native csv shape {tag}: " + rescore_line(ivf, shape) + f"; launches {r['launches']}")
    log(f"native {tag}: phase 27 {_now() - t_phase:.1f} s")
    pw.reset()
    return r["launches"], shape, secs


# -- phase 28: the reference's public surface on the card ------------------------------
SU_ALLOW = 1_000  # keys in each filtered query's allow-list
SU_REMOVE = 64  # returned keys removed, then searched for again
SU_CALLERS = 16
SU_REQUESTS = 64
SU_DECODE = (4, 8)  # the decoder burst: prompts x new tokens


def surface_filtered(exact, queries: np.ndarray, keys, rng) -> dict:
    """Phase 28 (a): filtered exact search over ``exact``.  Half the
    queries get an allow-list of ``SU_ALLOW`` keys holding their
    unfiltered top 5, half ``None``; each row must equal the unfiltered
    top-k filtered by its list, scores bit for bit (the same scores, one
    filter after).  Then ``SU_REMOVE`` of the returned keys are removed:
    none comes back, filtered or not; put back, they answer as before
    (scores within 1e-5: a row is normalized again as it is added)."""
    plain = exact.search(queries, K)
    allow = []
    for qi, row in enumerate(plain):
        if qi % 2:
            allow.append(None)
            continue
        picked = [key for key, _ in row[:5]]
        for i in rng.choice(len(keys), size=2 * SU_ALLOW, replace=False):
            if len(picked) == SU_ALLOW:
                break
            if int(keys[i]) not in picked:
                picked.append(int(keys[i]))
        allow.append(picked)
    t = _now()
    got = exact.search(queries, K, candidate_keys=allow)
    ms = (_now() - t) * 1e3
    short = 0
    for qi, row in enumerate(got):
        allowed = None if allow[qi] is None else set(allow[qi])
        want = [kv for kv in plain[qi] if allowed is None or kv[0] in allowed]
        if row != want:
            raise AssertionError(f"phase 28 (a): query {qi}'s filtered row {row[:3]} != the unfiltered top {K} "
                                 f"filtered by its list {want[:3]}")
        if allowed is not None and len(row) < 5:
            raise AssertionError(f"phase 28 (a): query {qi} lost keys of its unfiltered top 5 that its list holds")
        short += len(row) < K
    gone = list(dict.fromkeys(key for row in got for key, _ in row))[:SU_REMOVE]
    vecs = exact._matrix[torch.tensor([exact.key_to_slot[key] for key in gone], device=exact._matrix.device)].clone()
    exact.remove(gone)
    try:
        back = [exact.search(queries, K, candidate_keys=allow), exact.search(queries, K)]
        seen = {key for rows in back for row in rows for key, _ in row} & set(gone)
        if seen or any(len(row) != K for row in back[1]):
            raise AssertionError(f"phase 28 (a): removed keys came back: {sorted(seen)[:5]}")
    finally:
        exact.add_from_device(gone, vecs)
    restored = exact.search(queries, K)
    if not all(same_ranking(w, g, tie=1e-5, atol=1e-5) for w, g in zip(plain, restored)):
        raise AssertionError("phase 28 (a): the index answers otherwise after the removed rows were put back")
    return {"ms": ms, "short": short, "filtered": sum(a is not None for a in allow), "removed": len(gone)}


def _sf_fetch(port: int, route: str, accept=None):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", headers={"Accept": accept} if accept else {})
    t = _now()
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = resp.read().decode()
        return body, resp.headers["Content-Type"], (_now() - t) * 1e3


def surface_scrape(encoder, ivf, docs, dev, gen=None) -> dict:
    """Phase 28 (b): ``ServeScheduler`` over ``FusedEncodeSearch`` on the
    IVF index serves ``SU_REQUESTS`` requests from ``SU_CALLERS`` callers
    with every request traced, plus one with an expired deadline (kept by
    the tail sampler), then a ``ContinuousDecoder`` burst; ``GET
    /metrics`` in both formats, ``/serve_stats`` and ``/slo`` from
    ``start_metrics_server``."""
    from pathway_tpu_torch import observe
    from pathway_tpu_torch.internals.metrics import start_metrics_server
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.observe import slo, trace
    from pathway_tpu_torch.ops import decode_rows
    from pathway_tpu_torch.ops.ivf_rescore import rescore_shortlist
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.robust.deadline import Deadline
    from pathway_tpu_torch.serve import ContinuousDecoder, ServeScheduler

    observe.reset()  # exemplars of earlier phases name traces this phase's store no longer keeps
    trace.reset()
    trace.set_sample(1.0)
    serve = FusedEncodeSearch(encoder, ivf, k=K)
    texts = [docs[j] for j in query_ids()[:SU_REQUESTS]]
    want = serve(texts)
    out: list = [None] * SU_REQUESTS
    rescore_shortlist.launches = 0
    t = _now()
    with ServeScheduler(serve, result_cache=None, name="smoke-surface") as sched:
        def caller(c: int) -> None:
            for i in range(c, SU_REQUESTS, SU_CALLERS):
                out[i] = sched.serve([texts[i]])

        threads = [threading.Thread(target=caller, args=(c,)) for c in range(SU_CALLERS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        late = sched.serve([texts[0]], deadline=Deadline(0.0))
    serve_s = _now() - t
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = rescore_shortlist.launches
    bad = sum(not (r is not None and len(r) == 1 and same_ranking(w, list(r[0]), tie=SCHED_TOL, atol=SCHED_TOL))
              for r, w in zip(out, want))
    if bad or not late.degraded:
        raise AssertionError(f"phase 28 (b): {bad} of {SU_REQUESTS} scheduled serves differ from the direct serve "
                             f"(tolerance {SCHED_TOL}); the expired request degraded {late.degraded}")
    t_dec = _now()
    gen = gen or TextGenerator(device=dev, kv_cache=None, eos_id=None)
    n_prompts, n_new = SU_DECODE
    prompts = [docs[i] for i in range(n_prompts)]
    for name in ("add_layer_norm_rows", "layer_norm_rows", "tied_readout"):
        getattr(decode_rows, name).launches = 0
    with ContinuousDecoder(gen, slots=n_prompts, name="smoke-surface-decode") as eng:
        answers = eng.generate(prompts, max_new_tokens=n_new)
        decode_s = _now() - t_dec
        decode_launches = {"add_layer_norm_rows": decode_rows.add_layer_norm_rows.launches
                           + decode_rows.layer_norm_rows.launches, "tied_readout": decode_rows.tied_readout.launches}
        server = start_metrics_server(G.engine_graph, port=0)
        try:
            classic, classic_type, classic_ms = _sf_fetch(server.port, "/metrics")
            om, om_type, om_ms = _sf_fetch(server.port, "/metrics", "application/openmetrics-text")
            stats = json.loads(_sf_fetch(server.port, "/serve_stats")[0])
            slo_doc = json.loads(_sf_fetch(server.port, "/slo")[0])
        finally:
            server.stop()
    solo = [gen.generate([p], max_new_tokens=n_new)[0] for p in prompts]
    bad = [i for i, (a, w) in enumerate(zip(answers, solo)) if str(a) != w or getattr(a, "degraded", ())]
    if len(answers) != n_prompts or bad:
        raise AssertionError(f"phase 28 (b): {len(bad)} of {n_prompts} decoder burst answers differ from solo "
                             f"generate: {answers!r}")
    if "version=0.0.4" not in classic_type or "# {" in classic:
        raise AssertionError(f"phase 28 (b): the classic scrape ({classic_type}) carries an exemplar token")
    if "openmetrics-text" not in om_type or not om.rstrip().endswith("# EOF"):
        raise AssertionError(f"phase 28 (b): the OpenMetrics scrape is {om_type}, ends {om.rstrip()[-20:]!r}")
    ex_lines = [line for line in om.split("\n") if " # {" in line]
    ids = [line.split('trace_id="', 1)[1].split('"', 1)[0] for line in ex_lines]
    off_bucket = [line for line in ex_lines if "_bucket{" not in line.split(" ", 1)[0]]
    unkept = sorted({tid for tid in ids if trace.get_trace(tid) is None})
    if not ex_lines or off_bucket or unkept:
        raise AssertionError(f"phase 28 (b): {len(ex_lines)} exemplars, {len(off_bucket)} off bucket samples, "
                             f"trace ids no kept trace holds: {unkept[:5]}")
    gens = stats.get("generators", {}).get("smoke-surface-decode", {})
    tokens = gens.get('pathway_generator_tokens_total{phase="decode"}', 0)
    if not gens or tokens <= 0 or set(stats.get("slo", {}).get("slos", ())) != set(slo_doc.get("slos", ())):
        raise AssertionError(f"phase 28 (b): /serve_stats generators {gens}, slo {list(stats.get('slo', {}))}")
    kept = trace.stats()["kept"]
    return {
        "launches": launches, "serve_s": serve_s, "classic_ms": classic_ms, "om_ms": om_ms,
        "classic_lines": classic.count("\n"), "om_lines": om.count("\n"), "exemplars": len(ex_lines),
        "kept": kept, "decode_tokens": tokens, "decode_s": decode_s, "slos": sorted(slo_doc.get("slos", ())),
        "decode_launches": decode_launches, "gen": gen,
        "queries": encoder.encode_to_device(texts).float().cpu().numpy(),
    }


def surface_decode_rows(gen, dev) -> dict:
    """The decode-row kernels at phase 28's burst shape (``[slots, 1,
    d_model]`` LayerNorm rows, ``[slots, d_model]`` readout) against their
    plain versions on the same inputs, with ``LN_ATOL`` / ``READOUT_ATOL``;
    timed between events on the card.  Keyed by the record's kernel."""
    from pathway_tpu_torch.ops import decode_rows

    n, d = SU_DECODE[0], gen.config.d_model
    ln = gen.module.blocks[0].ln_0
    g = torch.Generator(device=dev).manual_seed(SEED + 28)
    x = (torch.randn(n, 1, d, generator=g, device=dev) * 3).to(torch.bfloat16)
    delta = torch.randn(n, 1, d, generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        s_k, y_k = decode_rows.add_layer_norm_rows(x, delta, ln.weight, ln.bias, torch.float32)
        s_p, y_p = decode_rows.add_layer_norm_reference(x, delta, ln.weight, ln.bias, torch.float32)
        y1_k = decode_rows.layer_norm_rows(x, ln.weight, ln.bias, torch.float32)
        y1_p = decode_rows.layer_norm_reference(x, ln.weight, ln.bias, torch.float32)
        ln_err = max(float((s_k.float() - s_p.float()).abs().max()), float((y_k - y_p).abs().max()),
                     float((y1_k - y1_p).abs().max()))
        ro_err = float((decode_rows.tied_readout(h, gen._table) - decode_rows.tied_readout_reference(h, gen._table))
                       .abs().max())
        rows = {
            "add_layer_norm_rows": {"max_abs_err": ln_err, "ms": None, "plain_ms": None},
            "tied_readout": {"max_abs_err": ro_err, "ms": None, "plain_ms": None},
        }
        if dev.type == "cuda":
            rows["add_layer_norm_rows"].update(
                ms=timed_ms(lambda: decode_rows.add_layer_norm_rows(x, delta, ln.weight, ln.bias, torch.bfloat16), 20),
                plain_ms=timed_ms(
                    lambda: decode_rows.add_layer_norm_reference(x, delta, ln.weight, ln.bias, torch.bfloat16), 20),
            )
            rows["tied_readout"].update(
                ms=timed_ms(lambda: decode_rows.tied_readout(h, gen._table), 20),
                plain_ms=timed_ms(lambda: decode_rows.tied_readout_reference(h, gen._table), 20),
            )
    if ln_err > LN_ATOL or ro_err > READOUT_ATOL:
        raise AssertionError(f"phase 28 (b): at [{n}, 1, {d}] layer_norm_rows / add_layer_norm_rows err {ln_err} "
                             f"(limit {LN_ATOL}), tied_readout err {ro_err} (limit {READOUT_ATOL})")
    return rows


def surface_phase(tag: str, encoder, exact, ivf, docs, keys, dev=None, gen=None):
    """Phase 28: filtered exact search on phase 4's 1M index (a); the
    scrape surface over a traced scheduler serve and a decoder burst held
    against solo ``generate`` (b), and the decode-row kernels at the
    burst's shape against their plain versions; the knob CLI in a
    subprocess against ``markdown_table()``.  Returns (rescore launches,
    the rescore kernel at the phase's shape, decode-row launches by
    kernel, the decode-row kernels at the burst's shape)."""
    from pathway_tpu_torch import config

    t_phase = _now()
    dev = dev or torch.device(DEVICE)
    cli = subprocess.Popen([sys.executable, "-m", "pathway_tpu_torch.config", "--format", "markdown"],
                           cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        rng = np.random.default_rng(SEED + 28)
        with torch.no_grad():
            queries = encoder.encode_to_device([docs[j] for j in query_ids()[:BATCH]]).float().cpu().numpy()
        fa = surface_filtered(exact, queries, keys, rng)
        secs = {"a": _now() - t_phase}
        sc = surface_scrape(encoder, ivf, docs, dev, gen)
        decode = sc["decode_launches"]
        secs["b"] = _now() - t_phase - secs["a"]
        t_cli = _now()
        cli_out, cli_err = cli.communicate(timeout=300)
        secs["cli_wait"] = _now() - t_cli
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    if cli.returncode != 0 or cli_out.strip() != config.markdown_table().strip():
        raise AssertionError(f"phase 28: `python -m pathway_tpu_torch.config --format markdown` exited "
                             f"{cli.returncode} and printed {len(cli_out)} chars != markdown_table(): {cli_err[-300:]}")
    if dev.type == "cuda" and (sc["launches"] == 0 or min(decode.values()) == 0):
        raise AssertionError(f"phase 28: rescore launches {sc['launches']}, decode-row launches {decode}")
    log(
        f"surface (a) {tag}: filtered exact search over the {len(exact)}-row index, {BATCH} queries k={K}, "
        f"{fa['filtered']} with an allow-list of {SU_ALLOW} keys holding their unfiltered top 5: every row == the "
        f"unfiltered top {K} filtered by its list ({fa['short']} rows shorter than {K}); filtered search "
        f"{fa['ms']:.3f} ms; {fa['removed']} returned keys removed: none came back, filtered or not"
    )
    shape = None
    t_shape = _now()
    if dev.type == "cuda":
        shape = rescore_at_path_shape(ivf, ivf_search_rescore_args(ivf, sc["queries"]), dev)
        log(f"ivf_rescore at the surface shape {tag}: " + rescore_line(ivf, shape) + f"; launches {sc['launches']}")
    rows = surface_decode_rows(sc["gen"], dev)
    log(f"decode rows at the surface burst's shape {tag}: " + "; ".join(
        f"{name} max abs err {r['max_abs_err']:.3e}, "
        + (f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms" if r["ms"] is not None else "not timed")
        for name, r in rows.items()) + f" (limits {LN_ATOL} / {READOUT_ATOL})")
    secs["shape"] = _now() - t_shape
    log(
        f"surface (b) {tag}: {SU_REQUESTS} requests from {SU_CALLERS} callers through ServeScheduler over the IVF "
        f"FusedEncodeSearch, every request traced, in {sc['serve_s']:.3f} s (== the direct serve within "
        f"{SCHED_TOL}); {sc['kept']} traces kept; a {SU_DECODE[0]}-prompt x {SU_DECODE[1]}-token decoder burst "
        f"({sc['decode_tokens']:.0f} decode tokens, == solo generate, decode-row launches {decode}); /metrics classic "
        f"{sc['classic_lines']} lines with no exemplar, OpenMetrics {sc['om_lines']} lines with {sc['exemplars']} "
        f"exemplars, all on bucket samples and naming kept traces; /serve_stats has the generators and slo columns "
        f"(slos {sc['slos']}); the knob CLI's markdown == markdown_table(); rescore launches {sc['launches']}; "
        f"scrape classic {sc['classic_ms']:.3f} ms, openmetrics {sc['om_ms']:.3f} ms; (a) {secs['a']:.1f} s, (b) "
        f"{secs['b']:.1f} s (decoder {sc['decode_s']:.1f} s), the CLI's wait {secs['cli_wait']:.1f} s, the kernels at "
        f"the phase's shapes {secs['shape']:.1f} s; phase 28 {_now() - t_phase:.1f} s"
    )
    return sc["launches"], shape, decode, rows


def framework_setup():
    """The set-up ``--framework`` and ``--qa`` share: the card's name, the
    kernels' build, phase 4's rows and phase 5's direct serve p50 (exact
    and IVF) over 30 batches.  Returns ``(smi, p50)``."""
    from pathway_tpu_torch.kernels.build import build_all, build_host
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    log(f"card: {smi}")
    t0 = time.perf_counter()
    build_all()
    build_host("tokenize_hash")
    encoder, docs, doc_vecs, keys, exact = main_rows(f"[{smi}]")
    ivf = IvfKnnIndex(DIM, metric="cos")
    ivf.build_from_matrix(keys, exact._matrix[:N_ROWS])
    log(f"build and phase 4's rows {time.perf_counter() - t0:.1f} s")
    p50 = {}
    for name, index in (("exact", exact), ("ivf", ivf)):
        serve = FusedEncodeSearch(encoder, index, k=K)
        lat = []
        for texts in serve_batches(docs)[:30]:
            t = time.perf_counter()
            serve(texts)
            lat.append((time.perf_counter() - t) * 1e3)
        p50[name] = float(np.percentile(lat, 50))
    log(f"direct serve p50 over 30 batches of {BATCH}: exact {p50['exact']:.3f} ms, IVF {p50['ivf']:.3f} ms")
    return smi, p50


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":
        return rank_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--analysis-worker":
        return analysis_worker(sys.argv[2])
    if len(sys.argv) == 5 and sys.argv[1] == "--persist-worker":
        return persist_worker(*sys.argv[2:5])
    if len(sys.argv) == 6 and sys.argv[1] == "--cluster-worker":
        return cluster_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5])
    if len(sys.argv) == 4 and sys.argv[1] == "--cluster-kill-worker":
        return cluster_kill_worker(sys.argv[2], sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--serve-template":
        # phase 20 (b) on a machine without PyYAML: the template's objects, served
        from pathway_tpu_torch import cli
        from pathway_tpu_torch.internals.yaml_loader import build_template

        return cli.serve_config(build_template(template_spec(sys.argv[2])), port=int(sys.argv[3]))
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        # the package under another checkout's root, alone (two trees are
        # compared in one run on one card, in turns)
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        from pathway_tpu_torch.ops import decode_rows

        where = os.path.relpath(decode_rows.__file__)
        if "PATHWAY_PROFILE_SAMPLE" in os.environ:
            where += f" (PATHWAY_PROFILE_SAMPLE={os.environ['PATHWAY_PROFILE_SAMPLE']})"
        log(f"host us per wrapper call, {where}: " + rows_host_line(decode_rows, 256, torch.device(DEVICE)))
        log(f"engine c16, {where}: " + engine_c16_line())
        log(f"scheduled cascade c16, {where}: " + serve_c16_line())
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--first-call":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        )
        log(f"card: {smi.stdout.strip()}")
        for line in first_call_lines(sys.argv[2:]):
            log(line)
        return 0
    if sys.argv[1:] == ["--framing"]:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        )
        log(f"card: {smi.stdout.strip()}")
        for n_bytes in FRAMING_BYTES:
            log(f"warm-state framing on this host ({os.cpu_count()} cores): " + framing_compare_line(n_bytes))
        return 0
    # every shape-census tripwire of the run raises past its budget
    os.environ["PATHWAY_RECOMPILE_STRICT"] = "1"
    from pathway_tpu_torch.kernels.build import build_all

    if sys.argv[1:] == ["--sharded"]:
        from pathway_tpu_torch.ops.serving import FusedEncodeSearch

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        encoder, docs, doc_vecs, keys, exact = main_rows(f"[{smi}]")
        log(f"build and phase 4's rows {time.perf_counter() - t0:.1f} s")
        launches = sharded_phase(encoder, exact, FusedEncodeSearch(encoder, exact, k=K), docs, doc_vecs, keys,
                                 serve_batches(docs), f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--fabric"]:
        from pathway_tpu_torch.ops.ivf import IvfKnnIndex
        from pathway_tpu_torch.ops.serving import FusedEncodeSearch

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        encoder, docs, doc_vecs, keys, exact = main_rows(f"[{smi}]")
        ivf = IvfKnnIndex(DIM, metric="cos")
        ivf.build_from_matrix(keys, exact._matrix[:N_ROWS])
        cascade = fabric_cascade(encoder, ivf, docs, keys)
        log(f"build, phase 4's rows and the cascade {time.perf_counter() - t0:.1f} s")
        launches = fabric_phase(encoder, exact, FusedEncodeSearch(encoder, exact, k=K), cascade, docs, doc_vecs, keys,
                                serve_batches(docs), f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--framework"]:
        smi, p50 = framework_setup()
        launches = framework_phase(p50, f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--qa"]:
        smi, p50 = framework_setup()
        t0 = time.perf_counter()
        launches = qa_phase(p50, f"[{smi}]")[0]
        template_phase(f"[{smi}]")
        log(f"phase 20 {time.perf_counter() - t0:.1f} s; QA launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--persist"]:
        from pathway_tpu_torch.kernels.build import build_host

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        build_host("tokenize_hash")
        log(f"build {time.perf_counter() - t0:.1f} s")
        launches = persist_phase(f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--temporal"]:
        from pathway_tpu_torch.kernels.build import build_host

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        build_host("tokenize_hash")
        log(f"build {time.perf_counter() - t0:.1f} s")
        launches = temporal_phase(f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--hostapi"]:
        from pathway_tpu_torch.kernels.build import build_host

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        build_host("tokenize_hash")
        log(f"build {time.perf_counter() - t0:.1f} s")
        launches = hostapi_phase(f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--cluster"]:
        from pathway_tpu_torch.kernels.build import build_host

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()  # once, before the ranks start: they load what this built
        build_host("tokenize_hash")
        log(f"build {time.perf_counter() - t0:.1f} s")
        launches = cluster_phase(f"[{smi}]")[0]
        log(f"rescore launches per rank {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--connectors"]:
        from pathway_tpu_torch.kernels.build import build_host

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        build_host("tokenize_hash")
        log(f"build {time.perf_counter() - t0:.1f} s")
        launches = connectors_phase(f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--analysis"]:
        from pathway_tpu_torch.kernels.build import build_host

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()  # once, before the worker starts: it loads what this built
        build_host("tokenize_hash")
        log(f"build {time.perf_counter() - t0:.1f} s")
        launches = analysis_phase(f"[{smi}]")[0]
        log(f"launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--native"]:
        from pathway_tpu_torch.kernels.build import build_host

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        build_host("tokenize_hash")
        build_host("native_io")
        log(f"build {time.perf_counter() - t0:.1f} s")
        launches = native_phase(f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--surface"]:
        from pathway_tpu_torch.kernels.build import build_host
        from pathway_tpu_torch.ops.ivf import IvfKnnIndex

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        build_host("tokenize_hash")
        encoder, docs, doc_vecs, keys, exact = main_rows(f"[{smi}]")
        ivf = IvfKnnIndex(DIM, metric="cos")
        ivf.build_from_matrix(keys, exact._matrix[:N_ROWS])
        log(f"build and phase 4's rows {time.perf_counter() - t0:.1f} s")
        launches, _shape, decode, _rows = surface_phase(f"[{smi}]", encoder, exact, ivf, docs, keys)
        log(f"rescore launches {launches}, decode-row launches {decode}; shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--distributed"]:
        from pathway_tpu_torch.kernels.build import build_host
        from pathway_tpu_torch.ops.serving import FusedEncodeSearch

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        build_host("tokenize_hash")
        encoder, docs, doc_vecs, keys, exact = main_rows(f"[{smi}]")
        log(f"build and phase 4's rows {time.perf_counter() - t0:.1f} s")
        serve_exact = FusedEncodeSearch(encoder, exact, k=K)
        batches = serve_batches(docs)
        lat = []
        for texts in batches[:30]:
            t = time.perf_counter()
            serve_exact(texts)
            lat.append((time.perf_counter() - t) * 1e3)
        p50 = float(np.percentile(lat, 50))
        log(f"exact serve p50 {p50:.3f} ms over 30 batches of {BATCH} [{smi}]")
        multiprocess_phase(encoder, docs, batches, serve_exact, p50, f"[{smi}]")
        log(f"shape census: {tripwire_census()}")
        return 0
    if sys.argv[1:] == ["--real-weights"]:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        build_all()
        log(f"build {time.perf_counter() - t0:.1f} s")
        launches = real_weights_phase(corpus(N_DOCS), keys_for(N_ROWS), f"[{smi}]")[0]
        log(f"rescore launches {launches}; shape census: {tripwire_census()}")
        return 0
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.ivf_rescore import ivf_rescore_reference, rescore_shortlist
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    t_run = time.perf_counter()
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
    from pathway_tpu_torch.kernels.build import build_host

    t0 = time.perf_counter()
    build_host("tokenize_hash")
    log(f"build: the host batch tokenizer (g++, csrc/host/tokenize_hash.cc) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    build_host("native_io")
    log(f"build: the native I/O runtime (g++, csrc/host/native_io.cc) in {time.perf_counter() - t0:.2f} s")

    # -- 3. kernel vs plain at edge shapes ------------------------------------
    worst_err = rescore_edge_cases(rescore_shortlist, ivf_rescore_reference, dev)

    # -- 4. main path at full width ------------------------------------------
    t0 = time.perf_counter()
    encoder, docs, doc_vecs, keys, exact = main_rows(tag)
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
    qidx = query_ids()
    batches = serve_batches(docs)
    with torch.no_grad():
        z = encoder.encode_to_device(batches[0])
        probe = torch.topk(z @ ivf._centroids.t(), p, dim=1).indices.to(torch.int32)
        q = z.contiguous()
        args = (probe, q, ivf._slabs, ivf._bias)
        worst_err = max(worst_err, compare_rescore(rescore_shortlist, ivf_rescore_reference, *args))
        flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        kernel_ms = timed_ms(lambda: rescore_shortlist(*args), reps=20, flush=flush)
        plain_ms = timed_ms(lambda: ivf_rescore_reference(*args), reps=5, flush=flush)
        library_ms, library_gather_ms = library_rescore_ms(ivf, probe, q, flush)
        d_pad = ivf._d_pad
        # the same probes over bf16 slabs (a bf16 copy of the index's slabs)
        slabs16 = ivf._slabs.to(torch.bfloat16)
        args16 = (probe, q, slabs16, ivf._bias)
        worst_err = max(worst_err, compare_rescore(rescore_shortlist, ivf_rescore_reference, *args16))
        bf16_ms = timed_ms(lambda: rescore_shortlist(*args16), reps=20, flush=flush)
        bf16_plain_ms = timed_ms(lambda: ivf_rescore_reference(*args16), reps=5, flush=flush)
        del slabs16, args16, flush
    distinct = int(torch.unique(probe).numel())
    n_ops = 2 * BATCH * p * M * d_pad
    bound_ms, bound_by, n_bytes = rescore_bound(distinct, M, d_pad, 4, BATCH, p)
    bf16_bound_ms, bf16_bound_by, bf16_bytes = rescore_bound(distinct, M, d_pad, 2, BATCH, p)
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

    # the exact-tail rung: a tail upload that fails past its retries serves
    # resident-only, flagged tail_skipped, and the next serve uploads again
    from pathway_tpu_torch.robust import inject

    tail_docs = [t + " tail" for t in corpus(8, seed=SEED + 9)]
    tail_keys = [(1 << 61) + i for i in range(len(tail_docs))]
    with torch.no_grad():
        tail_vecs = encoder.encode_to_device(tail_docs).cpu().numpy()
    n_tail0 = len(ivf._tail)
    if n_tail0 + len(tail_docs) >= ivf.absorb_threshold:
        raise AssertionError(f"tail check: {n_tail0} rows already in the tail")
    ivf.add(tail_keys, tail_vecs)
    serve_tail = FusedEncodeSearch(encoder, ivf, k=K)
    inject.arm("ivf.tail_upload", "raise", times=3)  # every attempt of one serve
    try:
        skipped = serve_tail(tail_docs)
        flagged = ivf.tail_degraded
    finally:
        inject.disarm("ivf.tail_upload")
    recovered = serve_tail(tail_docs)
    leaked = sum(1 for row in skipped for key, _ in row if key in set(tail_keys))
    first = sum(1 for row, key in zip(recovered, tail_keys) if row and row[0][0] == key)
    log(
        f"tail upload rung {tag}: {len(tail_docs)} rows in the exact tail (beside {n_tail0}), 3 injected "
        f"ivf.tail_upload failures: flags {skipped.degraded}, tail_degraded {flagged}, {leaked} tail keys served, "
        f"{sum(len(r) for r in skipped)} resident rows; next serve: flags {recovered.degraded}, its own tail key "
        f"first on {first}/{len(tail_docs)} rows"
    )
    if (skipped.degraded != ("tail_skipped",) or not flagged or leaked or any(len(r) != K for r in skipped)
            or not recovered.ok or ivf.tail_degraded or first != len(tail_docs)):
        raise AssertionError("the exact-tail rung did not serve resident-only and then recover")
    ivf.remove(tail_keys)

    # -- 7. background retrain --------------------------------------------------
    retrain_phase(encoder, docs, doc_vecs, keys, tag)

    # -- 8. rerank: the main path's stage 2, counted ----------------------------
    rr_launches, rr_kernel, modes, fwd = rerank_phase(encoder, ivf, docs, keys, tag)
    cascade = modes["cascade"]
    worst_err = max(worst_err, rr_kernel["max_abs_err"])

    # -- 9. the serve front over the cascade, counted ---------------------------
    sched_launches, sched_kernel = scheduler_phase(encoder, ivf, docs, cascade, tag)
    worst_err = max([worst_err] + [r["max_abs_err"] for r in sched_kernel])

    # -- 10. generator decode, counted --------------------------------------------
    decode_kernels = decode_phase(tag)

    # -- 11. live ingest under c16 serve, counted -----------------------------------
    li_launches, li_kernel = live_ingest_phase(encoder, ivf, docs, modes, fwd, tag)
    worst_err = max(worst_err, li_kernel["max_abs_err"])

    # -- 12. warm state: cold vs warm bring-up, the 1M index restored -------------
    ws_launches = warm_state_phase(encoder, ivf, docs, keys, fwd, cascade.doc_text, tag)

    # -- 13. the online tuner against static defaults, counted ---------------------
    st_launches = tuning_phase(docs, cascade, tag)

    # -- 14. the operator plane's cost and attribution, counted --------------------
    po_launches, po_decode = profiling_phase(encoder, ivf, docs, doc_vecs, keys, cascade, tag)
    decode_kernels[0]["launches"] += po_decode["add_layer_norm_rows"]
    decode_kernels[0]["launches_profiling_phase"] = po_decode["add_layer_norm_rows"]
    decode_kernels[1]["launches"] += po_decode["tied_readout"]
    decode_kernels[1]["launches_profiling_phase"] = po_decode["tied_readout"]

    # -- 15. real weights: HF BERT checkpoints at MiniLM width, then CLIP, counted --
    rw_launches, hf_kernel, clip_kernel = real_weights_phase(docs, keys, tag)
    worst_err = max(worst_err, hf_kernel["max_abs_err"], clip_kernel["max_abs_err"])

    # -- 16. sharded serve: 8 logical shards, mesh exact, sharded forward, counted --
    ss_launches, ss_kernel = sharded_phase(encoder, exact, serve_exact, docs, doc_vecs, keys, batches, tag)
    worst_err = max(worst_err, ss_kernel["max_abs_err"])

    # -- 17. the multi-process plane: native tokenizer, two ranks, mesh encoder, ring attention --
    multiprocess_phase(encoder, docs, batches, serve_exact, pct["exact"][0], tag)

    # -- 18. the serve fabric: a replica group, then partitions, counted --
    sf_launches, sf_kernel = fabric_phase(encoder, exact, serve_exact, cascade, docs, doc_vecs, keys, batches, tag)
    worst_err = max(worst_err, sf_kernel["max_abs_err"])

    # -- 19. the framework: DocumentStore retrieval through the engine, counted --
    fw_launches, fw_kernel = framework_phase({"exact": pct["exact"][0], "ivf": pct["ivf"][0]}, tag)
    worst_err = max(worst_err, fw_kernel["max_abs_err"])

    # -- 20. question answering and chat: a RAG app behind the REST server, then the templates, counted --
    t20 = time.perf_counter()
    qa_launches, qa_kernel = qa_phase({"exact": pct["exact"][0], "ivf": pct["ivf"][0]}, tag)
    worst_err = max(worst_err, qa_kernel["max_abs_err"])
    template_phase(tag)
    log(f"phase 20 {time.perf_counter() - t20:.1f} s")
    decode_kernels[0]["launches_by_path"] = {
        "decode": decode_kernels[0]["launches"] - po_decode["add_layer_norm_rows"],
        "profiling": po_decode["add_layer_norm_rows"],
        "qa": qa_launches["add_layer_norm_rows"],
    }
    decode_kernels[0]["launches"] += qa_launches["add_layer_norm_rows"]
    decode_kernels[1]["launches"] += qa_launches["tied_readout"]
    decode_kernels[1]["launches_by_path"]["qa"] = qa_launches["tied_readout"]

    # -- 21. durable pipelines: a persisted hybrid index restarted, a crash, cli replay, counted --
    ps_launches, ps_kernel = persist_phase(tag)
    worst_err = max(worst_err, ps_kernel["max_abs_err"])

    # -- 22. time on the card: a windowed retrieval index, temporal joins, iterate and graphs, counted --
    tm_launches, tm_kernel = temporal_phase(tag)
    worst_err = max(worst_err, tm_kernel["max_abs_err"])

    # -- 23. the rest of the host API over an async retrieval path, counted --
    ha_launches, ha_kernel = hostapi_phase(tag)
    worst_err = max(worst_err, ha_kernel["max_abs_err"])

    # -- 24. the multi-process engine: two ranks through cli spawn on the one card, counted per rank --
    cl_launches, cl_kernel = cluster_phase(tag, fw_ingest=FW_INGEST)
    worst_err = max(worst_err, cl_kernel["max_abs_err"])

    # -- 25. a CDC feed into a live vector index through the client-gated connectors, counted --
    cx_launches, cx_kernel = connectors_phase(tag)
    worst_err = max(worst_err, cx_kernel["max_abs_err"])

    # -- 26. serve, ingest and decode under the lock sanitizer, counted --
    an_launches, an_kernel, an_decode = analysis_phase(tag)
    worst_err = max(worst_err, an_kernel["max_abs_err"])
    for rec, name in ((decode_kernels[0], "add_layer_norm_rows"), (decode_kernels[1], "tied_readout")):
        rec["launches"] += an_launches[name]
        rec["launches_by_path"]["analysis"] = an_launches[name]
        rec["analysis_shape"] = an_decode[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], an_decode[name]["max_abs_err"])

    # -- 27. the native host runtime, then a CSV-fed index, counted --
    nv_launches, nv_kernel, _nv_secs = native_phase(tag, docs=docs)
    worst_err = max(worst_err, nv_kernel["max_abs_err"])

    # -- 28. the reference's public surface: filtered search and the scrape, counted --
    su_launches, su_shape, su_decode, su_rows = surface_phase(tag, encoder, exact, ivf, docs, keys)
    worst_err = max(worst_err, su_shape["max_abs_err"])
    for rec, name in ((decode_kernels[0], "add_layer_norm_rows"), (decode_kernels[1], "tied_readout")):
        rec["launches"] += su_decode[name]
        rec["launches_by_path"]["surface"] = su_decode[name]
        rec["surface_shape"] = su_rows[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], su_rows[name]["max_abs_err"])
    log(f"shape census: {tripwire_census()}")

    record = {
        "kernels": [
            {
                "name": "ivf_rescore",
                "route": "cuda",
                "source": "pathway_tpu_torch/csrc/ivf_rescore.cu",
                "replaces": "pathway_tpu/ops/ivf_pallas.py:37",
                "launches": launches + rr_launches + sched_launches + li_launches + ws_launches + st_launches
                + po_launches + sum(rw_launches.values()) + ss_launches + sf_launches + fw_launches
                + qa_launches["ivf_rescore"] + ps_launches + tm_launches + ha_launches + sum(cl_launches)
                + cx_launches + an_launches["ivf_rescore"] + nv_launches + su_launches,
                "launches_by_path": {
                    "serve": launches, "rerank": rr_launches, "scheduler": sched_launches,
                    "ingest": li_launches, "warmstate": ws_launches, "tuning": st_launches,
                    "profiling": po_launches, "real_weights": rw_launches, "sharded": ss_launches,
                    "fabric": sf_launches, "framework": fw_launches, "qa": qa_launches["ivf_rescore"],
                    "persist": ps_launches, "temporal": tm_launches, "hostapi": ha_launches,
                    "cluster_per_rank": cl_launches, "connectors": cx_launches,
                    "analysis": an_launches["ivf_rescore"], "native_csv": nv_launches, "surface": su_launches,
                },
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
                "rerank_shape_ms": rr_kernel["ms"],
                "rerank_shape_kernels_ms": rr_kernel["kernels_ms"],
                "rerank_shape_bound_ms": rr_kernel["bound_ms"],
                "rerank_shape_bound_by": rr_kernel["bound_by"],
                "rerank_shape_library_ms": rr_kernel["library_ms"],
                "rerank_shape_library_with_gather_ms": rr_kernel["library_with_gather_ms"],
                "scheduler_shapes": [
                    {key: r[key] for key in _SHAPE_KEYS} for r in sched_kernel
                ],
                "after_absorb_shape": {key: li_kernel[key] for key in _SHAPE_KEYS},
                "hf_stage1_shape": {key: hf_kernel[key] for key in _SHAPE_KEYS},
                "clip_search_shape": {key: clip_kernel[key] for key in _SHAPE_KEYS},
                "sharded_shard_shape": {key: ss_kernel[key] for key in _SHAPE_KEYS},
                "partition_shape": {key: sf_kernel[key] for key in _SHAPE_KEYS},
                "framework_shape": {key: fw_kernel[key] for key in _SHAPE_KEYS},
                "qa_shape": {key: qa_kernel[key] for key in _SHAPE_KEYS},
                "persist_shape": {key: ps_kernel[key] for key in _SHAPE_KEYS},
                "temporal_shape": {key: tm_kernel[key] for key in _SHAPE_KEYS},
                "hostapi_shape": {key: ha_kernel[key] for key in _SHAPE_KEYS},
                "cluster_shape": {key: cl_kernel[key] for key in _SHAPE_KEYS},
                "connectors_shape": {key: cx_kernel[key] for key in _SHAPE_KEYS},
                "analysis_shape": {key: an_kernel[key] for key in _SHAPE_KEYS},
                "native_csv_shape": {key: nv_kernel[key] for key in _SHAPE_KEYS},
                "surface_shape": {key: su_shape[key] for key in _SHAPE_KEYS},
            },
            *decode_kernels,
        ]
    }
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_run:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
