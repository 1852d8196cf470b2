"""The port's knob table (counterpart of ``pathway_tpu/config.py``).

Only the knobs the port reads are declared here, each with the
reference's key, ``PATHWAY_*`` environment name, type, default and
bounds, so one environment configures both packages alike.  The table
is the port's own: nothing is registered into the reference's registry.

``get("serve.coalesce_us")`` is a cached typed lookup: the parse runs
again only when the raw environment string changes.  A malformed value
falls back to the declared default and an out-of-bounds number clamps
to the declared bounds, each with one warning, never an exception.
``get_site`` resolves the per-site family ``PATHWAY_RETRY_ATTEMPTS_<SITE>``
of ``robust.retry_attempts``.

The write path is the reference's: every knob carries its mutability
class.  ``dynamic`` knobs (result-identical performance trade-offs: the
coalescing window, the step chunk, cache byte budgets, the profiler
stride) may be moved online by the tuner (``serve/tuner.py``) through
``set``, always clamped to the declared bounds; ``set`` on a ``static``
knob raises ``StaticKnobError``.  The override layer wins over the
environment and over the parse cache, whatever the environment string
does after the ``set``.  ``auto_pytest`` bools (the strict-mode
tripwires) default to "on under pytest" and are re-read on every call,
never cached.

``load()`` parses every knob from the environment at once; it is the
chaos site ``config.load``, and a fault there serves the last-good
values (one warning, one ``pathway_config_load_failures_total``).
``python -m pathway_tpu_torch.config --format {text,json,markdown}``
prints the table (``describe()`` / ``markdown_table()``), row for row
the reference's.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DYNAMIC",
    "STATIC",
    "Knob",
    "StaticKnobError",
    "UnknownKnobError",
    "clear_override",
    "clear_overrides",
    "describe",
    "get",
    "get_site",
    "knobs",
    "load",
    "markdown_table",
    "overrides",
    "registry",
    "set",
    "snapshot",
]

_log = logging.getLogger("pathway_tpu_torch.config")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("", "0", "false", "no", "off")

STATIC = "static"
DYNAMIC = "dynamic"


class StaticKnobError(TypeError):
    """``set`` on a ``static`` knob: the declaration is the tuner's veto."""


class UnknownKnobError(KeyError):
    """A dotted key the table does not declare."""


@dataclass(frozen=True)
class Knob:
    """One declared knob: ``kind`` is bool | int | float | str | enum;
    ``lo``/``hi`` clamp numbers, ``choices`` bound enums, ``mutability``
    is ``static`` or ``dynamic``, ``site_prefix`` names a per-site
    environment family, and an ``auto_pytest`` bool is on under pytest
    when unset."""

    key: str
    env: str
    kind: str
    default: Any
    doc: str
    lo: Optional[float] = None
    hi: Optional[float] = None
    choices: Optional[Tuple[str, ...]] = None
    mutability: str = STATIC
    site_prefix: Optional[str] = None
    auto_pytest: bool = False

    def default_doc(self) -> str:
        if self.auto_pytest:
            return "auto (on under pytest)"
        if self.kind == "bool":
            return "on" if self.default else "off"
        return str(self.default)


_REGISTRY: Dict[str, Knob] = {}
# key -> (raw env string seen at parse time, typed value)
_cache: Dict[str, Tuple[Optional[str], Any]] = {}
# the tuner's layer: key -> typed value (dynamic knobs only, clamped)
_overrides: Dict[str, Any] = {}
_overrides_lock = threading.Lock()
_warned: set = set()
_warned_lock = threading.Lock()


def _knob(key: str, env: str, kind: str, default: Any, doc: str, **kw: Any) -> None:
    if key in _REGISTRY:
        raise ValueError(f"duplicate knob declaration: {key}")
    _REGISTRY[key] = Knob(key, env, kind, default, doc, **kw)


# serve front (serve/scheduler.py, ops/retrieve_rerank.py)
_knob("serve.coalesce_us", "PATHWAY_SERVE_COALESCE_US", "float", 2000.0,
      "scheduler coalescing window in µs (0 = no wait)", lo=0.0, hi=100_000.0, mutability=DYNAMIC)
_knob("serve.max_batch", "PATHWAY_SERVE_MAX_BATCH", "int", 64,
      "cap on UNIQUE queries per coalesced device batch", lo=1, hi=4096)
_knob("serve.shards", "PATHWAY_SERVE_SHARDS", "int", 0,
      "serve-side index shard count (0 = caller/device default)", lo=0, hi=4096)
_knob("serve.deadline_ms", "PATHWAY_SERVE_DEADLINE_MS", "float", 0.0,
      "per-request serve deadline in ms (0 = none)", lo=0.0, hi=600_000.0)
_knob("serve.stage1_fraction", "PATHWAY_SERVE_STAGE1_FRACTION", "float", 0.6,
      "fraction of the deadline granted to stage 1", lo=0.05, hi=1.0)
_knob("serve.shed", "PATHWAY_SERVE_SHED", "bool", True,
      "SLO burn sheds shed-class requests at admission (off = advisory)")
_knob("serve.shed_priorities", "PATHWAY_SERVE_SHED_PRIORITIES", "str", "low",
      "comma-separated priority classes eligible for load shedding")
_knob("serve.default_priority", "PATHWAY_SERVE_DEFAULT_PRIORITY", "enum", "normal",
      "priority class for submit() calls that pass none", choices=("high", "normal", "low"))

# serve fabric (serve/fabric.py): replica groups across hosts
_knob("fabric.heartbeat_s", "PATHWAY_FABRIC_HEARTBEAT", "float", 0.5,
      "fabric host heartbeat ping interval in seconds", lo=0.01, hi=3600.0)
_knob("fabric.heartbeat_timeout_s", "PATHWAY_FABRIC_HEARTBEAT_TIMEOUT", "float", 2.0,
      "heartbeat silence before a fabric host is declared dead (breaker trips, in-flight tickets re-route)",
      lo=0.05, hi=86_400.0)
_knob("fabric.hedge_ms", "PATHWAY_FABRIC_HEDGE_MS", "float", 0.0,
      "hedged-retry delay in ms: a request unanswered past this is re-sent to a second healthy host, "
      "first response wins (0 = off)", lo=0.0, hi=600_000.0, mutability=DYNAMIC)
_knob("fabric.affinity_slack", "PATHWAY_FABRIC_AFFINITY_SLACK", "int", 2,
      "extra in-flight requests the consistent-hash affinity host may carry over the least-loaded host "
      "before routing spills", lo=0, hi=4096)
_knob("fabric.connect_timeout_s", "PATHWAY_FABRIC_CONNECT_TIMEOUT", "float", 5.0,
      "fabric host TCP connect timeout in seconds", lo=0.05, hi=600.0)
_knob("fabric.request_timeout_s", "PATHWAY_FABRIC_REQUEST_TIMEOUT", "float", 30.0,
      "fallback per-request response timeout in seconds for requests that carry no deadline",
      lo=0.05, hi=86_400.0)

# partitioned serve fabric (serve/fabric.py scatter-gather)
_knob("fabric.partitions", "PATHWAY_FABRIC_PARTITIONS", "int", 0,
      "index partitions across the fabric fleet (0 = replica mode, every host holds the full index; "
      "N > 0 = each host owns doc_key % N of the corpus and serves scatter-gather)", lo=0, hi=4096)
_knob("partition.gather_timeout_s", "PATHWAY_PARTITION_GATHER_TIMEOUT", "float", 10.0,
      "scatter-gather straggler bound in seconds: a partition unanswered past it is flagged "
      "partition_lost and the surviving partitions' merge is served", lo=0.05, hi=86_400.0,
      mutability=DYNAMIC)
_knob("partition.absorb_timeout_s", "PATHWAY_PARTITION_ABSORB_TIMEOUT", "float", 30.0,
      "owner-routed absorb ack timeout in seconds before the routed batch is counted dropped on its "
      "owner partition", lo=0.05, hi=86_400.0)

# cache tiers (cache/)
_knob("cache.enabled", "PATHWAY_CACHE", "bool", True, "global cache kill switch (off disables every tier)")
_knob("cache.result", "PATHWAY_CACHE_RESULT", "bool", True, "tier-0 result cache")
_knob("cache.result_bytes", "PATHWAY_CACHE_RESULT_BYTES", "int", 32 << 20,
      "result-tier byte budget", lo=0, hi=1 << 40, mutability=DYNAMIC)
_knob("cache.result_ttl_s", "PATHWAY_CACHE_RESULT_TTL_S", "float", 60.0,
      "result-tier TTL in seconds (0 = no expiry)", lo=0.0, hi=86_400.0)
_knob("cache.embed", "PATHWAY_CACHE_EMBED", "bool", False,
      "tier-1 embedding cache (opt-in: the search-only path changes low-order score bits)")
_knob("cache.embed_bytes", "PATHWAY_CACHE_EMBED_BYTES", "int", 64 << 20,
      "embedding-tier byte budget", lo=0, hi=1 << 40, mutability=DYNAMIC)
_knob("cache.embed_ttl_s", "PATHWAY_CACHE_EMBED_TTL_S", "float", 0.0,
      "embedding-tier TTL in seconds (0 = no expiry)", lo=0.0, hi=86_400.0)

# live ingest (serve/ingest.py)
_knob("ingest.batch_docs", "PATHWAY_INGEST_BATCH_DOCS", "int", 32,
      "max documents one ingest embed/absorb batch carries", lo=1, hi=4096, mutability=DYNAMIC)
_knob("ingest.poll_ms", "PATHWAY_INGEST_POLL_MS", "float", 5.0,
      "ingest loop idle poll interval in ms", lo=0.1, hi=60_000.0, mutability=DYNAMIC)
_knob("ingest.queue_cap", "PATHWAY_INGEST_QUEUE_CAP", "int", 4096,
      "pending-document queue capacity (connector commits block past it)", lo=1, hi=1_048_576)
_knob("ingest.backpressure_ms", "PATHWAY_INGEST_BACKPRESSURE_MS", "float", 25.0,
      "absorb-cadence yield when serve latency is the binding SLO", lo=0.0, hi=60_000.0, mutability=DYNAMIC)

# durable warm state (serve/warmstate.py)
_knob("warmstate.interval_s", "PATHWAY_WARMSTATE_INTERVAL_S", "float", 60.0,
      "warm-state snapshot cadence in seconds (0 = manual only)", lo=0.0, hi=86_400.0, mutability=DYNAMIC)
_knob("warmstate.chunk_bytes", "PATHWAY_WARMSTATE_CHUNK_BYTES", "int", 1_048_576,
      "CRC-framed snapshot chunk size in bytes", lo=4096, hi=1_073_741_824)
_knob("warmstate.keep", "PATHWAY_WARMSTATE_KEEP", "int", 2,
      "committed snapshot generations retained per store", lo=1, hi=1024)

# generator decode (models/generator.py, serve/decode.py)
_knob("decode.step_bucket", "PATHWAY_DECODE_STEP_BUCKET", "int", 8,
      "decode steps one chunk dispatch advances", lo=1, hi=128, mutability=DYNAMIC)
_knob("decode.slots", "PATHWAY_DECODE_SLOTS", "int", 8,
      "continuous-decode slot-pool size", lo=1, hi=1024)
_knob("decode.kv_width", "PATHWAY_DECODE_KV_WIDTH", "int", 0,
      "slot-pool context width override (0 = model max_len)", lo=0, hi=1_048_576)
_knob("decode.kv_quant", "PATHWAY_DECODE_KV_QUANT", "enum", "bf16",
      "slot-pool K/V storage (bit-identity oracle pins this)", choices=("bf16", "int8"))
_knob("decode.spec_k", "PATHWAY_DECODE_SPEC_K", "int", 0,
      "speculation depth per verify dispatch (0 = off; token-identity oracle pins this)", lo=0, hi=16)
_knob("decode.draft", "PATHWAY_DECODE_DRAFT", "enum", "auto",
      "speculative draft source", choices=("auto", "ngram", "trunk"))
_knob("decode.draft_layers", "PATHWAY_DECODE_DRAFT_LAYERS", "int", 0,
      "reduced-layer draft-trunk depth (0 = half the trunk)", lo=0, hi=1024)
_knob("generator.eos", "PATHWAY_GENERATOR_EOS", "str", "",
      "EOS token id for early stop (empty/none = no EOS handling)")
_knob("generator.kv", "PATHWAY_GENERATOR_KV", "bool", True,
      "KV-cache decode (off = the legacy full re-attend)")
_knob("cache.kv", "PATHWAY_CACHE_KV", "bool", True, "tier-2 generator prefix-KV cache")
_knob("cache.kv_bytes", "PATHWAY_CACHE_KV_BYTES", "int", 256 << 20,
      "prefix-KV-tier byte budget", lo=0, hi=1 << 40, mutability=DYNAMIC)
_knob("cache.kv_ttl_s", "PATHWAY_CACHE_KV_TTL_S", "float", 0.0,
      "prefix-KV-tier TTL in seconds (0 = no expiry)", lo=0.0, hi=86_400.0)
_knob("cache.kv_block", "PATHWAY_CACHE_KV_BLOCK", "int", 32,
      "prefix-KV block size in tokens (key-chain granularity)", lo=1, hi=4096)

# forward index (index/forward.py)
_knob("forward.tokens", "PATHWAY_FORWARD_TOKENS", "int", 16,
      "forward-index pooled doc-row budget T'", lo=1, hi=4096)
_knob("forward.quant", "PATHWAY_FORWARD_QUANT", "enum", "int8",
      "forward-index row storage (parity oracle pins this)", choices=("int8", "none"))

# observability (observe/)
_knob("observe.enabled", "PATHWAY_OBSERVE", "bool", True,
      "flight recorder + tracing master switch")
_knob("observe.trace_sample", "PATHWAY_TRACE_SAMPLE", "float", 1.0,
      "head-sampling probability for request traces", lo=0.0, hi=1.0)
_knob("observe.trace_keep", "PATHWAY_TRACE_KEEP", "int", 256,
      "kept-trace LRU capacity on GET /traces", lo=1, hi=65_536)
_knob("observe.trace_pending", "PATHWAY_TRACE_PENDING", "int", 128,
      "pending-trace ring capacity", lo=1, hi=65_536)
_knob("observe.trace_max_spans", "PATHWAY_TRACE_MAX_SPANS", "int", 192,
      "span cap per trace tree", lo=8, hi=65_536)
_knob("observe.trace_slow_pct", "PATHWAY_TRACE_SLOW_PCT", "float", 0.99,
      "tail-sampling slow-percentile threshold", lo=0.5, hi=0.9999)
_knob("observe.slo", "PATHWAY_SLO", "bool", True,
      "SLO engine shed-advisory probe in scheduler admission")
_knob("observe.slo_tick_s", "PATHWAY_SLO_TICK_S", "float", 1.0,
      "min seconds between SLO burn-rate evaluations", lo=0.0, hi=3600.0)
_knob("observe.slo_latency_ms", "PATHWAY_SLO_LATENCY_MS", "float", 500.0,
      "serve-latency SLO threshold in ms", lo=1.0, hi=600_000.0)
_knob("observe.slo_latency_objective", "PATHWAY_SLO_LATENCY_OBJECTIVE", "float", 0.99,
      "serve-latency SLO objective fraction", lo=0.5, hi=0.99999)
_knob("observe.slo_availability", "PATHWAY_SLO_AVAILABILITY", "float", 0.999,
      "availability SLO objective fraction", lo=0.5, hi=0.99999)
_knob("observe.slo_ttlt_ms", "PATHWAY_SLO_TTLT_MS", "float", 2000.0,
      "decode TTLT SLO threshold in ms", lo=1.0, hi=600_000.0)
_knob("observe.slo_freshness_ms", "PATHWAY_SLO_FRESHNESS_MS", "float", 5000.0,
      "ingest freshness SLO threshold in ms (arrival to retrievable)", lo=1.0, hi=86_400_000.0)
_knob("observe.slo_freshness_objective", "PATHWAY_SLO_FRESHNESS_OBJECTIVE", "float", 0.99,
      "freshness SLO objective fraction", lo=0.5, hi=0.99999)
_knob("observe.slo_fast_window_s", "PATHWAY_SLO_FAST_WINDOW_S", "float", 300.0,
      "fast burn-rate window in seconds", lo=0.05, hi=86_400.0)
_knob("observe.slo_slow_window_s", "PATHWAY_SLO_SLOW_WINDOW_S", "float", 3600.0,
      "slow burn-rate window in seconds", lo=0.05, hi=86_400.0)
_knob("observe.slo_burn", "PATHWAY_SLO_BURN", "float", 14.4,
      "burn-rate multiple that fires the SLO alert", lo=0.1, hi=10_000.0)
_knob("observe.profile_sample", "PATHWAY_PROFILE_SAMPLE", "float", 0.25,
      "device-time profiler sampled fraction of calls", lo=0.0, hi=1.0, mutability=DYNAMIC)

# self-tuning (serve/tuner.py)
_knob("tuner.enabled", "PATHWAY_TUNER", "bool", False,
      "background knob tuner (adjusts dynamic-class knobs online)")
_knob("tuner.interval_s", "PATHWAY_TUNER_INTERVAL_S", "float", 2.0,
      "seconds between tuner control ticks", lo=0.05, hi=3600.0)

# robustness (robust/)
_knob("robust.faults", "PATHWAY_FAULTS", "str", "",
      "armed fault sites, e.g. 'cache.get=raise:p=0.01'")
_knob("robust.retry_attempts", "PATHWAY_RETRY_ATTEMPTS", "int", 3,
      "retry attempts per site", lo=1, hi=100, site_prefix="PATHWAY_RETRY_ATTEMPTS_")
_knob("robust.retry_base_ms", "PATHWAY_RETRY_BASE_MS", "float", 5.0,
      "retry backoff base delay in ms", lo=0.0, hi=60_000.0)
_knob("robust.retry_max_ms", "PATHWAY_RETRY_MAX_MS", "float", 200.0,
      "retry backoff max delay in ms", lo=0.0, hi=600_000.0)
_knob("robust.retry_seed", "PATHWAY_RETRY_SEED", "int", 0,
      "retry jitter seed (replayable soaks)", lo=0, hi=2**31 - 1)
_knob("robust.breaker_threshold", "PATHWAY_BREAKER_THRESHOLD", "int", 5,
      "consecutive failures that open a circuit breaker", lo=1, hi=10_000)
_knob("robust.breaker_reset_s", "PATHWAY_BREAKER_RESET_S", "float", 30.0,
      "open-breaker half-open probe delay in seconds", lo=0.0, hi=86_400.0)

# process cluster (parallel/distributed.py)
_knob("parallel.processes", "PATHWAY_PROCESSES", "int", 1,
      "process-cluster size", lo=1, hi=65_536)
_knob("parallel.process_id", "PATHWAY_PROCESS_ID", "int", 0,
      "this process's cluster rank", lo=0, hi=65_535)
_knob("parallel.coordinator_address", "PATHWAY_COORDINATOR_ADDRESS", "str",
      "", "control-plane coordinator host:port")
_knob("parallel.first_port", "PATHWAY_FIRST_PORT", "str", "",
      "first port of the spawned cluster's port range")
_knob("parallel.exchange_host", "PATHWAY_EXCHANGE_HOST", "str", "",
      "advertised host for the TCP exchange plane")
_knob("parallel.exchange_heartbeat_s", "PATHWAY_EXCHANGE_HEARTBEAT",
      "float", 2.0, "exchange-plane heartbeat interval in seconds",
      lo=0.05, hi=3600.0)
_knob("parallel.exchange_heartbeat_timeout_s",
      "PATHWAY_EXCHANGE_HEARTBEAT_TIMEOUT", "float", 8.0,
      "peer-lost declaration timeout in seconds", lo=0.1, hi=86_400.0)

# device meshes (parallel/mesh.py)
_knob("parallel.data_shards", "PATHWAY_TPU_DATA_SHARDS", "int", 0,
      "mesh data-axis size override (0 = derive)", lo=0, hi=65_536)
_knob("parallel.model_shards", "PATHWAY_TPU_MODEL_SHARDS", "int", 0,
      "mesh model-axis size override (0 = derive)", lo=0, hi=65_536)

# runtime tripwires (ops/donation_guard.py, ops/recompile_guard.py)
_knob("ops.donation_guard", "PATHWAY_DONATION_GUARD", "bool", False,
      "runtime in-place-write tripwire over handed-out snapshots")
_knob("ops.donation_guard_strict", "PATHWAY_DONATION_GUARD_STRICT", "bool", False,
      "in-place-write tripwire raises instead of degrade-and-count", auto_pytest=True)
_knob("ops.recompile_limit", "PATHWAY_RECOMPILE_LIMIT", "int", 128,
      "shape-signature budget per callable", lo=1, hi=1_000_000)
_knob("ops.recompile_strict", "PATHWAY_RECOMPILE_STRICT", "bool", False,
      "recompile tripwire raises instead of warn-once", auto_pytest=True)

# hot-path static analysis and the runtime lock-order sanitizer (analysis/)
_knob("analysis.cache_dir", "PATHWAY_ANALYSIS_CACHE", "str", "",
      "incremental analyzer cache directory (empty = cold runs)")
_knob("analysis.lock_sanitizer", "PATHWAY_LOCK_SANITIZER", "bool", False,
      "runtime lock-order sanitizer (proxies pathway locks)")
_knob("analysis.lock_sanitizer_raise", "PATHWAY_LOCK_SANITIZER_RAISE",
      "bool", False, "sanitizer raises on a would-be inversion",
      auto_pytest=True)
_knob("analysis.lock_hold_ms", "PATHWAY_LOCK_HOLD_MS", "float", 0.0,
      "sanitizer lock-hold budget in ms (0 = off)", lo=0.0, hi=60_000.0)

# the host libraries (native/, models/tokenizer.py, kernels/host.py)
_knob("native.disable", "PATHWAY_TPU_DISABLE_NATIVE", "bool", False,
      "answer with native/'s plain versions and the Python tokenizer instead of the host libraries")

# engine (internals/config.py)
_knob("engine.commit_duration_ms", "PATHWAY_COMMIT_DURATION_MS", "int", 100,
      "dataflow commit-tick duration in ms", lo=1, hi=3_600_000)
_knob("engine.terminate_on_error", "PATHWAY_TERMINATE_ON_ERROR", "bool",
      True, "tear the graph down on an operator error")
_knob("engine.runtime_typechecking", "PATHWAY_RUNTIME_TYPECHECKING", "bool",
      False, "per-row schema checks in the engine")

# question answering and chat (xpacks/llm/llms.py, question_answering.py)
_knob("chat.continuous", "PATHWAY_CHAT_CONTINUOUS", "bool", False,
      "route xpack chat through the continuous decoder")
_knob("qa.rerank_coalesce", "PATHWAY_QA_RERANK_COALESCE", "bool", False,
      "coalesce concurrent QA rerank dispatches via SharedBatcher")

# the engine's metrics server (internals/metrics.py through internals/config.py)
_knob("observe.metrics_port", "PATHWAY_METRICS_PORT", "int", 20000,
      "/metrics HTTP port", lo=1, hi=65_535)
_knob("observe.metrics_host", "PATHWAY_METRICS_HOST", "str", "127.0.0.1",
      "/metrics bind host")

# the process config's monitoring endpoint and license key (internals/config.py,
# written by pw.set_monitoring_config / pw.set_license_key)
_knob("observe.monitoring_server", "PATHWAY_MONITORING_SERVER", "str", "",
      "OTLP endpoint for span export (empty = off)")
_knob("license.key", "PATHWAY_LICENSE_KEY", "str", "",
      "accepted and ignored (this framework is fully open)")

# command line (cli.py)
_knob("cli.spawn_args", "PATHWAY_SPAWN_ARGS", "str", "",
      "extra args for `pathway spawn-from-env`")

# persistence (internals/run.py through internals/config.py; internals/udfs.py DiskCache)
_knob("persistence.mode", "PATHWAY_PERSISTENCE_MODE", "str", "",
      "persistence mode (empty = off)")
_knob("persistence.replay_storage", "PATHWAY_REPLAY_STORAGE", "str", "",
      "replay storage URI (empty = off)")
_knob("persistence.storage", "PATHWAY_PERSISTENT_STORAGE", "str", "",
      "snapshot storage URI (empty = off)")
_knob("persistence.snapshot_interval_ms", "PATHWAY_SNAPSHOT_INTERVAL_MS",
      "int", 60_000, "snapshot cadence in ms", lo=1, hi=86_400_000)


def _warn_once(tag: str, msg: str, *args: Any) -> None:
    with _warned_lock:
        if tag in _warned:
            return
        _warned.add(tag)
    _log.warning(msg, *args)


def _clamp_num(knob: Knob, value: float) -> float:
    out = value
    if knob.lo is not None and out < knob.lo:
        out = knob.lo
    if knob.hi is not None and out > knob.hi:
        out = knob.hi
    if out != value:
        _warn_once(
            f"clamp:{knob.env}:{value}",
            "%s=%r outside declared bounds [%s, %s]; clamped to %r",
            knob.env, value, knob.lo, knob.hi, out,
        )
    return out


def _parse(knob: Knob, raw: Optional[str]) -> Any:
    """Raw environment string -> typed, clamped value; never raises."""
    if raw is None and knob.auto_pytest:
        return "PYTEST_CURRENT_TEST" in os.environ
    if raw is not None:
        s = raw.strip()
        if knob.kind == "bool":
            if s.lower() in _TRUE:
                return True
            if s.lower() in _FALSE:
                return False
            _warn_once(f"bool:{knob.env}:{s}", "%s=%r is not a recognized bool; using default %r",
                       knob.env, raw, knob.default)
        elif knob.kind in ("int", "float"):
            try:
                num = int(s) if knob.kind == "int" else float(s)
            except ValueError:
                _warn_once(f"num:{knob.env}:{s}", "%s=%r does not parse as %s; using default %r",
                           knob.env, raw, knob.kind, knob.default)
            else:
                out = _clamp_num(knob, num)
                return int(out) if knob.kind == "int" else float(out)
        elif knob.kind == "enum":
            if s.lower() in (knob.choices or ()):
                return s.lower()
            _warn_once(f"enum:{knob.env}:{s}", "%s=%r not in %s; using default %r",
                       knob.env, raw, knob.choices, knob.default)
        else:  # str
            return raw
    if knob.kind in ("int", "float"):
        out = _clamp_num(knob, knob.default)
        return int(out) if knob.kind == "int" else float(out)
    return knob.default


def _spec(key: str) -> Knob:
    knob = _REGISTRY.get(key)
    if knob is None:
        raise UnknownKnobError(key)
    return knob


def _cached(cache_key: str, knob: Knob, raw: Optional[str]) -> Any:
    hit = _cache.get(cache_key)
    if hit is not None and hit[0] == raw:
        return hit[1]
    value = _parse(knob, raw)
    _cache[cache_key] = (raw, value)
    return value


def get(key: str, fallback: Any = None) -> Any:
    """The typed value of one declared knob: the tuner's override
    (dynamic knobs only), else the environment, else ``fallback`` (a
    caller's site default, clamped like the environment), else the
    declared default.  ``auto_pytest`` bools are parsed on every call."""
    ov = _overrides.get(key)
    if ov is not None:
        return ov
    knob = _spec(key)
    raw = os.environ.get(knob.env)
    if knob.auto_pytest:
        return _parse(knob, raw)
    if raw is None and fallback is not None:
        if knob.kind in ("int", "float"):
            out = _clamp_num(knob, fallback)
            return int(out) if knob.kind == "int" else float(out)
        return fallback
    return _cached(key, knob, raw)


def get_site(key: str, site: str) -> Any:
    """Per-site override: ``get_site("robust.retry_attempts",
    "cache.get")`` reads ``PATHWAY_RETRY_ATTEMPTS_CACHE_GET`` (site
    upper-cased, ``.``/``-`` -> ``_``) under the same declaration,
    falling back to the base knob."""
    knob = _spec(key)
    if not knob.site_prefix:
        return get(key)
    env_name = knob.site_prefix + site.upper().replace(".", "_").replace("-", "_")
    raw = os.environ.get(env_name)
    if raw is None:
        return get(key)
    return _cached(f"{key}@{env_name}", knob, raw)


def set(key: str, value: Any) -> Any:  # noqa: A001 - the module is the namespace
    """Adjust a ``dynamic`` knob online (the tuner's one write path):
    the value is clamped to the declared bounds and layered over the
    environment; returns the applied value.  A ``static`` knob raises
    ``StaticKnobError``."""
    knob = _spec(key)
    if knob.mutability != DYNAMIC:
        raise StaticKnobError(
            f"knob {key} ({knob.env}) is static by declaration; the tuner may only adjust dynamic-class knobs"
        )
    if knob.kind == "int":
        applied: Any = int(_clamp_num(knob, int(value)))
    elif knob.kind == "float":
        applied = float(_clamp_num(knob, float(value)))
    else:
        applied = _parse(knob, str(value))
    with _overrides_lock:
        _overrides[key] = applied
    return applied


def clear_override(key: str) -> None:
    """Drop one override: the knob reverts to the environment / default."""
    with _overrides_lock:
        _overrides.pop(key, None)


def clear_overrides() -> None:
    with _overrides_lock:
        _overrides.clear()


def overrides() -> Dict[str, Any]:
    """Snapshot of the live override layer (key -> applied value)."""
    with _overrides_lock:
        return dict(_overrides)


def snapshot() -> Dict[str, Any]:
    """{key: effective typed value} for every declared knob."""
    return {key: get(key) for key in sorted(_REGISTRY)}


def registry() -> Dict[str, Knob]:
    """The declarations, read-only by convention."""
    return dict(_REGISTRY)


def knobs() -> List[Knob]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def load() -> Dict[str, Any]:
    """Parse every declared knob from the current environment into the
    cache and return the snapshot.  Chaos site ``config.load``: a fault
    serves the last-good values (a warning and a counter, never a
    failed serve)."""
    from . import observe
    from .robust import inject

    try:
        inject.fire("config.load")
    except Exception as exc:  # noqa: BLE001 - a poisoned reload degrades to the last-good values
        _warn_once(f"load:{type(exc).__name__}", "config.load failed (%r); serving last-good knob values", exc)
        observe.counter("pathway_config_load_failures_total").inc()
        return snapshot()
    for key, knob in _REGISTRY.items():
        if not knob.auto_pytest:
            raw = os.environ.get(knob.env)
            _cache[key] = (raw, _parse(knob, raw))
    return snapshot()


def describe() -> List[Dict[str, Any]]:
    """One JSON-able row per knob: the CLI's and the README's table."""
    rows = []
    for knob in knobs():
        bounds = ""
        if knob.lo is not None or knob.hi is not None:
            bounds = f"[{knob.lo!r}, {knob.hi!r}]"
        elif knob.choices:
            bounds = "|".join(knob.choices)
        rows.append({
            "key": knob.key,
            "env": knob.env + ("(_<SITE>)" if knob.site_prefix else ""),
            "type": knob.kind,
            "default": knob.default_doc(),
            "bounds": bounds,
            "mutability": knob.mutability,
            "doc": knob.doc,
        })
    return rows


_COLUMNS = ("key", "env", "type", "default", "bounds", "mutability", "doc")


def markdown_table() -> str:
    """The knob table in Markdown, the form the README embeds."""
    lines = [
        "| key | env | type | default | bounds | mutability | doc |",
        "| --- | --- | --- | --- | --- | --- | --- |",
    ]
    for r in describe():
        lines.append("| `{key}` | `{env}` | {type} | {default} | {bounds} | {mutability} | {doc} |".format(**r))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.config", description="The declarative PATHWAY_* knob table of the port."
    )
    parser.add_argument("--format", choices=("text", "json", "markdown"), default="text", dest="fmt",
                        help="table output format")
    args = parser.parse_args(argv)
    if args.fmt == "json":
        print(json.dumps(describe(), indent=1, sort_keys=True))
    elif args.fmt == "markdown":
        print(markdown_table())
    else:
        rows = describe()
        widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in _COLUMNS[:-1]}
        print("  ".join(c.ljust(widths[c]) for c in _COLUMNS[:-1]) + "  doc")
        for r in rows:
            print("  ".join(str(r[c]).ljust(widths[c]) for c in _COLUMNS[:-1]) + "  " + r["doc"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
