"""The port's hot-path analysis (``pathway_tpu_torch/analysis``) against the
reference's (``pathway_tpu/analysis``), and the tier-1 gate over the port.

- Idiom-free fixtures (locks, pickles, handles, caches, streams, spans,
  the pragma grammar, knob reads, lock graphs) go through both packages'
  ``analyze_source`` and give the same ``(rule, line, col, suppressed)``
  findings; cross-module lock graphs in ``tmp_path`` likewise through
  ``analyze_paths``.
- Each torch-idiom rule flags its planted fixture and is quiet on the
  clean twin.  The fixtures are twins of the reference's JAX fixtures
  (``tests/test_analysis.py``) with the same line layout: the lines the
  port flags are the lines the reference flags in the JAX original.
- SARIF against a golden file, the cache cold == warm, the CLI's exit
  codes, stale pragmas.
- The gate: the whole ``pathway_tpu_torch`` tree has no unsuppressed
  finding and no stale pragma; the declared-transfer, knob-waiver and
  rank-exception tables mirror their pragmas; every lock site of a module
  ranks as its reference twin's does.
"""

from __future__ import annotations

import ast
import json
import os
import re
import textwrap

import pytest

from pathway_tpu import analysis as ref_analysis
from pathway_tpu_torch.analysis import analyze_paths, analyze_source, main
from pathway_tpu_torch.analysis.core import stale_pragma_findings

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO_ROOT, "pathway_tpu_torch")
_SERVE_HDR = "# pathway: serve-path\n"


def _src(text: str) -> str:
    return textwrap.dedent(text)


def _key(findings):
    return sorted((f.rule, f.line, f.col, f.suppressed) for f in findings)


def _live(findings, rule: str):
    return [f for f in findings if f.rule == rule and not f.suppressed]


# -- idiom-free fixtures: identical findings from both packages ---------------

_IDIOM_FREE = {
    "trailing_pragma": ("""
        import pickle
        import threading

        def f(lock, a, b):
            with lock:
                x = pickle.dumps(a)  # pathway: allow(lock-discipline): fixture — reviewed
                y = pickle.loads(b)
            return x, y
    """, "fixtures/mod.py"),
    "pragma_whole_block": ("""
        import pickle
        import threading

        def f(lock, a, b):
            with lock:  # pathway: allow(lock-discipline): fixture — proven safe here
                x = pickle.dumps(a)
                return pickle.loads(x)
    """, "fixtures/mod.py"),
    "pragma_missing_reason": ("""
        import pickle
        import threading

        def f(lock, a):
            with lock:  # pathway: allow(lock-discipline)
                return pickle.dumps(a)
    """, "fixtures/mod.py"),
    "handle_completion": ("""
        import threading

        class Scheduler:
            def __init__(self):
                self._qlock = threading.Lock()

            def demux(self, pipe, q):
                with self._qlock:
                    handle = pipe.submit([q])
                    rows = handle()
                    handle.advance()
                return rows

            def wait_all(self, tickets):
                with self._qlock:
                    ticket = tickets.pop()
                    return ticket.result(5.0)
    """, "fixtures/mod.py"),
    "executor_futures": ("""
        import threading

        class Runner:
            def __init__(self):
                self._lock = threading.Lock()

            def run(self, job):
                with self._lock:
                    fut = self._pool.submit(job)
                    other = self.executor.submit(job)
                    return fut.result(), other.result()
    """, "fixtures/mod.py"),
    "future_handoff": ("""
        import threading

        class Scheduler:
            def __init__(self):
                self._qlock = threading.Lock()
                self._pending = []

            def dispatch(self, pipe, batch):
                handle = pipe.submit(batch)
                with self._qlock:
                    self._pending.append(handle)
                return handle

            def wait(self, handle):
                return handle()
    """, "fixtures/mod.py"),
    "forward_getters": ("""
        import threading

        class ForwardIndex:
            def __init__(self):
                self._lock = threading.Lock()

            def gather(self, qtok, slots):
                with self._lock:
                    fn = self._maxsim_fn(4, 32, 16, 8)
                    return fn(qtok, slots)

            def gather_off(self, qtok, slots):
                with self._lock:
                    fn = self._maxsim_fn(4, 32, 16, 8)
                return fn(qtok, slots)
    """, "fixtures/mod.py"),
    "slot_pool_getters": ("""
        import threading

        class Engine:
            def __init__(self):
                self._pool_lock = threading.Lock()

            def step(self, tok, pos):
                with self._pool_lock:
                    fn = self._slot_step_fn(8, 64, 4)
                    return fn(self._pk, self._pv, tok, pos)

            def spec(self, toks, pos):
                with self._pool_lock:
                    vfn = self._slot_verify_fn(8, 64, 4)
                    dfn = self._slot_draft_fn(8, 64, 3, 1)
                drafts = dfn(self._pk, self._pv, toks, pos)
                return vfn(self._pk, self._pv, drafts, pos)
    """, "fixtures/mod.py"),
    "sharded_getters": ("""
        import threading

        from pkg.robust import retry_call

        class ShardedServe:
            def fan_out(self, z, B, K):
                outs = []
                for s, child in enumerate(self.shards):
                    with child._lock:
                        fn, n_slotspace = self._shard_search_fn(child, B, K, 0)
                        out = retry_call("shard.search", fn, z)
                    outs.append(out)
                mfn = self._merge_fn(len(outs), B, K)
                return mfn(*outs)
    """, "fixtures/mod.py"),
    "observability_under_lock": ("""
        import threading

        from pkg.observe import hbm, slo

        class Scheduler:
            def __init__(self):
                self._qlock = threading.Lock()

            def admit(self, req):
                with self._qlock:
                    doc = slo.evaluate()
                    usage = hbm.sample()
                    self._queue.append(req)
                return doc, usage

            def admit_off(self, req):
                doc = slo.evaluate()
                with self._qlock:
                    self._queue.append(req)
                return doc
    """, "fixtures/mod.py"),
    "cache_access_under_lock": ("""
        import threading

        class Scheduler:
            def __init__(self):
                self._qlock = threading.Lock()

            def submit(self, items, k):
                with self._qlock:
                    rows = self._result_cache.get_rows(items, k)
                return rows

            def submit_off(self, items, k):
                rows = self._result_cache.get_rows(items, k)
                with self._qlock:
                    self.stats["cache_hits"] += 1
                return rows
    """, "fixtures/mod.py"),
    "stream_io_under_lock": ("""
        import threading

        class Link:
            def __init__(self):
                self._conn_lock = threading.Lock()

            def send_bad(self, msg):
                with self._conn_lock:
                    self.stream.send(msg)

            def send_good(self, msg):
                with self._conn_lock:
                    stream = self.stream
                stream.send(msg)
    """, "fixtures/mod.py"),
    "span_across_lock": (_SERVE_HDR + """
import threading


class Pipe:
    def __init__(self):
        self._lock = threading.Lock()

    def submit(self, tracer, q):
        with tracer.span("stage1"):
            with self._lock:
                fn = self._fns.get(q)
        return fn

    def f(self, tracer):
        with tracer.span("stage1"), self._lock:
            pass

    def g(self, tracer):
        with self._lock, tracer.span("work"):
            pass

    def h(self, tracer):
        with tracer.span("x"):  # pathway: allow(lock-discipline): fixture — uncontended by construction
            with self._lock:
                pass
""", "fixtures/serve.py"),
    "get_or_compute": ("""
        import pickle
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self._inflight = {}

            def get_or_compute(self, key, compute):
                blob = self.backend.get(key)
                if blob is not None:
                    return pickle.loads(blob)
                with self._lock:
                    waiter = self._inflight.get(key)
                    if waiter is None:
                        self._inflight[key] = threading.Event()
                value = compute()
                self.backend.put(key, pickle.dumps(value))
                return value

            def held(self, key, compute):
                with self._lock:
                    value = compute()
                    blob = pickle.dumps(value)
                return blob
    """, "fixtures/mod.py"),
    "fanout_booking": (_SERVE_HDR + """
from pkg.ops.dispatch_counter import record_dispatch, record_fetch


def serve_scatter(links, msg):
    record_dispatch("fabric.scatter")
    for link in links:
        link.send_request(msg)
    return links


def serve_scatter_ok(links, msg):
    record_dispatch("fabric.scatter", shards=len(links))
    for link in links:
        link.send_request(msg)
    record_fetch("fabric.gather", shards=len(links))
    return links


def absorb(links, docs):
    for link in links:
        link.send_request(docs)
    return len(docs)
""", "fixtures/serve.py"),
    "three_lock_cycle": ("""
        import threading

        class A:
            def __init__(self):
                self._alock = threading.Lock()
                self._block = threading.Lock()
                self._clock = threading.Lock()

            def f(self):
                with self._alock:
                    with self._block:
                        pass

            def g(self):
                with self._block:
                    with self._clock:
                        pass

            def h(self):
                with self._clock:
                    with self._alock:
                        pass
    """, "fixtures/cyc3.py"),
    "cond_wait_second_lock": ("""
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition()

            def f(self):
                with self._lock:
                    with self._cv:
                        self._cv.wait()

        class Sched:
            def __init__(self):
                self._qlock = threading.Lock()
                self._cond = threading.Condition(self._qlock)

            def collect(self):
                with self._cond:
                    self._cond.wait(0.1)
    """, "fixtures/wait.py"),
    "helper_abba": ("""
        import threading

        class P:
            def __init__(self):
                self._alock = threading.Lock()
                self._block = threading.Lock()

            def f(self):
                with self._alock:
                    self._take_b()

            def _take_b(self):
                with self._block:
                    pass

            def g(self):
                with self._block:
                    self._take_a()

            def _take_a(self):
                with self._alock:
                    pass
    """, "fixtures/helpers.py"),
    "self_deadlock_lock": ("""
        import threading

        class P:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    """, "fixtures/selfdl.py"),
    "self_reentry_rlock": ("""
        import threading

        class P:
            def __init__(self):
                self._lock = threading.RLock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    """, "fixtures/selfdl.py"),
    "planted_abba": ("""
        import threading

        class Planted:
            def __init__(self):
                self._alock = threading.Lock()
                self._block = threading.Lock()

            def forward(self):
                with self._alock:
                    with self._block:
                        pass

            def backward(self):
                with self._block:
                    with self._alock:
                        pass
    """, "fixtures/planted.py"),
    "param_coercion_under_lock": ("""
        import threading

        import numpy as np

        class LshIndex:
            def __init__(self):
                self._lock = threading.Lock()

            def add(self, keys, vectors):
                with self._lock:
                    vectors = np.asarray(vectors, np.float32)
                    self._rows = vectors

            def add_off(self, keys, vectors):
                vectors = np.asarray(vectors, np.float32)
                with self._lock:
                    self._rows = vectors
    """, "fixtures/lsh.py"),
    "device_producer": ("""
        import numpy as np

        class Adapter:
            def _embed(self, values):
                texts = [str(v) for v in values]
                return list(np.asarray(self.embedder.encode(texts), np.float32))

        def pack(payload):
            return np.asarray(payload.encode("utf-8"))
    """, "fixtures/adapter.py"),
    "knob_raw_reads": ("""
        import os
        from os import getenv

        A = os.environ.get("PATHWAY_FIXTURE_A", "0")
        B = os.getenv("PATHWAY_FIXTURE_B")
        C = getenv("PATHWAY_FIXTURE_C")
        D = os.environ["PATHWAY_FIXTURE_D"]
        E = "PATHWAY_FIXTURE_E" in os.environ
        env = os.environ
        X = env.get("PATHWAY_FIXTURE_ALIAS", "1")

        def _env_int(name, default):
            try:
                return int(os.environ.get(name, str(default)))
            except ValueError:
                return default

        LIMIT = _env_int("PATHWAY_FIXTURE_LIMIT", 8)
    """, "fixtures/mod.py"),
    "knob_escalations": (_SERVE_HDR + """
import os
import threading

_lock = threading.Lock()


def dispatch(q):
    window = float(os.environ.get("PATHWAY_FIXTURE_WIN", "2000"))
    return q, window


def f():
    with _lock:
        return os.environ.get("PATHWAY_FIXTURE_LOCKED", "0")
""", "fixtures/serve.py"),
    "knob_declared_and_undeclared": ('''
        """Module doc: the old PATHWAY_FIXTURE_HISTORIC knob is gone."""
        import os

        from pkg import config

        KNOB = "PATHWAY_FIXTURE_NOWHERE"
        X = config.get("serve.not_a_real_knob")
        W = config.get("serve.coalesce_us")
        B = config.get("serve.max_batch")
        NAME = "PATHWAY_SERVE_COALESCE_US"
        SITE = config.get_site("robust.retry_attempts", "FIXTURE")
        FAMILY = "PATHWAY_RETRY_ATTEMPTS_EXCHANGE"
        ANALYSIS = config.get("analysis.lock_sanitizer")
        Y = os.environ.get("PATHWAY_SERVE_COALESCE_US")  # pathway: allow(knob-discipline): fixture — reviewed
    ''', "fixtures/mod.py"),
}


@pytest.mark.parametrize("name", sorted(_IDIOM_FREE))
def test_idiom_free_fixture_findings_equal_the_reference(name):
    src, path = _IDIOM_FREE[name]
    src = _src(src)
    mine = analyze_source(src, path)
    theirs = ref_analysis.analyze_source(src, path)
    assert _key(mine) == _key(theirs)


_TREES = {
    # an observe/ module holding its lock while a helper takes a
    # scheduler-rank lock: interprocedural AND cross-module
    "rank_inversion_across_modules": {
        "observe/histo.py": """
            import threading
            _obs_lock = threading.Lock()
            def rec(sched):
                with _obs_lock:
                    sched.admit_probe()
        """,
        "serve/scheduler.py": """
            import threading
            class S:
                def __init__(self):
                    self._qlock = threading.Lock()
                def admit_probe(self):
                    with self._qlock:
                        pass
        """,
    },
    "pragma_waives_rank_exception": {
        "cache/tier.py": """
            import threading
            class Tier:
                def __init__(self):
                    self._lock = threading.Lock()
                def fill_probe(self, sched):
                    with self._lock:  # pathway: allow(lock-order): fixture — reviewed rank exception cache<scheduler
                        sched.admit_probe()
        """,
        "serve/scheduler.py": """
            import threading
            class S:
                def __init__(self):
                    self._qlock = threading.Lock()
                def admit_probe(self):
                    with self._qlock:
                        pass
        """,
    },
    # a lock defined in a cross-module base class is one graph node
    "inherited_lock_one_node": {
        "serve/sched.py": """
            import threading

            class Base:
                def __init__(self):
                    self._qlock = threading.Lock()
                    self._other_lock = threading.Lock()

                def fwd(self):
                    with self._qlock:
                        with self._other_lock:
                            pass
        """,
        "serve/decode.py": """
            import threading

            from .sched import Base

            class Engine(Base):
                def bwd(self):
                    with self._other_lock:
                        with self._qlock:
                            pass
        """,
    },
    "knob_registry_and_dead_knob": {
        "registry.py": """
            import os

            def _knob(key, env, kind, default, doc, **kw):
                return os.environ.get(env)

            _knob("fix.live", "PATHWAY_FIXTURE_LIVE", "int", 1, "read below")
            _knob("fix.dead", "PATHWAY_FIXTURE_DEAD", "int", 1, "never read")
        """,
        "reader.py": """
            from . import config

            X = config.get("fix.live")
        """,
    },
}


def _tree_key(findings):
    """(rule, path below the package directory, line, col, suppressed)."""
    return sorted(
        (f.rule, f.path.replace(os.sep, "/").split("/pkgroot/", 1)[1].split("/", 1)[1], f.line, f.col, f.suppressed)
        for f in findings
    )


@pytest.mark.parametrize("name", sorted(_TREES))
def test_cross_module_findings_equal_the_reference(name, tmp_path):
    """The same modules under each package's directory name give the same
    whole-program findings (module ids drop each package's own prefix)."""
    out = {}
    for pkg, analyze in (("pathway_tpu", ref_analysis.analyze_paths), ("pathway_tpu_torch", analyze_paths)):
        root = tmp_path / "pkgroot" / pkg
        for rel, text in _TREES[name].items():
            (root / os.path.dirname(rel)).mkdir(parents=True, exist_ok=True)
            (root / rel).write_text(_src(text))
        out[pkg] = _tree_key(analyze([str(root)]))
    assert out["pathway_tpu_torch"] == out["pathway_tpu"]
    assert any(not s for *_r, s in out["pathway_tpu_torch"]) or name == "pragma_waives_rank_exception"


# -- torch-idiom twins: each rule flags its fixture, quiet on the clean twin --
#
# (rule, the reference's JAX fixture, the port's torch twin, path, expect
# findings).  The twin keeps the JAX fixture's line layout, so the lines
# flagged must be the same.

_LOCK_BAD_JAX = """
    import pickle
    import threading

    import jax
    import jax.numpy as jnp
    import numpy as np

    @jax.jit
    def _score(x):
        return x * 2

    class Index:
        def __init__(self):
            self._lock = threading.Lock()

        def search(self, q):
            with self._lock:
                out = _score(q)
                scores = np.asarray(out)
                blob = pickle.dumps(scores)
                jax.device_put(scores)
                out.block_until_ready()
            return blob
"""
_LOCK_BAD_TORCH = """
    import pickle
    import threading

    import torch
    from pathway_tpu_torch.ops.recompile_guard import guarded_jit
    import numpy as np

    @guarded_jit
    def _score(x):
        return x * 2

    class Index:
        def __init__(self):
            self._lock = threading.Lock()

        def search(self, q):
            with self._lock:
                out = _score(q)
                scores = np.asarray(out)
                blob = pickle.dumps(scores)
                torch.as_tensor(scores, device="cuda")
                torch.cuda.synchronize()
            return blob
"""
_LOCK_GOOD_JAX = """
    import pickle
    import threading

    import jax
    import numpy as np

    @jax.jit
    def _score(x):
        return x * 2

    class Index:
        def __init__(self):
            self._lock = threading.Lock()

        def search(self, q):
            with self._lock:
                snapshot = dict(self.state)
            out = _score(q)
            return pickle.dumps(np.asarray(out))
"""
_LOCK_GOOD_TORCH = """
    import pickle
    import threading

    from pathway_tpu_torch.ops.recompile_guard import guarded_jit
    import numpy as np

    @guarded_jit
    def _score(x):
        return x * 2

    class Index:
        def __init__(self):
            self._lock = threading.Lock()

        def search(self, q):
            with self._lock:
                snapshot = dict(self.state)
            out = _score(q)
            return pickle.dumps(out.cpu().numpy())
"""
_RETRY_JAX = """
    import threading

    import jax
    import numpy as np

    from pathway_tpu.robust import retry_call

    @jax.jit
    def _score(x):
        return x * 2

    class Index:
        def __init__(self):
            self._lock = threading.Lock()

        def search(self, q):
            with self._lock:
                out = retry_call("ivf.dispatch", _score, q)
                host = np.asarray(out)
            return host
"""
_RETRY_TORCH = """
    import threading

    from pathway_tpu_torch.ops.recompile_guard import guarded_jit
    import numpy as np

    from pathway_tpu_torch.robust import retry_call

    @guarded_jit
    def _score(x):
        return x * 2

    class Index:
        def __init__(self):
            self._lock = threading.Lock()

        def search(self, q):
            with self._lock:
                out = retry_call("ivf.search", _score, q)
                host = out.cpu()
            return host
"""
_CLOSURE_JAX = """
    import threading

    import jax
    import numpy as np

    @jax.jit
    def _score(x):
        return x * 2

    class Index:
        def __init__(self):
            self._lock = threading.Lock()

        def submit(self, q):
            with self._lock:
                out = _score(q)  # pathway: allow(lock-discipline): fixture — dispatch-only
                def complete():
                    return np.asarray(out)
            return complete
"""
_CLOSURE_TORCH = """
    import threading

    from pathway_tpu_torch.ops.recompile_guard import guarded_jit
    import numpy as np

    @guarded_jit
    def _score(x):
        return x * 2

    class Index:
        def __init__(self):
            self._lock = threading.Lock()

        def submit(self, q):
            with self._lock:
                out = _score(q)  # pathway: allow(lock-discipline): fixture — dispatch-only
                def complete():
                    return out.cpu().numpy()
            return complete
"""
_SUBSCRIPT_JAX = """
    import threading

    import jax
    import numpy as np

    @jax.jit
    def _score(x):
        return x

    def f(lock, q):
        with lock:
            out = _score(q)  # pathway: allow(lock-discipline): fixture — dispatch-only
            return np.asarray(out[0])
"""
_SUBSCRIPT_TORCH = """
    import threading

    from pathway_tpu_torch.ops.recompile_guard import guarded_jit
    import numpy as np

    @guarded_jit
    def _score(x):
        return x

    def f(lock, q):
        with lock:
            out = _score(q)  # pathway: allow(lock-discipline): fixture — dispatch-only
            return out[0].item()
"""
_WRAP_JAX = """
    import threading

    import jax

    from pathway_tpu.observe import profile

    @jax.jit
    def _kernel(x):
        return x * 2

    def serve(lock, q):
        with lock:
            fn = profile.wrap("serve.kernel", _kernel)
            return fn(q)
"""
_WRAP_TORCH = """
    import threading

    import torch

    from pathway_tpu_torch.observe import profile

    def _kernel(x):
        return x * 2

    # the port's profiler wraps its device steps: the binding dispatches
    def serve(lock, q):
        with lock:
            fn = profile.wrap("serve.kernel", _kernel)
            return fn(q)
"""
_SYNC_IN_DISPATCH_JAX = _SERVE_HDR + """
import jax
import numpy as np

@jax.jit
def _fused(x):
    return x

def serve(q):
    out = _fused(q)
    return np.asarray(out)  # blocking round trip, not submit/complete
"""
_SYNC_IN_DISPATCH_TORCH = _SERVE_HDR + """
from pathway_tpu_torch.ops.recompile_guard import guarded_jit
import numpy as np

@guarded_jit
def _fused(x):
    return x

def serve(q):
    out = _fused(q)
    return out.cpu()  # blocking round trip, not submit/complete
"""
_SUBMIT_COMPLETE_JAX = _SERVE_HDR + """
import jax
import numpy as np

@jax.jit
def _fused(x):
    return x

def submit(q):
    out = _fused(q)
    def complete():
        return np.asarray(out)
    return complete
"""
_SUBMIT_COMPLETE_TORCH = _SERVE_HDR + """
from pathway_tpu_torch.ops.recompile_guard import guarded_jit
import numpy as np

@guarded_jit
def _fused(x):
    return x

def submit(q):
    out = _fused(q)
    def complete():
        return out.cpu().numpy()
    return complete
"""
_FENCE_JAX = _SERVE_HDR + """
def rerank(model, pairs, out):
    scores = model.predict(pairs)
    out.block_until_ready()
    return scores
"""
_FENCE_TORCH = _SERVE_HDR + """
def rerank(model, pairs, out):
    scores = model.predict(pairs)
    torch.cuda.synchronize()
    return scores
"""
_BUDGET_JAX = _SERVE_HDR + """
import jax
import numpy as np

from pathway_tpu.ops.dispatch_counter import record_dispatch, record_fetch

@jax.jit
def _fused(x):
    return x

def submit(q):
    out = retry_call("serve.dispatch", _fused, q)  # missing record_dispatch
    def complete():
        return np.asarray(out)  # missing record_fetch
    return complete
"""
_BUDGET_TORCH = _SERVE_HDR + """
from pathway_tpu_torch.device import to_host
import numpy as np

from pathway_tpu_torch.ops.dispatch_counter import record_dispatch, record_fetch

# the fused step
def _fused(x):
    return x

def submit(q):
    fetch = retry_call("serve.dispatch", lambda: to_host(_fused(q)))  # missing record_dispatch
    def complete():
        return fetch()  # missing record_fetch
    return complete
"""
_BUDGET_OK_JAX = _SERVE_HDR + """
import jax
import numpy as np

from pathway_tpu.ops.dispatch_counter import record_dispatch, record_fetch

@jax.jit
def _fused(x):
    return x

def submit(q):
    out = _fused(q)
    record_dispatch("serve")
    def complete():
        arr = np.asarray(out)
        record_fetch("serve")
        return arr
    return complete
"""
_BUDGET_OK_TORCH = _SERVE_HDR + """
from pathway_tpu_torch.device import to_host
import numpy as np

from pathway_tpu_torch.ops.dispatch_counter import record_dispatch, record_fetch

# the fused step
def _fused(x):
    return x

def submit(q):
    fetch = retry_call("serve.dispatch", lambda: to_host(_fused(q)))
    record_dispatch("serve")
    def complete():
        arr = fetch()
        record_fetch("serve")
        return arr
    return complete
"""
_CACHE_WRAPPER_JAX = _SERVE_HDR + """
import jax
import numpy as np

from pathway_tpu.ops.dispatch_counter import record_dispatch, record_fetch
from pathway_tpu.robust import retry_call

class Serve:
    def _cached_embeddings(self, ids, mask):
        enc = self._encode_fn(ids.shape[0], ids.shape[1])
        z_m = retry_call("serve.dispatch", enc, self.params, ids, mask)
        return np.asarray(z_m)  # host fetch in the dispatch scope

    def _embeddings(self, ids, mask, n_real):
        enc = self._encode_fn(n_real, ids.shape[1])
        z_m = retry_call("serve.dispatch", enc, self.params, ids, mask)
        return z_m
"""
_CACHE_WRAPPER_TORCH = _SERVE_HDR + """
import torch
import numpy as np

from pathway_tpu_torch.ops.dispatch_counter import record_dispatch, record_fetch
from pathway_tpu_torch.robust import retry_call

class Serve:
    def _cached_embeddings(self, ids, mask):
        enc = self._encode_fn(ids.shape[0], ids.shape[1])
        z_m = retry_call("encoder.dispatch", enc, self.params, ids, mask)
        return z_m.cpu()  # host fetch in the dispatch scope

    def _embeddings(self, ids, mask, n_real):
        enc = self._encode_fn(n_real, ids.shape[1])
        z_m = retry_call("encoder.dispatch", enc, self.params, ids, mask)
        return z_m
"""
_RECOMPILE_JAX = """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _forward(x):
        return x * 2

    def encode(texts):
        return _forward(jnp.asarray(texts))  # shape tracks len(texts)

    def train_step(batch):
        # pathway: allow(recompile-hazard): fixture — one compile per train run
        return _forward(jnp.asarray(batch))
"""
_RECOMPILE_TORCH = """
    import torch
    from pathway_tpu_torch.ops.recompile_guard import guarded_jit

    @guarded_jit
    def _forward(x):
        return x * 2

    def encode(texts):
        return _forward(torch.as_tensor(texts))  # shape tracks len(texts)

    def train_step(batch):
        # pathway: allow(recompile-hazard): fixture — one signature per train run
        return _forward(torch.as_tensor(batch))
"""
_RECOMPILE_OK_JAX = """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathway_tpu.models.encoder import _bucket

    @jax.jit
    def _forward(x):
        return x * 2

    def encode(texts):
        b = _bucket(len(texts))
        padded = np.zeros((b, 4), np.float32)
        return _forward(jnp.asarray(padded))
"""
_RECOMPILE_OK_TORCH = """
    import torch
    from pathway_tpu_torch.ops.recompile_guard import guarded_jit
    import numpy as np

    from pathway_tpu_torch.models.encoder import _bucket

    @guarded_jit
    def _forward(x):
        return x * 2

    def encode(texts):
        b = _bucket(len(texts))
        padded = np.zeros((b, 4), np.float32)
        return _forward(torch.as_tensor(padded))
"""
# the port's census: the tripwire observes a bucketed key, the tensor keeps
# the raw length (ops/ivf.py's search shape); the clean twin pads to it
_CENSUS_TORCH = """
    import torch

    def search(self, queries, nq):
        self._tripwire.observe((_bucket(nq), 4))
        z = torch.from_numpy(queries).to(self.device)
        return _SEARCH(self, z)

    def search_padded(self, queries, nq):
        b = _bucket(nq)
        self._tripwire.observe((b, 4))
        padded = np.zeros((b, 4), np.float32)
        padded[:nq] = queries
        z = torch.from_numpy(padded).to(self.device)
        return _SEARCH(self, z)

    _SEARCH = profile.wrap("ivf.search", lambda index, *a: index._search_device(*a))
"""
_TRACED_JAX = """
    import threading

    import jax

    lock = threading.Lock()

    @jax.jit
    def _kernel(x):
        with lock:
            return x * 2
"""
_TRACED_TORCH = """
    import threading

    import torch

    lock = threading.Lock()

    @torch.compile
    def _kernel(x):
        with lock:
            return x * 2
"""
_GRAPH_CAPTURE_TORCH = """
    import threading

    import torch

    lock = threading.Lock()

    def capture(g, x):
        with torch.cuda.graph(g):
            with lock:
                return x * 2
"""
_DONATE_HDR_JAX = """
    import jax
    import numpy as np
    from functools import partial

    @partial(jax.jit, donate_argnums=(0, 1))
    def _scatter(slabs, bias, slots, vecs):
        return slabs, bias
"""
_DONATE_HDR_TORCH = """
    import torch
    import numpy as np
    from pathway_tpu_torch.ops import donation_guard

    # writes slabs in place (a parameter): a write helper
    def _scatter(slabs, bias, slots, vecs):
        slabs.index_copy_(0, slots, vecs)
"""
_DONATE_BAD_JAX = _DONATE_HDR_JAX + """
    class Index:
        def broken(self, slots, vecs):
            new_slabs, new_bias = _scatter(self._slabs, self._bias, slots, vecs)
            return np.asarray(self._slabs)  # reads the consumed buffer
"""
_DONATE_BAD_TORCH = _DONATE_HDR_TORCH + """
    class Index:
        def broken(self, slots, vecs):
            donation_guard.stamp("ivf.serve", self._slabs)
            self._slabs.view(-1, 4).index_copy_(0, slots, vecs)  # writes the handed-out snapshot
"""
_DONATE_GOOD_JAX = _DONATE_HDR_JAX + """
    class Index:
        def commit(self, slots, vecs):
            self._slabs, self._bias = _scatter(
                self._slabs, self._bias, slots, vecs
            )
            return self._slabs  # rebound from the call's results: live
"""
_DONATE_GOOD_TORCH = _DONATE_HDR_TORCH + """
    class Index:
        def commit(self, slots, vecs):
            donation_guard.stamp("ivf.serve", self._slabs)
            self._slabs = self._slabs.clone()
            self._slabs.index_copy_(0, slots, vecs)
            return self._slabs  # rebound before the write: the snapshot is intact
"""
_DONATE_IP_JAX = _DONATE_HDR_JAX + """
    from pathway_tpu.observe import profile
    from pathway_tpu.robust import retry_call

    _wrapped = profile.wrap("ivf.scatter", _scatter)

    class Index:
        def _commit(self, slabs, bias, slots, vecs):
            return _scatter(slabs, bias, slots, vecs)

        def via_helper(self, slots, vecs):
            out = self._commit(self._slabs, self._bias, slots, vecs)
            return float(self._slabs[0, 0])

        def via_retry(self, slots, vecs):
            out = retry_call("ivf.absorb", _scatter, self._slabs, self._bias, slots, vecs)
            return self._bias.sum()

        def via_wrap(self, slots, vecs):
            out = _wrapped(self._slabs, self._bias, slots, vecs)
            return self._slabs
"""
_DONATE_IP_TORCH = _DONATE_HDR_TORCH + """
    from pathway_tpu_torch.observe import profile
    from pathway_tpu_torch.robust import retry_call

    _wrapped = profile.wrap("ivf.scatter", _scatter)

    class Index:
        def _commit(self, slabs, bias, slots, vecs):
            return _scatter(slabs, bias, slots, vecs)

        def via_helper(self, slots, vecs):
            donation_guard.stamp("ivf.serve", self._slabs)
            out = self._commit(self._slabs, self._bias, slots, vecs)

        def via_retry(self, slots, vecs):
            donation_guard.stamp("ivf.serve", self._slabs)
            out = retry_call("ivf.absorb", _scatter, self._slabs, self._bias, slots, vecs)

        def via_wrap(self, slots, vecs):
            donation_guard.stamp("ivf.serve", self._slabs)
            out = _wrapped(self._slabs, self._bias, slots, vecs)
"""
_DONATE_HELPER_JAX = _DONATE_HDR_JAX + """
    class Index:
        def commit(self, slots, vecs):
            out = _scatter(self._slabs, self._bias, slots, vecs)
            self._note_commit()          # helper between donate and rebind
            self.stats["absorbs"] += 1   # unrelated attr is not a use
            self._slabs, self._bias = out
            return self._slabs
"""
_DONATE_HELPER_TORCH = _DONATE_HDR_TORCH + """
    class Index:
        def commit(self, slots, vecs):
            donation_guard.stamp("ivf.serve", self._slabs)
            self._note_commit()          # helper between snapshot and rebind
            self.stats["absorbs"] += 1   # an unrelated attr is not the snapshot
            self._slabs = self._slabs.clone()
            return _scatter(self._slabs, self._bias, slots, vecs)
"""
_STORED_SNAPSHOT_TORCH = _DONATE_HDR_TORCH + """
    class Index:
        def absorb(self, slots, vecs):
            self._served = self._keys_by_slot  # handed out to serves
            self._keys_by_slot[slots] = vecs  # written in place afterwards
            donation_guard.note_write("ivf.absorb", self._keys_by_slot)
"""
_SEEDED_JAX = """
    import numpy as np

    from pathway_tpu.ops.ivf import _absorb_scatter

    class Index:
        def commit(self, slots, vecs):
            out = _absorb_scatter(self._slabs, self._bias, slots, vecs)
            return np.asarray(self._slabs)
"""
_SEEDED_TORCH = """
    import numpy as np

    from pathway_tpu_torch.parallel.distributed import broadcast

    class Index:
        def commit(self, slots, vecs):
            donation_guard.stamp("ivf.serve", self._slabs)
            out = broadcast(self._slabs, 0)
"""
_ISNONE_JAX = """
    import jax

    @jax.jit
    def _fused(x):
        return x

    def guarded(q):
        out = _fused(q)
        if out is None:
            return None
        if out is not None and q is None:
            return out
        return out
"""
_ISNONE_TORCH = """
    from pathway_tpu_torch.ops.recompile_guard import guarded_jit

    @guarded_jit
    def _fused(x):
        return x

    def guarded(q):
        out = _fused(q)
        if out is None:
            return None
        if out is not None and q is None:
            return out
        return out
"""
_IMPLICIT_JAX = """
    import jax
    import numpy as np

    @jax.jit
    def _fused(x):
        return x

    def decide(q):
        out = _fused(q)
        if out > 0:                  # branch: implicit bool() sync
            return 1
        for v in out:                # iteration: per-element fetch
            print(v)
        return out.tolist()          # tolist: whole-array transfer

    def shapes(q):
        out = _fused(q)
        if len(out) > 0 and out.shape[0] > 2:
            return out
        return None
"""
_IMPLICIT_TORCH = """
    from pathway_tpu_torch.ops.recompile_guard import guarded_jit
    import numpy as np

    @guarded_jit
    def _fused(x):
        return x

    def decide(q):
        out = _fused(q)
        if out > 0:                  # branch: implicit bool() sync
            return 1
        for v in out:                # iteration: per-element fetch
            print(v)
        return out.tolist()          # tolist: whole-tensor transfer

    def shapes(q):
        out = _fused(q)
        if len(out) > 0 and out.shape[0] > 2:
            return out
        return None
"""
_BOOKED_JAX = """
    import jax
    import numpy as np

    from pathway_tpu.ops.dispatch_counter import record_fetch

    @jax.jit
    def _fused(x):
        return x

    def fetch(q):
        out = _fused(q)
        host = np.asarray(out)
        record_fetch("serve")
        return host.tolist()

    def unbooked(q):
        out = _fused(q)
        return np.asarray(out)
"""
_BOOKED_TORCH = """
    from pathway_tpu_torch.ops.recompile_guard import guarded_jit
    import numpy as np

    from pathway_tpu_torch.ops.dispatch_counter import record_fetch

    @guarded_jit
    def _fused(x):
        return x

    def fetch(q):
        out = _fused(q)
        host = out.cpu().numpy()
        record_fetch("serve")
        return host.tolist()

    def unbooked(q):
        out = _fused(q)
        return out.cpu()
"""
_NESTED_UPLOAD_JAX = _SERVE_HDR + """
import jax.numpy as jnp

def fan_out(shards, w):
    for s in shards:
        for t in range(4):
            push(jnp.asarray(w))
    return shards
"""
_NESTED_UPLOAD_TORCH = _SERVE_HDR + """
import torch

def fan_out(shards, w):
    for s in shards:
        for t in range(4):
            push(w.cuda())
    return shards
"""
_MUTATED_JAX = _SERVE_HDR + """
import jax.numpy as jnp

def accumulate(batch):
    rows = []
    outs = []
    for item in batch:
        rows.append(item)
        outs.append(jnp.asarray(rows))
    return outs
"""
_MUTATED_TORCH = _SERVE_HDR + """
import torch

def accumulate(batch):
    rows = []
    outs = []
    for item in batch:
        rows.append(item)
        outs.append(torch.as_tensor(rows, device="cuda"))
    return outs
"""
_UPLOAD_JAX = _SERVE_HDR + """
import jax
import jax.numpy as jnp

def fan_out(shards, z):
    outs = []
    for s in shards:
        outs.append(jax.device_put(z, s))  # loop-invariant
    return outs

def per_chunk(chunks):
    outs = []
    for c in chunks:
        c2 = c.reshape(-1)
        outs.append(jnp.asarray(c2))
    return outs

def waived(shards, z):
    outs = []
    for s in shards:
        outs.append(jax.device_put(z, s))  # pathway: allow(value-flow): fixture — per-TARGET scatter, mirrored in DECLARED_TRANSFERS
    return outs
"""
_UPLOAD_TORCH = _SERVE_HDR + """
import torch
import numpy as np

def fan_out(shards, z):
    outs = []
    for dev in shards:
        outs.append(z.to(dev))  # loop-invariant
    return outs

def per_chunk(chunks):
    outs = []
    for c in chunks:
        c2 = c.reshape(-1)
        outs.append(c2.cuda())
    return outs

def waived(shards, z):
    outs = []
    for dev in shards:
        outs.append(z.to(dev))  # pathway: allow(value-flow): fixture — per-TARGET scatter, mirrored in DECLARED_TRANSFERS
    return outs
"""

_TWINS = [
    ("lock_device_work", "lock-discipline", _LOCK_BAD_JAX, _LOCK_BAD_TORCH, "fixtures/mod.py", 5),
    ("lock_work_off_lock", "lock-discipline", _LOCK_GOOD_JAX, _LOCK_GOOD_TORCH, "fixtures/mod.py", 0),
    ("lock_retry_wrapper", "lock-discipline", _RETRY_JAX, _RETRY_TORCH, "fixtures/mod.py", 2),
    ("lock_closure_under_lock", "lock-discipline", _CLOSURE_JAX, _CLOSURE_TORCH, "fixtures/mod.py", 0),
    ("lock_subscripted_value", "lock-discipline", _SUBSCRIPT_JAX, _SUBSCRIPT_TORCH, "fixtures/mod.py", 1),
    ("lock_profile_wrap", "lock-discipline", _WRAP_JAX, _WRAP_TORCH, "fixtures/mod.py", 1),
    ("sync_in_dispatch_scope", "hidden-sync", _SYNC_IN_DISPATCH_JAX, _SYNC_IN_DISPATCH_TORCH, "fixtures/serve.py", 1),
    ("submit_complete", "hidden-sync", _SUBMIT_COMPLETE_JAX, _SUBMIT_COMPLETE_TORCH, "fixtures/serve.py", 0),
    ("predict_and_fence", "hidden-sync", _FENCE_JAX, _FENCE_TORCH, "fixtures/serve.py", 2),
    ("budget_unbooked", "hidden-sync", _BUDGET_JAX, _BUDGET_TORCH, "fixtures/serve.py", 2),
    ("budget_booked", "hidden-sync", _BUDGET_OK_JAX, _BUDGET_OK_TORCH, "fixtures/serve.py", 0),
    ("cache_wrapper", "hidden-sync", _CACHE_WRAPPER_JAX, _CACHE_WRAPPER_TORCH, "fixtures/serve.py", 2),
    ("recompile_unbucketed", "recompile-hazard", _RECOMPILE_JAX, _RECOMPILE_TORCH, "fixtures/mod.py", 1),
    ("recompile_bucketed", "recompile-hazard", _RECOMPILE_OK_JAX, _RECOMPILE_OK_TORCH, "fixtures/mod.py", 0),
    ("lock_in_traced_scope", "lock-order", _TRACED_JAX, _TRACED_TORCH, "fixtures/mod.py", 1),
    ("write_after_snapshot", "value-flow", _DONATE_BAD_JAX, _DONATE_BAD_TORCH, "fixtures/donate.py", 1),
    ("snapshot_rebound", "value-flow", _DONATE_GOOD_JAX, _DONATE_GOOD_TORCH, "fixtures/donate.py", 0),
    ("snapshot_interprocedural", "value-flow", _DONATE_IP_JAX, _DONATE_IP_TORCH, "fixtures/donate_ip.py", 3),
    ("snapshot_helper_between", "value-flow", _DONATE_HELPER_JAX, _DONATE_HELPER_TORCH, "fixtures/donate.py", 0),
    ("seeded_write_site", "value-flow", _SEEDED_JAX, _SEEDED_TORCH, "fixtures/seeded.py", 1),
    ("is_none_guard", "value-flow", _ISNONE_JAX, _ISNONE_TORCH, "fixtures/isnone.py", 0),
    ("implicit_transfers", "value-flow", _IMPLICIT_JAX, _IMPLICIT_TORCH, "fixtures/implicit.py", 3),
    ("booked_crossing", "value-flow", _BOOKED_JAX, _BOOKED_TORCH, "fixtures/implicit.py", 1),
    ("nested_loop_upload", "value-flow", _NESTED_UPLOAD_JAX, _NESTED_UPLOAD_TORCH, "fixtures/serve.py", 1),
    ("mutated_not_invariant", "value-flow", _MUTATED_JAX, _MUTATED_TORCH, "fixtures/serve.py", 0),
    ("redundant_upload", "value-flow", _UPLOAD_JAX, _UPLOAD_TORCH, "fixtures/serve.py", 1),
]


@pytest.mark.parametrize("case", _TWINS, ids=[t[0] for t in _TWINS])
def test_torch_idiom_twin_flags_the_reference_lines(case):
    _name, rule, jax_src, torch_src, path, n = case
    theirs = _live(ref_analysis.analyze_source(_src(jax_src), path), rule)
    mine = _live(analyze_source(_src(torch_src), path), rule)
    assert len(theirs) == n, [f.format() for f in theirs]
    assert sorted(f.line for f in mine) == sorted(f.line for f in theirs), [f.format() for f in mine]


@pytest.mark.parametrize(
    "src, rule, expect",
    [
        (_CENSUS_TORCH, "recompile-hazard", [7]),
        (_GRAPH_CAPTURE_TORCH, "lock-order", [10]),
        (_STORED_SNAPSHOT_TORCH, "value-flow", [13]),
        (_SERVE_HDR + _src("""
            import torch

            def launch_under_lock(self, ids):
                with self._lock:
                    def launch():
                        return step(self, ids)
                    return retry_call("ivf.search", launch)

            step = profile.wrap("serve.step", lambda fes, *a: fes._step(*a))
        """), "lock-discipline", [9]),
        (_SERVE_HDR + _src("""
            import torch

            def encode(self, ids):
                flat = torch.as_tensor([1, 2, 3])
                return self.pooled.index_select(0, flat.to(self.device))

            def encode_pinned(self, ids):
                flat = upload(np.asarray([1, 2, 3]), self.device)
                return self.pooled.index_select(0, flat)
        """), "hidden-sync", [7]),
        (_src("""
            import threading

            def f(lock, probe, q, slabs, bias):
                with lock:
                    scores = rescore_shortlist(probe, q, slabs, bias)
                    return bool(scores)
        """), "lock-discipline", [6, 7]),
    ],
    ids=["census_key_lies", "lock_in_graph_capture", "stored_snapshot_written", "launch_closure_under_lock",
         "blocking_upload", "kernel_wrapper_and_bool_under_lock"],
)
def test_port_only_rule_flags_its_fixture(src, rule, expect):
    """Torch idioms with no JAX counterpart: a census key that buckets a
    length its tensor keeps, a lock inside a CUDA-graph capture, a stored
    snapshot written in place, a launch closure under a lock, a blocking
    upload on a serve path (the pinned ``upload`` twin is clean), a kernel
    wrapper's launch and ``bool()`` of its result under a lock."""
    found = _live(analyze_source(_src(src), "fixtures/serve.py"), rule)
    assert sorted(f.line for f in found) == expect, [f.format() for f in found]


def test_lock_order_resolves_the_edges_the_runtime_saw_first(tmp_path):
    """Edges phase 26's runtime sanitizer observed on the card that the
    static graph first lacked: a helper imported by name, a
    ``profile.wrap`` binding run through a closure, a stored serve
    handle's call, a callable a constructor stored, and a method name
    that several classes define, read through the caller's imports."""
    from pathway_tpu_torch.analysis.lock_order import static_graph

    pkg = tmp_path / "pathway_tpu_torch"
    for rel, text in {
        "kernels/build.py": """
            import threading
            _lock = threading.Lock()
            def load_host(name):
                with _lock:
                    return name
        """,
        "kernels/host.py": """
            import threading
            from .build import load_host
            _lib_lock = threading.Lock()
            def host_lib():
                with _lib_lock:
                    return load_host("x")
        """,
        "observe/profile.py": """
            import threading
            _sites_lock = threading.Lock()
            def wrap(site, fn):
                def profiled(*a):
                    with _sites_lock:
                        pass
                    return fn(*a)
                return profiled
        """,
        "ops/serving.py": """
            import threading
            from ..observe import profile
            class FusedEncodeSearch:
                def __init__(self):
                    self._lock = threading.Lock()
                def submit(self, z):
                    step = _A if z is None else _B
                    with self._lock:
                        def launch():
                            return step(self, z)
                        out = retry_call("ivf.dispatch", launch)
                    def complete():
                        with self._lock:
                            return out
                    return complete
            _A = profile.wrap("serve.a", lambda fes, *a: fes)
            _B = profile.wrap("serve.b", lambda fes, *a: fes)
        """,
        "serve/scheduler.py": """
            import threading
            class _Batch:
                def __init__(self, handle):
                    self._handle = handle
                    self._block = threading.Lock()
                def result(self):
                    with self._block:
                        return self._handle()
            class _ReplicaHandle:
                def __init__(self, handle, release):
                    self._handle = handle
                    self._release = release
                    self._rlock = threading.Lock()
                def __call__(self):
                    with self._rlock:
                        self._release()
            class Scheduler:
                def __init__(self):
                    self._qlock = threading.Lock()
                def route(self, handle, r):
                    return _ReplicaHandle(handle, lambda: self._release_replica(r))
                def _release_replica(self, r):
                    with self._qlock:
                        pass
        """,
        "observe/histogram.py": """
            import threading
            class LatencyHistogram:
                def __init__(self):
                    self._lock = threading.Lock()
                def snapshot(self):
                    with self._lock:
                        return 1
            class EventRing:
                def __init__(self):
                    self._ring_lock = threading.Lock()
                def snapshot(self):
                    with self._ring_lock:
                        return 2
        """,
        "observe/slo.py": """
            import threading
            from .histogram import LatencyHistogram
            class SloEngine:
                def __init__(self):
                    self._lock = threading.Lock()
                def evaluate(self, series):
                    with self._lock:
                        return [h.snapshot() for h in series]
        """,
        "cache/store.py": """
            class Tier:
                def snapshot(self):
                    return 3
        """,
    }.items():
        (pkg / os.path.dirname(rel)).mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text(_src(text))
    edges = static_graph([str(pkg)])["edges"]
    assert ("kernels.host._lib_lock", "kernels.build._lock") in edges
    assert ("ops.serving.FusedEncodeSearch._lock", "observe.profile._sites_lock") in edges
    assert ("serve.scheduler._Batch._block", "ops.serving.FusedEncodeSearch._lock") in edges
    # a lambda a constructor stored in `self._release`, called later
    assert ("serve.scheduler._ReplicaHandle._rlock", "serve.scheduler.Scheduler._qlock") in edges
    # a method name three classes define: the one module the caller imports
    assert ("observe.slo.SloEngine._lock", "observe.histogram.LatencyHistogram._lock") in edges
    assert not any(inner.startswith("cache.") for _outer, inner in edges)


def test_torch_calls_never_resolve_to_a_method_of_the_package():
    """``torch.gather(...)`` is not ``ExchangePlane.gather``: a call on an
    external module resolves through no program-unique method name."""
    src = _src("""
        import threading
        import torch

        class Plane:
            def __init__(self):
                self._cv = threading.Condition()
            def gather(self, x):
                with self._cv:
                    return x

        class Index:
            def __init__(self):
                self._lock = threading.Lock()
            def search(self, s, i):
                with self._lock:
                    return torch.gather(s, -1, i)
    """)
    from pathway_tpu_torch.analysis.lock_order import LockOrderRule

    rule = LockOrderRule()
    analyze_source(src, "pathway_tpu_torch/ops/topk.py", rules=[rule])
    from pathway_tpu_torch.analysis.lock_order import _Program

    prog = _Program(rule._summaries)
    assert prog._acq["ops.topk::Index.search"].keys() == {"ops.topk.Index._lock"}


# -- SARIF, cache, CLI, stale pragmas -----------------------------------------

_SARIF_FIXTURE = """
    import os
    import threading

    import torch
    from pathway_tpu_torch.ops import donation_guard
    from pathway_tpu_torch.ops.recompile_guard import guarded_jit

    @guarded_jit
    def _score(x):
        return x

    def f(lock, q):
        with lock:
            return _score(q)

    def g(lock, q):
        with lock:  # pathway: allow(lock-discipline): fixture — reviewed
            return _score(q)

    def h(buf, upd):
        donation_guard.stamp("fixture", buf)
        buf.copy_(upd)

    def k():
        return os.environ.get("PATHWAY_FIXTURE_KNOB", "0")
"""


def test_sarif_output_matches_golden(tmp_path, capsys):
    fixture = tmp_path / "sarif_fixture.py"
    fixture.write_text(_src(_SARIF_FIXTURE))
    assert main([str(fixture), "--format", "sarif"]) == 1
    doc = json.loads(capsys.readouterr().out)
    body = json.dumps(doc, indent=1, sort_keys=True).replace(str(fixture).replace("\\", "/"), "sarif_fixture.py")
    with open(os.path.join(_REPO_ROOT, "tests", "goldens", "torch_analysis.sarif")) as fh:
        assert body.strip() == fh.read().strip(), (
            "SARIF output drifted from tests/goldens/torch_analysis.sarif — if the change is deliberate, "
            "regenerate the golden"
        )
    run = doc["runs"][0]
    assert doc["version"] == "2.1.0"
    assert run["tool"]["driver"]["informationUri"] == "python -m pathway_tpu_torch.analysis"
    assert {r["ruleId"] for r in run["results"]} == {"lock-discipline", "value-flow", "knob-discipline"}
    assert any(r.get("suppressions") for r in run["results"])


@pytest.mark.parametrize("fmt", ["text", "json", "jsonl", "sarif"])
def test_cli_exit_codes(fmt, tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(_src("""
        import threading
        import pickle

        def f(lock, q):
            with lock:
                return pickle.dumps(q)
    """))
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert main([str(bad), "--format", fmt]) == 1
    out = capsys.readouterr().out
    assert "lock-discipline" in out
    assert main([str(good), "--format", fmt]) == 0
    assert ref_analysis.main([str(bad), "--format", fmt]) == 1 and ref_analysis.main([str(good), "--format", fmt]) == 0


def test_cli_show_suppressed_and_check_pragmas(tmp_path, capsys):
    mod = tmp_path / "stale.py"
    mod.write_text(
        "import pickle\n"
        "def f(lock, a):\n"
        "    with lock:\n"
        "        return pickle.dumps(a)  # pathway: allow(lock-discipline): fixture — live\n"
        "def g(a):\n"
        "    return len(a)  # pathway: allow(lock-discipline): fixture — STALE\n"
    )
    assert main([str(mod)]) == 0
    assert main([str(mod), "--show-suppressed"]) == 0
    assert "suppressed: fixture — live" in capsys.readouterr().out
    assert main([str(mod), "--check-pragmas"]) == 1
    out = capsys.readouterr().out
    assert "stale-pragma" in out and "STALE" in out
    findings, pragmas = analyze_paths([str(mod)], return_pragmas=True)
    stale = stale_pragma_findings(pragmas)
    assert [(f.rule, f.line) for f in stale] == [("stale-pragma", 6)]


def test_analysis_cache_cold_equals_warm(tmp_path, monkeypatch):
    """``PATHWAY_ANALYSIS_CACHE``: a warm run re-parses only changed
    modules and gives bit-identical findings, whole-program passes
    included; a new rule family re-runs only itself."""
    from pathway_tpu_torch.analysis import core
    from pathway_tpu_torch.analysis.hidden_sync import HiddenSyncRule
    from pathway_tpu_torch.analysis.lock_order import LockOrderRule

    tree = tmp_path / "pkg" / "serve"
    tree.mkdir(parents=True)
    (tree / "a.py").write_text(_src(_IDIOM_FREE["helper_abba"][0]))
    (tree / "b.py").write_text(_src(_SUBMIT_COMPLETE_TORCH))
    monkeypatch.setenv("PATHWAY_ANALYSIS_CACHE", str(tmp_path / "cache"))
    parses = []
    orig = core._run_module

    def counting(source, display, rules, real_path=None):
        parses.append(display)
        return orig(source, display, rules, real_path)

    monkeypatch.setattr(core, "_run_module", counting)
    cold = analyze_paths([str(tmp_path / "pkg")])
    assert len(parses) == 2 and any("deadlock cycle" in f.message for f in cold)
    warm = analyze_paths([str(tmp_path / "pkg")])
    assert len(parses) == 2
    assert [f.__dict__ for f in warm] == [f.__dict__ for f in cold]
    (tree / "b.py").write_text(_src(_SYNC_IN_DISPATCH_TORCH))
    third = analyze_paths([str(tmp_path / "pkg")])
    assert len(parses) == 3
    assert [f.__dict__ for f in third if f.path.endswith("a.py")] == [
        f.__dict__ for f in cold if f.path.endswith("a.py")
    ]
    # fetch scopes ride the cache too: a warm run keeps them
    rule = HiddenSyncRule()
    analyze_paths([str(tmp_path / "pkg")], rules=[rule, LockOrderRule()])
    assert any(scopes for scopes in rule.sync_scopes.values())


def test_fetch_scopes_classify_booked_waived_and_live(tmp_path):
    from pathway_tpu_torch.analysis.hidden_sync import fetch_scopes

    mod = tmp_path / "serve.py"
    mod.write_text(_SERVE_HDR + _src("""
        from pathway_tpu_torch.ops.dispatch_counter import record_fetch

        def booked(fetch):
            arr = fetch()
            record_fetch("serve")
            return arr

        def waived(self, ids):
            return ids.to(self.device)  # pathway: allow(hidden-sync): fixture — reviewed

        def live(self, ids):
            return ids.cuda()
    """))
    scopes = {qual: kind for (_p, qual), kind in fetch_scopes([str(mod)]).items()}
    assert scopes == {"booked": "booked", "waived": "waived", "live": "live"}


def test_runtime_edges_are_held_to_the_rank_table():
    from pathway_tpu_torch.analysis.lock_order import runtime_edge_report

    graph = {
        "edges": {("ops.serving.<index._lock>", "ops.serving.FusedEncodeSearch._lock")},
        "sites": {
            "ops.serving.FusedEncodeSearch._lock": {"kind": "lock", "path": "pathway_tpu_torch/ops/serving.py", "rank": 5},
            "ops.ivf.IvfKnnIndex._lock": {"kind": "rlock", "path": "pathway_tpu_torch/ops/ivf.py", "rank": 3},
            "observe.trace._store_lock": {"kind": "lock", "path": "pathway_tpu_torch/observe/trace.py", "rank": 0},
        },
    }
    rep = runtime_edge_report(
        [
            ("ops.ivf.IvfKnnIndex._lock", "ops.serving.FusedEncodeSearch._lock"),  # waived pair, seen opaque
            ("observe.trace._store_lock", "ops.ivf.IvfKnnIndex._lock"),  # observe(0) holding index(3)
        ],
        graph,
    )
    assert rep["inconsistent"] == [("observe.trace._store_lock", "ops.ivf.IvfKnnIndex._lock", "rank-inversion")]
    assert rep["missing"] == [("observe.trace._store_lock", "ops.ivf.IvfKnnIndex._lock")]


# -- the gate over the port's tree --------------------------------------------

@pytest.fixture(scope="module")
def port_analysis():
    """ONE analysis of the whole port, shared by the gates below."""
    return analyze_paths([_PORT], return_pragmas=True)


def test_port_tree_has_zero_unsuppressed_findings(port_analysis):
    findings, _pragmas = port_analysis
    live = [f for f in findings if not f.suppressed]
    assert live == [], "unsuppressed hot-path findings:\n" + "\n".join(f.format() for f in live)
    assert all(f.reason for f in findings if f.suppressed)


def test_port_tree_has_no_stale_pragma(port_analysis):
    _findings, pragmas = port_analysis
    stale = stale_pragma_findings(pragmas)
    assert stale == [], "\n".join(f.format() for f in stale)


def test_cli_over_the_port_exits_zero_with_check_pragmas(capsys):
    assert main([_PORT, "--check-pragmas", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["live"] == 0 and doc["suppressed"] > 0


def _enclosing_qualnames(real_path: str, lines: set) -> set:
    with open(real_path) as fh:
        tree = ast.parse(fh.read())
    out = set()

    def walk(node, stack):
        for child in ast.iter_child_nodes(node):
            s = stack
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                s = stack + [child.name]
            walk(child, s)
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for ln in lines:
                    if child.lineno <= ln <= child.end_lineno:
                        out.add(".".join(s))

    walk(tree, [])
    return {q for q in out if not any(o != q and o.startswith(q + ".") for o in out)}


def test_declared_transfers_mirror_the_value_flow_pragmas(port_analysis):
    from pathway_tpu_torch.analysis import residency

    findings, _pragmas = port_analysis
    by_path: dict = {}
    for f in findings:
        if f.rule == "value-flow" and f.suppressed:
            by_path.setdefault(f.path, set()).add(f.line)
    matched, undeclared = set(), []
    for path, lines in sorted(by_path.items()):
        norm = path.replace(os.sep, "/")
        per_module = residency.declared_transfers_for(norm)
        for qual in sorted(_enclosing_qualnames(path, lines)):
            if qual in per_module:
                matched.update((sfx, q) for (sfx, q) in residency.DECLARED_TRANSFERS if q == qual and norm.endswith(sfx))
            else:
                undeclared.append(f"{path}: {qual}")
    assert undeclared == []
    assert sorted(set(residency.DECLARED_TRANSFERS) - matched) == []


def test_knob_waivers_mirror_the_knob_pragmas(port_analysis):
    from pathway_tpu_torch.analysis.knob_discipline import DECLARED_KNOB_WAIVERS

    findings, _pragmas = port_analysis
    assert DECLARED_KNOB_WAIVERS == {}
    assert [f for f in findings if f.rule == "knob-discipline"] == []


def test_rank_exceptions_mirror_the_lock_order_pragmas(port_analysis):
    """``lock_ranks.DECLARED_EXCEPTIONS`` holds exactly the domain pairs
    the port's suppressed rank inversions name."""
    from pathway_tpu_torch.analysis.lock_ranks import DECLARED_EXCEPTIONS

    findings, _pragmas = port_analysis
    pairs = set()
    for f in findings:
        if f.rule == "lock-order" and f.suppressed and "rank inversion" in f.message:
            inner, outer = re.findall(r"\((\w+)\(\d\)\)", f.message)[:2]
            pairs.add((outer, inner))
    assert pairs and pairs == set(DECLARED_EXCEPTIONS)


def _twin_modules():
    """Modules of the port that create locks and have a reference twin."""
    from pathway_tpu_torch.analysis.lock_order import module_lock_sites

    out = []
    for root, _dirs, files in os.walk(_PORT):
        for name in sorted(files):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, _PORT)
            if (
                name.endswith(".py")
                and os.path.exists(os.path.join(_REPO_ROOT, "pathway_tpu", rel))
                and module_lock_sites(path, "pathway_tpu_torch/" + rel)
            ):
                out.append(rel)
    return sorted(out)


@pytest.mark.parametrize("rel", _twin_modules())
def test_every_lock_site_ranks_as_its_reference_twin(rel):
    """A lock's rank comes from its defining module: every site of a port
    module ranks as the reference ranks the sites of its twin, and a site
    both packages name (``serve.scheduler._CoalescerBase._qlock``) has one
    id in both graphs."""
    from pathway_tpu.analysis import lock_ranks as ref_ranks
    from pathway_tpu.analysis.lock_order import module_lock_sites as ref_sites
    from pathway_tpu_torch.analysis import lock_ranks
    from pathway_tpu_torch.analysis.lock_order import module_lock_sites

    mine = module_lock_sites(os.path.join(_PORT, rel), "pathway_tpu_torch/" + rel)
    theirs = {sid for sid, _k in ref_sites(os.path.join(_REPO_ROOT, "pathway_tpu", rel), "pathway_tpu/" + rel).values()}
    want = ref_ranks.rank_of_path("pathway_tpu/" + rel)
    for sid, _kind in mine.values():
        assert lock_ranks.rank_of_path("pathway_tpu_torch/" + rel) == want, (rel, sid)
    assert lock_ranks.RANK_ORDER == ref_ranks.RANK_ORDER
    assert lock_ranks._RECEIVER_DOMAINS == ref_ranks._RECEIVER_DOMAINS
    assert all(sid.startswith(rel[:-3].replace("/", ".").replace(".__init__", "")) for sid, _k in mine.values())
    assert not theirs or {s.split(".", 1)[0] for s in theirs} == {s.split(".", 1)[0] for s, _k in mine.values()}


def test_packed_encode_uploads_its_row_index_before_the_launch():
    """The packed encode path's row index used to go up by a blocking
    ``.to(dev)`` after the launch, holding the host until the packed
    forward finished; it now rides ``upload`` (pinned, non-blocking)."""
    from pathway_tpu_torch.analysis.hidden_sync import HiddenSyncRule

    path = os.path.join(_PORT, "models", "encoder.py")
    rule = HiddenSyncRule()
    findings = analyze_paths([path], rules=[rule])
    scopes = rule.sync_scopes[os.path.relpath(path)]
    assert not any(f.rule == "hidden-sync" and not f.suppressed for f in findings)
    assert "SentenceEncoder.encode_packed_to_device" not in scopes


def test_the_analysis_package_imports_neither_torch_nor_the_reference():
    import subprocess
    import sys

    code = (
        "import sys, importlib.util\n"
        "sys.modules['pathway_tpu_torch'] = type(sys)('pathway_tpu_torch')\n"
        f"sys.modules['pathway_tpu_torch'].__path__ = [{_PORT!r}]\n"
        "import pathway_tpu_torch.analysis.core, pathway_tpu_torch.analysis.registry\n"
        "import pathway_tpu_torch.analysis.lock_order, pathway_tpu_torch.analysis.value_flow\n"
        "import pathway_tpu_torch.analysis.hidden_sync, pathway_tpu_torch.analysis.sanitizer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'pathway_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
