"""Resolution helpers shared by the lint rules (counterpart of
``pathway_tpu/analysis/registry.py``, answered for the port's idioms).

The rules need to answer, lexically, questions the AST does not answer
directly:

1. **Is this call a device dispatch?**  In the port a dispatch is:

   - a call to a hand-written kernel's wrapper (``rescore_shortlist``,
     ``add_layer_norm_rows``, ``layer_norm_rows``, ``tied_readout``);
   - a call to a callable bound by ``guarded_jit`` (``ops/recompile_guard.py``,
     decorator or assignment), ``torch.compile`` or ``torch.jit.script``;
   - a call to a callable from a per-shape getter (``_compiled_stage2``,
     ``_slot_step_fn`` and the rest of the ``_CACHE_GETTER_RE`` family):
     a local assigned from such a getter is a dispatch callable;
   - a call to a callable bound by ``profile.wrap("site", fn)``: the
     port's profiler wraps exactly its device steps (``_SEARCH``,
     ``_FUSED_IVF``, ``_ENCODE`` ...), and the wrapper is transparent;
   - ``retry_call("<stage>.dispatch", fn, ...)`` whatever ``fn`` is: the
     port names the retry site of every device launch ``*.dispatch``
     (``encoder.dispatch``, ``clip.dispatch``, ``ivf.dispatch`` ...);
   - ``retry_call("site", fn, ...)`` with ``fn`` any of the above, or
     with ``fn`` a closure (a local ``def`` or a ``lambda``) whose body
     makes one — the port launches under its index locks through such
     closures (``launch`` in ``ops/serving.py``), and wrapping a launch
     in one must not launder it out of the rules;
   - a call to a local ``def`` whose body makes a dispatch.
2. **Is this variable a device value?**  Variables assigned (tuple
   unpacking included) from a dispatch, or from a transfer to the device
   (``.cuda()``, ``.to(device)``, ``torch.as_tensor(..., device=...)``),
   hold tensors on the card (``device.upload(x, dev)``, the pinned
   non-blocking upload, included).  A **host sync** of one is ``.item()``,
   ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
   ``np.asarray`` / ``float`` / ``int`` / ``bool`` of it, ``if t:`` or
   iteration over it; ``torch.cuda.synchronize()`` and
   ``Event.synchronize()`` / ``Stream.synchronize()`` are syncs whatever
   they wait on.  The port's asynchronous fetch is ``device.to_host(x)``:
   it starts the copy and returns a waiter, which the port names
   ``fetch`` wherever it holds one; calling it (``fetch()``, or
   ``to_host(x)()`` at once) is the host fetch.
3. **Is this ``with`` statement a lock?**  Matched by name: any context
   expression whose terminal identifier contains ``lock``/``mutex``/
   ``cv``/``cond`` (``self._lock``, ``index._lock``,
   ``self._send_locks[peer]``, condition variables).
4. **Is this variable a serve completion handle?**  The serve stack's
   submit/complete contract hands back a handle whose CALL performs the
   host fetch (``handle = pipe.submit(...)`` then ``handle()`` /
   ``handle.result()`` / ``handle.advance()``).  Completing one under a
   lock stalls every other holder for a device round trip.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Set, Tuple

__all__ = [
    "KERNEL_WRAPPERS",
    "booking_declares_fanout",
    "collect_dispatch_names",
    "collect_traced_names",
    "dotted_name",
    "fence_call",
    "host_fetch_call",
    "is_async_upload",
    "is_cache_access",
    "is_cache_wrapper",
    "is_device_producer_call",
    "is_dispatch_booking",
    "is_handle_fetch",
    "is_lock_context",
    "is_observability_callback",
    "is_stream_io",
    "is_trace_context",
    "method_sync",
    "receiver_base",
    "scope_dispatch_and_device_vars",
    "scope_fetch_vars",
    "scope_handle_vars",
    "snapshot_refs",
    "transfer_call",
    "walk_scope",
]

# the port's hand-written kernels, by the wrapper each module calls
# (ops/ivf_rescore.py, kernels/decode_rows.py): calling one launches a
# kernel on a CUDA tensor
KERNEL_WRAPPERS = frozenset(
    {"rescore_shortlist", "add_layer_norm_rows", "layer_norm_rows", "tied_readout"}
)

# per-shape getters that hand back a device callable: _compiled_stage2
# (ops/retrieve_rerank.py), the slot-pool family _slot_prefill_fn /
# _slot_step_fn / _slot_verify_fn / _slot_draft_fn (models/generator.py,
# driven by serve/decode.py: allocating a slot under the pool lock is
# fine, CALLING one of these under it is a lock-discipline finding), and
# the reference's other getter names, kept so a getter the port grows
# under the reference's name is seen at once.  Tuple-returning getters
# bind only their FIRST unpack target as the callee.
_CACHE_GETTER_RE = re.compile(
    r"^_(compiled\w*|forward_fn|packed_fn|search_fn"
    r"|token_fn|pool_fn|maxsim_fn|audit_fn"
    r"|encode_fn|shard_search_fn|merge_fn|table_fn|scatter_fn"
    r"|slot_prefill_fn|slot_step_fn|slot_verify_fn|slot_draft_fn)$"
)
_LOCK_NAME_RE = re.compile(r"lock|mutex|cv\b|cond", re.IGNORECASE)
# constructors whose result runs on the device when called.  guarded_jit
# is the shape-census wrapper (ops/recompile_guard.py): a plain function
# observed per call.  torch.compile / torch.jit.script additionally TRACE
# their function: its body runs at trace time, not per call.
_TRACE_CTORS = {
    "torch.compile", "torch.jit.script", "jit.script", "torch.jit.trace",
    "jit.trace",
}
_DISPATCH_CTORS = {
    "guarded_jit", "recompile_guard.guarded_jit",
} | _TRACE_CTORS
# a with-statement whose body is captured into a CUDA graph: its
# statements run once, at capture time
_GRAPH_CAPTURE = {"torch.cuda.graph", "cuda.graph"}
# the robust retry wrapper (robust/retry.py): ``retry_call("site", fn,
# *args)`` DISPATCHES ``fn`` when ``fn`` is a dispatch callable — the
# rules must keep treating it as a device dispatch (lock-discipline)
# and its result as a device value (hidden-sync), or wrapping a launch
# in a retry would launder it out of both rules
_RETRY_WRAPPERS = {"retry_call"}

# the profiler's instrumentation wrapper (observe/profile.py):
# ``fn = profile.wrap("site", step)`` returns a TRANSPARENT wrapper over
# one of the port's device steps — calling it IS the dispatch, its
# result IS a device value.  A bare ``wrap(...)`` counts only with a
# literal site name first (other modules have helpers named ``wrap``).
_PROFILE_WRAP_RE = re.compile(r"(^|\.)profile\.wrap$")

# observability CALLBACKS (profiler flush/stats, HBM ledger sample, SLO
# evaluation): pull-based by design — they walk registries, may fire
# the profile.sample / hbm.ledger / slo.evaluate chaos sites
# (delay/hang), and belong on scrape/bench threads, NEVER under a
# serve-path lock where the fault (or just the walk) stalls every
# admitter.  Matched as <receiver spelled like the observability
# modules>.<sampling method>.
_OBS_CALLBACK_METHOD_RE = re.compile(
    r"^(sample|evaluate|should_shed|profile_stats|ledger_stats|drain)$"
)
_OBS_RECEIVER_RE = re.compile(r"(^|_)(profile|hbm|ledger|slo)(_\w+)?$")

# the cache-wrapper convention (cache/): a function named ``_cached_*`` /
# ``get_or_*`` wraps a device dispatch behind a cache lookup.  Its
# dispatch fires only on a MISS and is accounted inside the CALLER's
# logical dispatch group (``record_dispatch(tag, shards=<launches>)``),
# so the hidden-sync budget check must not demand a record_dispatch in
# the wrapper scope itself.  Everything else (sync-in-dispatch-scope,
# lock discipline) applies to wrapper scopes unchanged.
_CACHE_WRAPPER_RE = re.compile(r"^_?(cached_\w+|get_or_\w+)$")

# cache ACCESS, for the lock-discipline rule: a get/put-style method on
# a receiver whose terminal identifier is spelled like a cache
# (``self._result_cache.get(...)``, ``self.embed_cache.put_row(...)``).
# Cache lookups take the tier's own lock and fire the cache.get /
# cache.put chaos sites (which may delay or hang).
_CACHE_METHOD_RE = re.compile(r"^(get|put|lookup|store|admit|match)")
_CACHE_RECEIVER_RE = re.compile(r"cache$", re.IGNORECASE)

# the fabric stream convention (serve/fabric.py over the exchange
# plane's framed streams): ``<stream|link|peer|conn-spelled receiver>
# .send/.recv/.send_request(...)`` is BLOCKING network I/O and fires the
# fabric.send / fabric.recv chaos sites.  The sanctioned shape is
# swap-under-lock / I/O-off-lock.
_STREAM_IO_METHOD_RE = re.compile(r"^(send|recv|send_request)$")
_STREAM_RECEIVER_RE = re.compile(
    r"(^|_)(stream|link|peer|conn)s?$", re.IGNORECASE
)

# the scatter-gather fan-out booking convention (ops/dispatch_counter.py):
# ``record_dispatch(tag, shards=N)`` / ``record_fetch(tag, shards=N)``
# books 1 logical + N physical round trips.
_BOOKING_LEAVES = {"record_dispatch", "record_fetch"}

# device -> host methods: on a device value each one blocks until the
# value's producing kernels finish and copies it out
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# fences: block the host on the device whatever the receiver
_FENCE_LEAVES = {"synchronize"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains (subscripts transparent:
    ``self._send_locks[peer]`` -> ``self._send_locks``); None otherwise."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def _ctor_name(node: ast.AST) -> Optional[str]:
    """The constructor a decorator or bound expression names:
    ``guarded_jit`` / ``guarded_jit(limit=8)`` / ``torch.compile(fn)`` /
    ``partial(torch.compile, mode=...)``."""
    if not isinstance(node, ast.Call):
        return dotted_name(node)
    name = dotted_name(node.func)
    if name in ("partial", "functools.partial") and node.args:
        return dotted_name(node.args[0])
    return name


def _is_dispatch_expr(node: ast.AST) -> bool:
    return _ctor_name(node) in _DISPATCH_CTORS


def _is_trace_expr(node: ast.AST) -> bool:
    return _ctor_name(node) in _TRACE_CTORS


def _is_profile_wrap_call(node: ast.AST) -> bool:
    """``profile.wrap("site", fn)`` (or a bare ``wrap("site", fn)``)."""
    if not isinstance(node, ast.Call):
        return False
    callee = dotted_name(node.func)
    if callee is None:
        return False
    if _PROFILE_WRAP_RE.search(callee):
        return True
    return (
        callee == "wrap"
        and len(node.args) >= 2
        and isinstance(node.args[0], ast.Constant)
        and isinstance(node.args[0].value, str)
    )


def collect_dispatch_names(tree: ast.AST) -> Set[str]:
    """Names bound to dispatch callables anywhere in the module (module
    level and nested: call sites resolve by bare name, which matches how
    the code actually reaches them), plus the kernel wrappers."""
    names: Set[str] = set(KERNEL_WRAPPERS)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_dispatch_expr(dec) for dec in node.decorator_list):
                names.add(node.name)
        elif isinstance(node, ast.Assign):
            if _is_dispatch_expr(node.value) or _is_profile_wrap_call(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
    return names


def collect_traced_names(tree: ast.AST) -> Set[str]:
    """Functions whose body runs at TRACE time: decorated by
    ``torch.compile`` / ``torch.jit.script``, or passed to one
    (``fast = torch.compile(step)`` traces ``step``)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_trace_expr(dec) for dec in node.decorator_list):
                names.add(node.name)
        elif isinstance(node, ast.Call) and dotted_name(node.func) in _TRACE_CTORS:
            for arg in node.args[:1]:
                name = dotted_name(arg)
                if name is not None:
                    names.add(name.rsplit(".", 1)[-1])
    return names


def is_trace_context(with_node: ast.With) -> bool:
    """``with torch.cuda.graph(g):`` — the body is captured once into a
    CUDA graph; replays run none of its Python."""
    for item in with_node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and dotted_name(expr.func) in _GRAPH_CAPTURE:
            return True
    return False


# device-PRODUCER method convention: ``<embedder|encoder|model>.encode(
# texts)`` returns device rows (SentenceEncoder.encode and friends when
# asked for the device) — the value-flow rule treats the result as a
# device value so an immediate host coercion is a visible device→host
# crossing.  ``str.encode`` receivers (payload/text vars) do not match.
_PRODUCER_METHODS = {
    "encode",
    "encode_token_states",
    "encode_to_device",
    "encode_packed_to_device",
}
_PRODUCER_RECEIVER_RE = re.compile(
    r"(^|_)(embedder|encoder|enc|model)s?$", re.IGNORECASE
)


def is_device_producer_call(call: ast.Call) -> bool:
    """``<encoder-spelled receiver>.encode(...)`` — a model call whose
    result lives on the device by the encoder convention."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr not in _PRODUCER_METHODS:
        return False
    receiver = dotted_name(func.value)
    if receiver is None:
        return False
    return bool(_PRODUCER_RECEIVER_RE.search(receiver.rsplit(".", 1)[-1]))


_DEVICE_ARG_RE = re.compile(r"(^|_)(dev|device)s?$|^cuda", re.IGNORECASE)


def _names_device(node: ast.AST) -> Optional[bool]:
    """True when an expression spells a CUDA device, False when it spells
    the CPU, None when it names neither (a dtype, a tensor)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if node.value.startswith("cuda"):
            return True
        if node.value == "cpu":
            return False
        return None
    if isinstance(node, ast.Call) and dotted_name(node.func) == "torch.device":
        return _names_device(node.args[0]) if node.args else None
    name = dotted_name(node)
    if name is None:
        return None
    return True if _DEVICE_ARG_RE.search(name.rsplit(".", 1)[-1]) else None


def transfer_call(call: ast.Call) -> Optional[str]:
    """A host→device transfer: ``x.cuda()``, ``x.to(device)`` (a device
    spelled as a CUDA literal, ``torch.device(...)`` or a name ending in
    ``dev``/``device``), ``torch.as_tensor`` / ``torch.tensor`` /
    ``torch.from_numpy(...).to(...)`` with ``device=``.  Returns the
    spelling for the diagnostic, or None."""
    callee = dotted_name(call.func)
    if callee is None:
        return None
    leaf = callee.rsplit(".", 1)[-1]
    if isinstance(call.func, ast.Attribute) and leaf == "cuda":
        return f"{callee}()"
    if isinstance(call.func, ast.Attribute) and leaf == "to":
        cands = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
        if any(_names_device(c) for c in cands):
            return f"{callee}(device)"
        return None
    if callee in ("torch.as_tensor", "torch.tensor", "torch.asarray"):
        for kw in call.keywords:
            if kw.arg == "device" and _names_device(kw.value) is not False:
                return f"{callee}(..., device=...)"
    return None


def method_sync(call: ast.Call) -> Optional[str]:
    """The device→host method a call spells — ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.to("cpu")`` — or None.  Whether it syncs
    depends on its receiver being a device value."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _SYNC_METHODS:
        return func.attr
    if func.attr == "to":
        cands = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
        if any(_names_device(c) is False for c in cands):
            return "to"
    return None


def fence_call(call: ast.Call) -> Optional[str]:
    """``torch.cuda.synchronize()`` / ``event.synchronize()`` /
    ``stream.synchronize()``: blocks the host on the device."""
    callee = dotted_name(call.func)
    if callee is None:
        return None
    if callee.rsplit(".", 1)[-1] in _FENCE_LEAVES:
        return callee
    return None


_ASYNC_UPLOAD = {"upload", "device.upload"}
_TO_HOST = {"to_host", "device.to_host"}


def is_async_upload(call: ast.Call) -> bool:
    """``upload(array, dev)`` (``device.py``): a pinned, non-blocking
    host→device copy — its result is a device value, the copy itself
    blocks nothing."""
    return dotted_name(call.func) in _ASYNC_UPLOAD


def host_fetch_call(call: ast.Call, fetch_vars: Set[str] = frozenset()) -> Optional[str]:
    """The completion of a ``to_host`` waiter — ``fetch()`` (the port's
    name for a held waiter), a call of a name bound from ``to_host(...)``,
    or ``to_host(x)()`` — returns the spelling, or None."""
    func = call.func
    if isinstance(func, ast.Name) and (func.id == "fetch" or func.id in fetch_vars):
        return f"{func.id}()"
    if isinstance(func, ast.Call) and dotted_name(func.func) in _TO_HOST:
        return "to_host(...)()"
    return None


def scope_fetch_vars(scope: ast.AST) -> Set[str]:
    """Local names bound from ``to_host(...)``: waiters whose call is the
    host fetch."""
    out: Set[str] = set()
    for node in walk_scope(scope):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and dotted_name(node.value.func) in _TO_HOST
        ):
            for tgt in node.targets:
                out.update(_target_names(tgt))
    return out


def is_lock_context(with_node: ast.With) -> bool:
    for item in with_node.items:
        name = dotted_name(item.context_expr)
        if name and _LOCK_NAME_RE.search(name.rsplit(".", 1)[-1]):
            return True
    return False


def walk_scope(node: ast.AST, *, into_functions: bool = False) -> Iterable[ast.AST]:
    """Walk ``node`` without descending into nested function/lambda/class
    bodies (unless ``into_functions``): statements inside a nested ``def``
    do not execute where they appear, so e.g. a completion closure defined
    under a lock does not RUN under that lock.  Every rule walks the same
    scopes of one parsed module, so the node list is kept on the scope."""
    if into_functions:
        return ast.walk(node)
    cached = getattr(node, "_pw_scope_nodes", None)
    if cached is None:
        cached = []
        stack = list(ast.iter_child_nodes(node))
        while stack:
            child = stack.pop()
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
            ):
                continue
            cached.append(child)
            stack.extend(ast.iter_child_nodes(child))
        node._pw_scope_nodes = cached
    return iter(cached)


def _target_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(_target_names(elt))
        return out
    return []


def _transfer_chain(value: ast.AST) -> bool:
    """The value expression ends in a transfer to the device
    (``torch.from_numpy(x).to(dev)``, ``t.cuda()``)."""
    return isinstance(value, ast.Call) and transfer_call(value) is not None


def scope_dispatch_and_device_vars(
    scope: ast.AST,
    module_dispatch_names: Set[str],
    inherited_fns: Optional[Set[str]] = None,
    inherited_vars: Optional[Set[str]] = None,
) -> Tuple[Set[str], Set[str]]:
    """For one function scope (or the module body): the set of local names
    holding DISPATCH CALLABLES (the module registry, ``guarded_jit`` /
    ``profile.wrap`` assignments, or getter calls) and the set holding
    DEVICE VALUES (assigned from a call to one of those, or from a
    transfer to the device).  ``inherited_*`` seed closures with the
    enclosing scope's sets."""
    fns: Set[str] = set(module_dispatch_names) | set(inherited_fns or ())
    device_vars: Set[str] = set(inherited_vars or ())
    assigns = []
    for node in walk_scope(scope):
        if isinstance(node, ast.Assign):
            names: List[str] = []
            for tgt in node.targets:
                names.extend(_target_names(tgt))
            if names:
                assigns.append((node.value, names))
    # a local def whose body dispatches is a dispatch callable (the
    # `def launch(): ...` closures handed to retry_call)
    local_defs = [
        (fdef.name, [n for n in walk_scope(fdef) if isinstance(n, ast.Call)])
        for fdef in _local_defs(scope)
    ]
    # two passes so a getter assignment above or below a use both resolve
    # (lexical order is irrelevant for name→kind classification here)
    for _ in range(2):
        for name, calls in local_defs:
            if name not in fns and any(is_dispatch_call(n, fns) for n in calls):
                fns.add(name)
        for value, names in assigns:
            if (
                _is_dispatch_expr(value)
                or _is_profile_wrap_call(value)
                or _picks_dispatch(value, fns)
            ):
                fns.update(names)
            elif _transfer_chain(value) or (
                isinstance(value, ast.Call) and is_async_upload(value)
            ):
                device_vars.update(names)
            elif isinstance(value, ast.Call):
                callee = dotted_name(value.func)
                if callee is None:
                    continue
                leaf = callee.rsplit(".", 1)[-1]
                if _CACHE_GETTER_RE.match(leaf):
                    # tuple getters return (fn, extras...): only the first
                    # element is the callable
                    fns.add(names[0])
                elif leaf in fns or callee in fns:
                    device_vars.update(names)
                elif _is_retry_wrapped_dispatch(value, fns):
                    device_vars.update(names)
    return fns, device_vars


def _picks_dispatch(value: ast.AST, fns: Set[str]) -> bool:
    """``step = _FUSED_IVF if z is None else _IVF_SEARCH`` — a choice
    between dispatch callables is one."""
    if isinstance(value, ast.IfExp):
        options = [value.body, value.orelse]
    elif isinstance(value, ast.BoolOp):
        options = list(value.values)
    else:
        return False
    names = [dotted_name(o) for o in options]
    return any(
        n is not None and (n in fns or n.rsplit(".", 1)[-1] in fns) for n in names
    )


def _local_defs(scope: ast.AST) -> Iterable[ast.AST]:
    """Function definitions nested directly in ``scope``'s body (not
    inside a further def or class)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        child = stack.pop()
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield child
            continue
        if isinstance(child, (ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(child))


def _is_retry_wrapped_dispatch(call: ast.Call, fns: Set[str]) -> bool:
    """``retry_call("site", fn, ...)`` with ``fn`` a dispatch callable (or
    a lambda whose body makes a dispatch) — the robust wrapper dispatches
    its function argument, so the rules treat the wrapper call itself as
    the dispatch."""
    callee = dotted_name(call.func)
    if callee is None or callee.rsplit(".", 1)[-1] not in _RETRY_WRAPPERS:
        return False
    if (
        call.args
        and isinstance(call.args[0], ast.Constant)
        and isinstance(call.args[0].value, str)
        and call.args[0].value.endswith(".dispatch")
    ):
        return True  # the fault-site name says it: "<stage>.dispatch"
    for arg in call.args:
        if isinstance(arg, ast.Lambda):
            if any(
                isinstance(n, ast.Call) and is_dispatch_call(n, fns)
                for n in ast.walk(arg.body)
            ):
                return True
            continue
        name = dotted_name(arg)
        if name is None:
            continue
        if name in fns or name.rsplit(".", 1)[-1] in fns:
            return True
    return False


def is_observability_callback(call: ast.Call) -> Optional[str]:
    """A pull-style observability callback — ``<profile|hbm|slo|
    ledger>.sample/evaluate/...`` — returns the dotted spelling for the
    diagnostic, or None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if not _OBS_CALLBACK_METHOD_RE.match(func.attr):
        return None
    receiver = dotted_name(func.value)
    if receiver is None:
        return None
    if _OBS_RECEIVER_RE.search(receiver.rsplit(".", 1)[-1]):
        return f"{receiver}.{func.attr}"
    return None


def is_stream_io(call: ast.Call) -> Optional[str]:
    """``<something spelled like a stream/link/peer>.send/recv/
    send_request(...)`` — blocking network I/O by the fabric/exchange
    convention.  Returns the dotted spelling for the diagnostic, or
    None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if not _STREAM_IO_METHOD_RE.match(func.attr):
        return None
    receiver = dotted_name(func.value)
    if receiver is None:
        return None
    if _STREAM_RECEIVER_RE.search(receiver.rsplit(".", 1)[-1]):
        return f"{receiver}.{func.attr}"
    return None


def is_dispatch_booking(call: ast.Call) -> Optional[str]:
    """A runtime dispatch-budget booking: a bare or attribute call whose
    leaf is ``record_dispatch`` / ``record_fetch`` (ops/dispatch_counter).
    Returns the leaf name, or None."""
    name = dotted_name(call.func)
    if name is None:
        return None
    leaf = name.rsplit(".", 1)[-1]
    return leaf if leaf in _BOOKING_LEAVES else None


def booking_declares_fanout(call: ast.Call) -> bool:
    """Whether a dispatch booking carries the ``shards=`` keyword — the
    scatter-gather fan-out convention (1 logical + N physical)."""
    return any(kw.arg == "shards" for kw in call.keywords)


def is_cache_wrapper(scope_name: str) -> bool:
    """A scope following the cache-wrapper naming convention (see
    ``_CACHE_WRAPPER_RE``): its miss-path dispatch is accounted by the
    calling serve path's dispatch group."""
    return bool(_CACHE_WRAPPER_RE.match(scope_name or ""))


def is_cache_access(call: ast.Call) -> Optional[str]:
    """``<something spelled like a cache>.get/put/lookup/store/...`` —
    returns the dotted spelling for the diagnostic, or None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if not _CACHE_METHOD_RE.match(func.attr):
        return None
    receiver = dotted_name(func.value)
    if receiver is None:
        return None
    if _CACHE_RECEIVER_RE.search(receiver.rsplit(".", 1)[-1]):
        return f"{receiver}.{func.attr}"
    return None


def is_dispatch_call(call: ast.Call, fns: Set[str]) -> bool:
    callee = dotted_name(call.func)
    if callee is None:
        return False
    if callee in fns or callee.rsplit(".", 1)[-1] in fns:
        return True
    return _is_retry_wrapped_dispatch(call, fns)


def is_device_value_arg(
    call: ast.Call, fns: Set[str], device_vars: Set[str]
) -> bool:
    """First positional argument of ``call`` is a device value: either a
    direct dispatch call, or a (possibly subscripted) name holding one —
    shared by the lock-discipline and hidden-sync rules so the resolution
    cannot drift between them."""
    if not call.args:
        return False
    arg = call.args[0]
    if isinstance(arg, ast.Call):
        return is_dispatch_call(arg, fns)
    name = dotted_name(arg)  # Subscript-transparent: out[:n] -> "out"
    return name is not None and name in device_vars


# tensor methods whose result stays on the receiver's device
_SAME_DEVICE_METHODS = {
    "float", "half", "bfloat16", "double", "long", "int", "contiguous",
    "reshape", "view", "flatten", "squeeze", "unsqueeze", "t", "transpose",
    "permute", "clone", "detach",
}


def receiver_base(call: ast.Call) -> Optional[str]:
    """The value a method call's receiver chain starts from:
    ``out.float().cpu()`` → ``out``, ``out[0].item()`` → ``out`` (methods
    that keep the device and subscripts are transparent)."""
    if not isinstance(call.func, ast.Attribute):
        return None
    node = call.func.value
    while True:
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _SAME_DEVICE_METHODS
        ):
            node = node.func.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    if isinstance(node, (ast.Name, ast.Attribute)):
        return dotted_name(node)
    return None


def is_device_value_base(call: ast.Call, device_vars: Set[str]) -> bool:
    """``call`` is a method on a device value (``out.item()``,
    ``out[0].cpu()``, ``out.float().cpu()`` through the chain)."""
    base = receiver_base(call)
    return base is not None and base in device_vars


# a serve completion handle comes back from the submit/complete contract:
# ``handle = <obj>.submit(...)`` (FusedEncodeSearch, RetrieveRerankPipeline,
# CrossEncoderModel, ServeScheduler all follow it).  Dotted only — a bare
# ``submit(...)`` is some local helper, not the serving contract.
_SUBMIT_LEAF_RE = re.compile(r"^submit$")
# ...but ``executor.submit``/``pool.submit`` is the concurrent.futures
# convention, not a serve handle.
_EXECUTOR_RECEIVER_RE = re.compile(r"(pool|executor)s?$", re.IGNORECASE)
# completing methods: ``handle()`` is the fetch itself; ``.result()`` is
# the ticket/future spelling; ``.advance()`` completes stage 1 (a host
# fetch) and dispatches stage 2
_HANDLE_COMPLETE_ATTRS = ("result", "advance")


def scope_handle_vars(
    scope: ast.AST, inherited: Optional[Set[str]] = None
) -> Set[str]:
    """Local names holding serve completion handles — assigned from a
    dotted ``<obj>.submit(...)`` call.  ``inherited`` seeds closures with
    the enclosing scope's handles."""
    handles: Set[str] = set(inherited or ())
    for node in walk_scope(scope):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        callee = dotted_name(value.func)
        if (
            callee is None
            or "." not in callee
            or not _SUBMIT_LEAF_RE.match(callee.rsplit(".", 1)[-1])
        ):
            continue
        receiver = callee.rsplit(".", 2)[-2]
        if _EXECUTOR_RECEIVER_RE.search(receiver):
            continue  # concurrent.futures convention, not a serve handle
        for tgt in node.targets:
            handles.update(_target_names(tgt))
    return handles


def is_handle_fetch(call: ast.Call, handle_vars: Set[str]) -> Optional[str]:
    """The spelled-out completion of a tracked handle: ``handle()``,
    ``handle.result(...)``, or ``handle.advance()``.  Returns the dotted
    spelling for the diagnostic, or None."""
    func = call.func
    if isinstance(func, ast.Name) and func.id in handle_vars:
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in _HANDLE_COMPLETE_ATTRS:
        base = dotted_name(func.value)
        if base is not None and base in handle_vars:
            return f"{base}.{func.attr}"
    return None


# the in-place-write guard's calls (ops/donation_guard.py): ``stamp(site,
# *refs)`` hands each ref out as a snapshot; ``note_write(site, *refs)``
# records an in-place write to each ref's storage
_STAMP_LEAVES = {"stamp"}
_NOTE_WRITE_LEAVES = {"note_write"}


def snapshot_refs(call: ast.Call) -> Optional[Tuple[str, List[ast.AST]]]:
    """``("stamp" | "note_write", refs)`` for a guard call (the site name,
    the first argument, is dropped), or None."""
    callee = dotted_name(call.func)
    if callee is None:
        return None
    leaf = callee.rsplit(".", 1)[-1]
    if leaf in _STAMP_LEAVES and (callee == leaf or callee.endswith("donation_guard." + leaf)):
        return "stamp", list(call.args[1:])
    if leaf in _NOTE_WRITE_LEAVES:
        return "note_write", list(call.args[1:])
    return None
