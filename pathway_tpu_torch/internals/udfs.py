"""UDF system: ``@pw.udf``.

Reference surface: python/pathway/internals/udfs/ — UDF class, executors
(auto/sync/async), cache strategies (disk/in-memory), retry strategies,
async options (capacity/timeout).  A UDF can be declared ``batched=True``
(receives whole micro-batch columns as arrays, returns an array or a
tensor) — the idiomatic form for on-device ML (the reference calls
``model.encode`` one string at a time, embedders.py:315; here batching is
the construction).
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import inspect
import os
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from . import dtype as dt
from .expression import ApplyExpression, AsyncApplyExpression

__all__ = [
    "UDF",
    "udf",
    "udf_async",
    "CacheStrategy",
    "InMemoryCache",
    "DiskCache",
    "DefaultCache",
    "AsyncRetryStrategy",
    "NoRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "with_capacity",
    "with_timeout",
    "async_options",
    "coerce_async",
]


# ---------------------------------------------------------------------------
# caches (reference: internals/udfs/caches.py:23-160)
# ---------------------------------------------------------------------------
class CacheStrategy:
    def wrap(self, fun: Callable) -> Callable:
        raise NotImplementedError


class InMemoryCache(CacheStrategy):
    """Unbounded in-memory memoization of UDF results."""

    def wrap(self, fun: Callable) -> Callable:
        cache: dict = {}

        if inspect.iscoroutinefunction(fun):

            @functools.wraps(fun)
            async def awrapper(*args, **kwargs):
                key = _cache_key(args, kwargs)
                if key not in cache:
                    cache[key] = await fun(*args, **kwargs)
                return cache[key]

            return awrapper

        @functools.wraps(fun)
        def wrapper(*args, **kwargs):
            key = _cache_key(args, kwargs)
            if key not in cache:
                cache[key] = fun(*args, **kwargs)
            return cache[key]

        return wrapper


class DiskCache(CacheStrategy):
    """Persistent on-disk pickle cache (app-level checkpoint of expensive
    LLM calls, reference caches.py:35)."""

    def __init__(self, name: Optional[str] = None, directory: Optional[str] = None):
        self.name = name
        from .. import config

        self.directory = (
            directory or config.get("persistence.storage") or "./Cache"
        )

    def _path(self, fun: Callable, key: str) -> str:
        fun_name = self.name or getattr(fun, "__name__", "udf")
        d = os.path.join(self.directory, fun_name)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, key)

    def wrap(self, fun: Callable) -> Callable:
        if inspect.iscoroutinefunction(fun):

            @functools.wraps(fun)
            async def awrapper(*args, **kwargs):
                key = _cache_key(args, kwargs)
                path = self._path(fun, key)
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        return pickle.load(f)
                result = await fun(*args, **kwargs)
                with open(path, "wb") as f:
                    pickle.dump(result, f)
                return result

            return awrapper

        @functools.wraps(fun)
        def wrapper(*args, **kwargs):
            key = _cache_key(args, kwargs)
            path = self._path(fun, key)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    return pickle.load(f)
            result = fun(*args, **kwargs)
            with open(path, "wb") as f:
                pickle.dump(result, f)
            return result

        return wrapper


DefaultCache = DiskCache


def _cache_key(args, kwargs) -> str:
    try:
        blob = pickle.dumps((args, kwargs))
    except Exception:
        blob = repr((args, kwargs)).encode()
    return hashlib.sha256(blob).hexdigest()


# ---------------------------------------------------------------------------
# retries (reference: internals/udfs/retries.py)
# ---------------------------------------------------------------------------
class AsyncRetryStrategy:
    async def invoke(self, fun: Callable, /, *args, **kwargs):
        raise NotImplementedError


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, fun, /, *args, **kwargs):
        return await fun(*args, **kwargs)


class FixedDelayRetryStrategy(AsyncRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        self.max_retries = max_retries
        self.delay_ms = delay_ms

    def _next_delay(self, delay: float) -> float:
        return delay

    async def invoke(self, fun, /, *args, **kwargs):
        delay = self.delay_ms / 1000
        for attempt in range(self.max_retries + 1):
            try:
                return await fun(*args, **kwargs)
            except Exception:
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(delay)
                delay = self._next_delay(delay)
        raise RuntimeError("unreachable")


class ExponentialBackoffRetryStrategy(FixedDelayRetryStrategy):
    def __init__(
        self, max_retries: int = 3, initial_delay: int = 1000, backoff_factor: float = 2
    ):
        super().__init__(max_retries, initial_delay)
        self.backoff_factor = backoff_factor

    def _next_delay(self, delay: float) -> float:
        return delay * self.backoff_factor


# ---------------------------------------------------------------------------
# async helpers (reference: internals/udfs/__init__.py async_options)
# ---------------------------------------------------------------------------
def with_capacity(fun: Callable, capacity: int) -> Callable:
    semaphore: dict = {}

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        loop = asyncio.get_event_loop()
        sem = semaphore.setdefault(id(loop), asyncio.Semaphore(capacity))
        async with sem:
            return await fun(*args, **kwargs)

    return wrapper


def with_timeout(fun: Callable, timeout: float) -> Callable:
    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return await asyncio.wait_for(fun(*args, **kwargs), timeout=timeout)

    return wrapper


def coerce_async(fun: Callable) -> Callable:
    if inspect.iscoroutinefunction(fun):
        return fun

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return fun(*args, **kwargs)

    return wrapper


def async_options(
    capacity: Optional[int] = None,
    timeout: Optional[float] = None,
    retry_strategy: Optional[AsyncRetryStrategy] = None,
    cache_strategy: Optional[CacheStrategy] = None,
) -> Callable:
    def decorator(fun: Callable) -> Callable:
        fun = coerce_async(fun)
        if retry_strategy is not None:
            inner = fun

            @functools.wraps(inner)
            async def with_retry(*args, **kwargs):
                return await retry_strategy.invoke(inner, *args, **kwargs)

            fun = with_retry
        if timeout is not None:
            fun = with_timeout(fun, timeout)
        if capacity is not None:
            fun = with_capacity(fun, capacity)
        if cache_strategy is not None:
            fun = cache_strategy.wrap(fun)
        return fun

    return decorator


# ---------------------------------------------------------------------------
# UDF (reference: internals/udfs/__init__.py:68-403)
# ---------------------------------------------------------------------------
class UDF:
    """Callable wrapper turning a python function into an expression factory.

    Subclass and define ``__wrapped__`` or use the ``@udf`` decorator."""

    def __init__(
        self,
        fun: Optional[Callable] = None,
        *,
        return_type: Any = None,
        propagate_none: bool = False,
        deterministic: bool = False,
        executor: str = "auto",
        cache_strategy: Optional[CacheStrategy] = None,
        retry_strategy: Optional[AsyncRetryStrategy] = None,
        capacity: Optional[int] = None,
        timeout: Optional[float] = None,
        batched: bool = False,
    ):
        if fun is None and hasattr(self, "__wrapped__"):
            fun = self.__wrapped__
        self.__wrapped__ = fun
        self.func = fun
        self.return_type = return_type
        self.propagate_none = propagate_none
        self.deterministic = deterministic
        self.executor = executor
        self.cache_strategy = cache_strategy
        self.retry_strategy = retry_strategy
        self.capacity = capacity
        self.timeout = timeout
        self.batched = batched
        if fun is not None:
            functools.update_wrapper(self, fun)

    def _resolved_return_type(self) -> Any:
        if self.return_type is not None:
            return self.return_type
        if self.func is not None:
            hints = getattr(self.func, "__annotations__", {})
            if "return" in hints:
                return hints["return"]
        return None

    def _build_fun(self) -> Callable:
        fun = self.func
        is_async = inspect.iscoroutinefunction(fun)
        if is_async or self.executor == "async":
            fun = coerce_async(fun)
            fun = async_options(
                capacity=self.capacity,
                timeout=self.timeout,
                retry_strategy=self.retry_strategy,
                cache_strategy=self.cache_strategy,
            )(fun)
            return fun
        if self.cache_strategy is not None:
            fun = self.cache_strategy.wrap(fun)
        return fun

    def __call__(self, *args, **kwargs):
        fun = self._build_fun()
        rt = self._resolved_return_type()
        if inspect.iscoroutinefunction(fun):
            return AsyncApplyExpression(
                fun, rt, args=args, kwargs=kwargs, propagate_none=self.propagate_none
            )
        return ApplyExpression(
            fun,
            rt,
            args=args,
            kwargs=kwargs,
            batched=self.batched,
            propagate_none=self.propagate_none,
        )


def udf(
    fun: Optional[Callable] = None,
    /,
    **kwargs,
):
    """``@pw.udf`` decorator (reference udfs/__init__.py:290)."""
    if fun is None:
        return lambda f: UDF(f, **kwargs)
    if isinstance(fun, type):
        raise TypeError("apply @udf to a function, not a class")
    return UDF(fun, **kwargs)


def udf_async(fun: Optional[Callable] = None, /, **kwargs):
    kwargs.setdefault("executor", "async")
    if fun is None:
        return lambda f: UDF(f, **kwargs)
    return UDF(fun, **kwargs)
