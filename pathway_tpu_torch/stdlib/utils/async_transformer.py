"""AsyncTransformer of the port — fully-async table transformation
(counterpart of ``pathway_tpu/stdlib/utils/async_transformer.py``;
reference: python/pathway/stdlib/utils/async_transformer.py:282).

Rows are handed to an async ``invoke``; results re-enter the dataflow as a
*new source* at later timestamps (the reference's loop-back through a python
connector), so slow external calls never block the engine tick."""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from ...io._connector import SessionWriter, register_source
from ...io._subscribe import subscribe

__all__ = ["AsyncTransformer"]


class AsyncTransformer:
    """Subclass, define ``output_schema`` and ``async def invoke(self, **row)``.

    ``transformer(input_table).successful`` is the table of results."""

    output_schema: Type[Schema]

    def __init__(self, input_table: Optional[Table] = None, **kwargs):
        if kwargs:
            # the reference keeps them and uses none (an ``instance`` or an
            # ``autocommit_duration_ms`` would silently do nothing)
            raise NotImplementedError(
                f"AsyncTransformer({', '.join(sorted(kwargs))}): the options are not supported "
                "(the reference accepts and ignores them)"
            )
        self._input_table = input_table
        self._result_table: Optional[Table] = None
        if input_table is not None:
            self._build()

    def __call__(self, input_table: Table) -> "AsyncTransformer":
        self._input_table = input_table
        self._build()
        return self

    async def invoke(self, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def _build(self) -> None:
        schema = self.output_schema
        stop = threading.Event()
        queue_items = []
        queue_lock = threading.Lock()
        queue_event = threading.Event()

        transformer = self

        # shared in-flight counter: incremented UNDER the queue lock when
        # items leave the queue, decremented only after the result row is in
        # the session — the executor's quiescence probe must never observe
        # "empty queue, zero in flight" while an invocation is pending
        inflight_n = [0]

        def runner(writer: SessionWriter):
            transformer.open()

            async def work():
                in_flight = set()
                while not stop.is_set() or queue_items or in_flight:
                    with queue_lock:
                        items, queue_items[:] = queue_items[:], []
                        inflight_n[0] += len(items)
                    for key, row in items:
                        async def one(key=key, row=row):
                            try:
                                result = await transformer.invoke(**row)
                                if isinstance(result, dict):
                                    writer.insert(result, key=key)
                            except Exception:
                                import logging

                                logging.getLogger(__name__).exception(
                                    "AsyncTransformer.invoke failed"
                                )
                            finally:
                                with queue_lock:
                                    inflight_n[0] -= 1

                        in_flight.add(asyncio.ensure_future(one()))
                    if in_flight:
                        done, in_flight = await asyncio.wait(
                            in_flight, timeout=0.05, return_when=asyncio.FIRST_COMPLETED
                        )
                    else:
                        await asyncio.sleep(0.02)

            asyncio.run(work())
            transformer.close()

        def quiesced() -> bool:
            with queue_lock:
                return not queue_items and inflight_n[0] == 0

        # distributed: the input subscriber GATHERS to rank 0, so invoke()
        # runs once per row cluster-wide; the loop-back source is therefore
        # disjoint-by-construction (only rank 0 produces) and registers as
        # "partitioned" so results re-scatter to their key owners — the
        # default replicated-filter would silently drop rows owned by other
        # ranks
        result = register_source(
            schema,
            runner,
            mode="streaming",
            name="async_transformer",
            dist_mode="partitioned",
            quiesce_check=quiesced,
        )

        def on_change(key, row, time, is_addition):
            if not is_addition:
                return
            with queue_lock:
                queue_items.append((int(key), dict(row)))

        def on_end():
            stop.set()

        subscribe(self._input_table, on_change=on_change, on_end=on_end)
        self._result_table = result

    @property
    def successful(self) -> Table:
        assert self._result_table is not None
        return self._result_table

    @property
    def output_table(self) -> Table:
        return self.successful

    def with_options(self, **kwargs) -> "AsyncTransformer":
        """``self`` for a call with no options.  The reference takes any
        option and drops it (a caller's ``capacity`` or ``timeout`` would
        silently do nothing), so the port refuses each one."""
        if kwargs:
            raise NotImplementedError(
                f"AsyncTransformer.with_options({', '.join(sorted(kwargs))}): the options are not supported "
                "(the reference accepts and ignores them)"
            )
        return self
