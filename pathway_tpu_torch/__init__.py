"""PyTorch/CUDA port of pathway_tpu: ``import pathway_tpu_torch as pw``.

The JAX package ``pathway_tpu`` is the reference; this package mirrors
its module layout so each counterpart is easy to find, and never imports
it.  Entry points that touch the device run on the CUDA device unless the
caller passes ``device="cpu"`` explicitly (see ``device.py``).

The ``pw`` namespace: the table and expression API (``internals/``), the
incremental engine (``engine/``) with its persistence (``persistence``:
input logs, operator snapshots, ``pw.run(persistence_config=...)``),
``debug``, ``demo``, ``io`` (``python``, ``subscribe``, the file
connectors ``fs`` / ``csv`` / ``jsonlines`` / ``plaintext``, ``sqlite``,
``null``, the REST connector ``http``, and the connectors whose transport
needs a client library, imported when called: ``kafka``, ``debezium``,
``s3``, ``postgres`` and 15 more), ``iterate`` (fixed points over a
nested engine graph), ``stdlib.indexing`` (``DataIndex`` over the device
KNN indexes, BM25, the hybrid index, sorting), ``ml`` (``KNNIndex``, the
LSH index, ``knn_classifier``), ``stateful``, ``temporal`` (windows,
behaviors, interval / asof / window joins), ``ordered``, ``statistical``,
``graphs``, ``xpacks.llm`` (``DocumentStore`` retrieval, chat, rerankers,
the RAG answerers and their REST servers), the process config
(``get_config``, ``set_license_key``, ``set_monitoring_config``; the knob
table is ``pw.config``), ``load_yaml`` (the template loader; the command
line is ``python -m pathway_tpu_torch.cli``), ``sql``, the row
transformers (``transformer``, ``ClassArg``, ...), ``export_table`` /
``import_table``, interactive mode (``LiveTable``), ``utils``
(``AsyncTransformer``, ``pandas_transformer``, ``col``), ``viz``, the
fuzzy joins and the HMM reducer (``ml``) and the deprecated
``asynchronous``.  ``pw.run`` exports OTLP spans through
``internals/telemetry.py`` when a monitoring endpoint is set and
``opentelemetry`` is installed.

Device modules below the framework: host tokenizer -> ``TransformerEncoder``
forward + masked mean pool + L2 normalize -> exact (``DeviceKnnIndex``)
or IVF (``IvfKnnIndex``, with background absorb and retrain) stage-1
search, the rerank tier, the serve front (``serve.ServeScheduler``),
generator decode, sharded serving and the serve fabric.  The IVF shortlist
rescore is a hand-written CUDA kernel (``csrc/ivf_rescore.cu``); the
decode path's LayerNorm and readout are port-side CUDA kernels
(``csrc/decode_rows.cu``).
"""

from __future__ import annotations

# the runtime lock-order sanitizer must patch the threading constructors
# BEFORE any module of the package creates its locks — this import chain
# is where they all get created, so the hook runs first.  The knob table
# is pure stdlib, so it loads before everything; the analysis package
# loads only when the knob is on.
from . import config

if config.get("analysis.lock_sanitizer"):
    from .analysis.sanitizer import install as _sanitizer_install

    _sanitizer_install()

import datetime as _datetime
from .device import DEFAULT_DTYPE, resolve_device
from .internals import dtype as dt
from .internals import api_reducers as reducers
from .internals.api_reducers import BaseCustomAccumulator
from .internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    CoalesceExpression,
    ColumnExpression,
    ColumnReference,
    IfElseExpression,
    MakeTupleExpression,
    RequireExpression,
)
from .internals.config import PathwayConfig, get_config, set_license_key, set_monitoring_config
from .internals.export_import import ExportedTable, export_table, import_table
from .internals.interactive import LiveTable, enable_interactive_mode
from .internals.iterate import iterate, iterate_universe
from .internals.keys import Pointer, ref_scalar
from .internals.monitoring import MonitoringLevel
from .internals.parse_graph import G
from .internals.py_object_wrapper import PyObjectWrapper, wrap_py_object
from .internals.row_transformer import (
    ClassArg,
    attribute,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from .internals.run import run, run_all
from .internals.schema import (
    ColumnDefinition,
    Schema,
    SchemaProperties,
    column_definition,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_types,
)
from .internals.sql import sql
from .internals.table import (
    GroupedJoinResult,
    GroupedTable,
    Joinable,
    JoinMode,
    JoinResult,
    Table,
    TableLike,
    TableSlice,
)
from .internals.thisclass import left, right, this
from .internals.universe import Universe
from .internals.yaml_loader import load_yaml
from .internals import udfs
from .internals.udfs import UDF, udf, udf_async
from . import debug  # noqa: E402
from . import demo  # noqa: E402
from . import io  # noqa: E402
from . import persistence  # noqa: E402
from . import universes  # noqa: E402
from .persistence import PersistenceMode  # noqa: E402

__all__ = [
    "DEFAULT_DTYPE",
    "resolve_device",
    "Schema",
    "Table",
    "this",
    "left",
    "right",
    "column_definition",
    "schema_from_types",
    "udf",
    "UDF",
    "reducers",
    "run",
    "debug",
    "demo",
    "io",
    "persistence",
    "PersistenceMode",
    "reset",
    "load_yaml",
]

# deprecated aliases kept for reference compatibility
UDFSync = UDF
UDFAsync = UDF

__version__ = "0.1.0"


def reset() -> None:
    """Clear the global computation graph (fresh build)."""
    G.clear()
    from .internals.error_log import clear_error_log, reset_local_sinks

    clear_error_log()
    reset_local_sinks()
    from .internals.export_import import close_all_exports

    close_all_exports()
    from .internals.universe_solver import get_solver

    get_solver().clear()


def global_error_log() -> list:
    """Row-level errors recorded this run (see internals/error_log.py)."""
    from .internals.error_log import global_error_log as _gel

    return _gel()


def local_error_log():
    """Context manager capturing errors raised while open."""
    from .internals.error_log import local_error_log as _lel

    return _lel()


# ---------------------------------------------------------------------------
# free functions of the pw.* namespace
# ---------------------------------------------------------------------------

def apply(fun, *args, **kwargs) -> ApplyExpression:
    """Row-wise python function application (reference pw.apply)."""
    return ApplyExpression(fun, None, args=args, kwargs=kwargs)


def apply_with_type(fun, ret_type, *args, **kwargs) -> ApplyExpression:
    return ApplyExpression(fun, ret_type, args=args, kwargs=kwargs)


def apply_async(fun, *args, **kwargs) -> AsyncApplyExpression:
    return AsyncApplyExpression(fun, None, args=args, kwargs=kwargs)


def if_else(if_clause, then_clause, else_clause) -> IfElseExpression:
    return IfElseExpression(if_clause, then_clause, else_clause)


def coalesce(*args) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val, *args) -> RequireExpression:
    return RequireExpression(val, *args)


def make_tuple(*args) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def cast(target_type, expr):
    from .internals.expression import CastExpression

    return CastExpression(expr, target_type)


def declare_type(target_type, col):
    """Retype a column in the schema only; values pass through unchanged."""
    from .internals.expression import DeclareTypeExpression

    return DeclareTypeExpression(col, target_type)


def fill_error(col, replacement):
    """Replace Error cells with ``replacement`` per row."""
    from .internals.expression import FillErrorExpression

    return FillErrorExpression(col, replacement)


def join(left_table, right_table, *on, id=None, how=JoinMode.INNER) -> JoinResult:
    return left_table.join(right_table, *on, id=id, how=how)


def join_inner(left_table, right_table, *on, id=None) -> JoinResult:
    return left_table.join_inner(right_table, *on, id=id)


def join_left(left_table, right_table, *on, id=None) -> JoinResult:
    return left_table.join_left(right_table, *on, id=id)


def join_right(left_table, right_table, *on, id=None) -> JoinResult:
    return left_table.join_right(right_table, *on, id=id)


def join_outer(left_table, right_table, *on, id=None) -> JoinResult:
    return left_table.join_outer(right_table, *on, id=id)


def groupby(grouped, *args, **kwargs):
    return grouped.groupby(*args, **kwargs)


def unwrap(expr):
    from .internals.expression import smart_coerce

    return smart_coerce(expr)


def assert_table_has_schema(table, schema, *, allow_superset=False) -> None:
    th = table.typehints()
    for name in schema.column_names():
        if name not in th:
            raise AssertionError(f"column {name} missing from table")
    if not allow_superset:
        extra = set(th) - set(schema.column_names())
        if extra:
            raise AssertionError(f"unexpected columns: {extra}")


def table_transformer(fn=None, **kwargs):
    """Decorator marking a Table->Table transformer (typing sugar)."""

    def wrap(f):
        return f

    return wrap(fn) if fn is not None else wrap


# stdlib and xpacks load lazily, so plain pipelines skip the model stack;
# ``asynchronous`` too, so its DeprecationWarning fires only on use
_LAZY_SUBMODULES = {
    name: name for name in ("cache", "stdlib", "xpacks", "models", "ops", "parallel", "serve", "asynchronous")
}
_LAZY_SUBMODULES.update(
    indexing="stdlib.indexing", ml="stdlib.ml", stateful="stdlib.stateful", temporal="stdlib.temporal",
    ordered="stdlib.ordered", statistical="stdlib.statistical", graphs="stdlib.graphs",
)
# names defined in those submodules that the reference's ``pw`` exports
_LAZY_NAMES = {
    name: "stdlib.temporal"
    for name in (
        "AsofJoinResult", "IntervalJoinResult", "WindowJoinResult", "asof_join", "interval_join", "window_join",
        "windowby",
    )
}
_LAZY_NAMES.update(
    utils="stdlib", viz="stdlib", AsyncTransformer="stdlib.utils.async_transformer",
    pandas_transformer="stdlib.utils.pandas_transformer",
)


def __getattr__(name: str):
    import importlib

    if name in _LAZY_SUBMODULES:
        value = importlib.import_module(f".{_LAZY_SUBMODULES[name]}", __name__)
    elif name in _LAZY_NAMES:
        value = getattr(importlib.import_module(f".{_LAZY_NAMES[name]}", __name__), name)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


Json = dt.JSON
Pointer_ = Pointer
DateTimeNaive = _datetime.datetime
DateTimeUtc = _datetime.datetime
Duration = _datetime.timedelta
Type = dt.PathwayType
OuterJoinResult = JoinResult
