"""Hot-path static analysis for pathway_tpu_torch (counterpart of
``pathway_tpu/analysis``, written for the port's idioms).

An AST lint framework plus six rule families over the port's tree:

- ``lock-discipline`` — device dispatch / host sync / transfers /
  GIL-holding C calls lexically inside ``with <lock>:`` bodies;
- ``hidden-sync`` — implicit host round trips on serve-path modules,
  cross-checked against the ``ops/dispatch_counter.py`` budget;
- ``recompile-hazard`` — the shape census: an upload of host data with
  no bucketing reaching a callable a ``RecompileTripwire`` or
  ``guarded_jit`` observes (``ops/recompile_guard.py``);
- ``lock-order`` — the whole-program lock graph (``lock_order.py`` +
  ``lock_ranks.py``): hierarchy inversions, deadlock cycles with witness
  paths, ``Condition.wait`` holding a second lock, locks in traced
  scopes — paired with the runtime tripwire in ``sanitizer.py``
  (``PATHWAY_LOCK_SANITIZER=1``);
- ``value-flow`` — ``value_flow.py`` + ``residency.py``:
  write-after-snapshot (the static twin of ``ops/donation_guard.py``),
  hidden host transfers, redundant loop-invariant uploads;
- ``knob-discipline`` — every ``PATHWAY_*`` read through the knob table.

Run ``python -m pathway_tpu_torch.analysis pathway_tpu_torch/`` for
file:line diagnostics (``--format sarif`` for CI diff annotation,
``--check-pragmas`` for the stale-waiver audit, ``PATHWAY_ANALYSIS_CACHE``
for incremental runs); suppress a reviewed finding in place with
``# pathway: allow(<rule>): <reason>``.  The tier-1 gate
(``tests/test_torch_analysis.py``) asserts the whole port stays clean.
The package is standard library plus ``ast``: no torch at module scope.
"""

from .core import (
    Finding,
    ModuleContext,
    Rule,
    analyze_file,
    analyze_paths,
    analyze_source,
    default_rules,
    iter_py_files,
    stale_pragma_findings,
)
from .hidden_sync import HiddenSyncRule
from .knob_discipline import KnobDisciplineRule
from .lock_discipline import LockDisciplineRule
from .lock_order import LockOrderRule
from .recompile_hazard import RecompileHazardRule
from .value_flow import ValueFlowRule

__all__ = [
    "Finding",
    "HiddenSyncRule",
    "KnobDisciplineRule",
    "LockDisciplineRule",
    "LockOrderRule",
    "ModuleContext",
    "RecompileHazardRule",
    "Rule",
    "ValueFlowRule",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "default_rules",
    "iter_py_files",
    "main",
    "stale_pragma_findings",
]


def main(argv=None) -> int:
    from .__main__ import main as _main

    return _main(argv)
