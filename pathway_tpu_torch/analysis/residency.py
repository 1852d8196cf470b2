"""The residency lattice and the in-place write registry (counterpart of
``pathway_tpu/analysis/residency.py``).

The value-flow family (``value_flow.py``) tracks, per value, WHERE its
bytes live and whether a reference to them is still what it claims:

    HOST < DEVICE < SNAPSHOT-WRITTEN

- ``HOST`` — a plain Python/NumPy value; touching it is free;
- ``DEVICE`` — the result of a dispatch, a per-shape getter, a
  ``retry_call`` / ``profile.wrap`` wrapper, a transfer to the card or an
  encoder ``.encode(...)`` call: any host coercion of it is a blocking
  device→host transfer that must be booked (``record_fetch``);
- ``SNAPSHOT-WRITTEN`` — the reference donates buffers where the port
  writes in place (``ops/donation_guard.py``).  A reference handed out as
  a SNAPSHOT — passed to ``donation_guard.stamp(...)``, or stored from a
  tensor that a ``note_write`` site writes — must not be written in place
  afterwards (``copy_``, ``index_copy_``, ``index_fill_``, any ``*_``
  method, ``t[...] = v``) unless it was rebound or ``clone()``d in
  between: a reader holding the snapshot would see the new bytes.

The rule classifies expressions to HOST/DEVICE; the snapshot state is
tracked per NAME by the finalize replay (snapshot at the stamp or the
store, cleared on rebind, reported at the in-place write).  This module
is pure data + tiny helpers (no torch import) so the lint runs anywhere;
the runtime twin (``ops/donation_guard.py``) enforces the same
transitions under ``PATHWAY_DONATION_GUARD=1``.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = [
    "DECLARED_TRANSFERS",
    "DEVICE",
    "HOST",
    "IN_PLACE_SITES",
    "SNAPSHOT_WRITTEN",
    "declared_transfers_for",
]

# the lattice, ordered by danger: HOST(0) < DEVICE(1) < SNAPSHOT_WRITTEN(2)
HOST = 0
DEVICE = 1
SNAPSHOT_WRITTEN = 2


# -- in-place write registry ----------------------------------------------
#
# Callables that write INTO one of their positional arguments, keyed by
# program-unique leaf name, mapped to the written positions.  Seeded with
# the port's cross-module in-place entry points, so a call reached through
# an import resolves even when the defining module is not analyzed;
# helpers that forward a parameter into an in-place write are discovered
# from the AST and resolved to a fixpoint (``value_flow``).
IN_PLACE_SITES: Dict[str, Tuple[int, ...]] = {
    # parallel/distributed.py — the collective writes rank src's tensor
    # into every rank's ``t``
    "broadcast": (0,),
}


# -- declared deliberate transfers ----------------------------------------
#
# The static mirror of the in-code ``# pathway: allow(value-flow)``
# pragmas, exactly like ``lock_ranks.DECLARED_EXCEPTIONS`` mirrors the
# lock-order waivers: every DELIBERATE host↔device crossing the
# value-flow rule flags gets (a) a reviewed pragma at the site and (b)
# an entry here naming module, function and why the crossing is sound.
# ``tests/test_torch_analysis.py`` gates the mirror in both directions.
# Keys: (display-path suffix, function qualname).
DECLARED_TRANSFERS: Dict[Tuple[str, str], str] = {
    ("stdlib/indexing/embedding_adapter.py", "EmbeddingIndexAdapter._embed"): (
        "ingest-side host materialization: the adapter's contract is "
        "host float32 rows for the inner index, one batched crossing "
        "per micro-batch, off every serve lock"
    ),
    ("xpacks/llm/embedders.py", "TpuEmbedder.__init__.embed"): (
        "the embedder xpack's UDF contract is a host ndarray: one "
        "batched synchronous fetch per ingest micro-batch, never "
        "inside a serve stage"
    ),
    ("xpacks/llm/embedders.py", "SentenceTransformerEmbedder.__init__.embed"): (
        "SentenceTransformer is a host-side model: its .encode matches "
        "the device-producer spelling but returns numpy rows"
    ),
    ("ops/serving.py", "FusedEncodeSearch._submit_sharded"): (
        "deliberate per-shard device→device scatter: the SAME embedding "
        "is placed on each shard's device once per serve — the transfer "
        "varies by TARGET device, not by value, so there is nothing to "
        "hoist"
    ),
    ("models/clip.py", "ClipModel.encode_text"): (
        "the sync model API: encode_text returns host rows by contract; "
        "serving pipelines submit/complete instead"
    ),
    ("models/clip.py", "ClipModel.encode_image"): (
        "the sync model API: encode_image returns host rows by contract"
    ),
}


def declared_transfers_for(display_path: str) -> Dict[str, str]:
    """``{qualname: reason}`` for the declared deliberate crossings in
    one module (path suffix matched with separators normalised)."""
    path = display_path.replace("\\", "/")
    return {
        qual: reason
        for (suffix, qual), reason in DECLARED_TRANSFERS.items()
        if path.endswith(suffix)
    }
