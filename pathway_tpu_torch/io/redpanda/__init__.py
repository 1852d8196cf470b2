"""pw.io.redpanda — Redpanda connector (Kafka-API compatible; counterpart
of ``pathway_tpu/io/redpanda``; reference:
python/pathway/io/redpanda/__init__.py re-exports the kafka connector)."""

from __future__ import annotations

from ..kafka import read, write  # noqa: F401

__all__ = ["read", "write"]
