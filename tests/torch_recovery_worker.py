"""Subprocess worker of the port's crash-recovery tests
(``tests/test_torch_recovery_e2e.py``; counterpart of
``tests/recovery_worker.py``): a persistent wordcount over a directory
of CSV files, written to a CSV sink.  Torch only: it imports no JAX.

Env: RECOVERY_DATA_DIR (the csv input directory), RECOVERY_OUT (the
output csv), RECOVERY_MODE (``streaming``, the default, watches the
directory forever; ``static`` reads it once and ends), plus the
PATHWAY_PERSISTENT_STORAGE / PATHWAY_PERSISTENCE_MODE /
PATHWAY_SNAPSHOT_INTERVAL_MS variables ``pw.run()`` reads.
"""

from __future__ import annotations

import os


def main() -> None:
    import pathway_tpu_torch as pw

    class Row(pw.Schema):
        word: str

    docs = pw.io.csv.read(
        os.environ["RECOVERY_DATA_DIR"],
        schema=Row,
        mode=os.environ.get("RECOVERY_MODE", "streaming"),
        poll_interval_s=0.1,
        persistent_id="wc_input",
    )
    counts = docs.groupby(docs.word).reduce(word=docs.word, count=pw.reducers.count())
    pw.io.csv.write(counts, os.environ["RECOVERY_OUT"])
    pw.run(monitoring_level=None, commit_duration_ms=50)


if __name__ == "__main__":
    main()
