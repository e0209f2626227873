"""ingest_s: the sum of the depths' ``DepthStats.t_ingest`` (dedup,
verdicts, rows: ``pipeline._ingest_vec``, ``utils/native.py``,
``csrc/ingest_core.cpp``).  Mean per run."""

from benchmark.harness.record import stage_sum


def read(record):
    return stage_sum(record, "t_ingest")
