"""ingest_rejects_s: the ``rejects`` section of the depths'
``DepthStats.ingest_sections``, the native reject sink.  The sections are
timed only with ``PDE_INGEST_TIMERS`` set before the port is imported, as
the traced run does; without them there is nothing to read.  Mean per
run."""

from benchmark.harness.record import per_run


def read(record):
    if not any(s["ingest_sections"] for r in record["runs"]
               for s in r["stats"]):
        return None
    return per_run(record, lambda r: sum(
        s["ingest_sections"].get("rejects", 0.0) for s in r["stats"]))
