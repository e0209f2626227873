"""sink_blocked_pct: the share of the native reject sink's batches whose
``emit`` found its 8-batch queue full and waited
(``100 * sink.blocked / sink.batches``, counters of
``utils/native.NativeRejectSink``).  Mean per run."""

from benchmark.harness.record import per_run
from benchmark.harness.spans import count_sum, traced


def read(record):
    if not traced(record) or not any(
            count_sum(r, "sink.batches") for r in record["runs"]):
        return None
    return per_run(record, lambda r: 100.0 * count_sum(r, "sink.blocked")
                   / max(count_sum(r, "sink.batches"), 1))
