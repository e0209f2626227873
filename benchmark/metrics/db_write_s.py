"""db_write_s: the ``db.write`` spans, the run DB's flushes, metadata,
heartbeats and generator state that ``runtime.py`` writes (a depth's
batch heartbeat, its barrier, the run's start and completion).  Mean per
run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["db.write"])
