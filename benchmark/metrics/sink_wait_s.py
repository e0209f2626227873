"""sink_wait_s: the ``sink.wait`` spans, the main thread blocked on the
native reject sink (``utils/native.NativeRejectSink``): a full 8-batch
queue in ``emit``, and the queue's join in ``flush`` (each depth
barrier) and ``close``.  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["sink.wait"])
