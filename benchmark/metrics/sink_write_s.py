"""sink_write_s: the ``sink.write`` spans, the sink's writer thread busy
writing reject batches into the run DB (``NativeRejectSink._emit_now``,
the C++ prepared-statement writer).  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["sink.write"])
