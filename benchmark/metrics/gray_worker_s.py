"""gray_worker_s: the ``gray.numeric`` spans, the gray worker thread busy
with the float64 recheck (``pipeline._gray_numeric``), beside the main
thread.  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["gray.numeric"])
