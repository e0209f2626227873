"""gray_wait_s: the ``gray.wait`` spans, the main thread blocked on the
gray worker's float64 recheck (each ``fut.result()`` in
``pipeline._flush_gray`` and ``_gray_maybe_submit``).  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["gray.wait"])
