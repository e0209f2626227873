"""report_s: the self time of the ``report`` span, the completion after
the last depth less its DB writes, index build, family pass and classing:
the valid rows read back, the report built and its files written.  Mean
per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["report"], "self")
