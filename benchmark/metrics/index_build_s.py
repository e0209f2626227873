"""index_build_s: the ``report.index_build`` span, the run table's four
secondary indices built once the last depth is stored
(``RunDB.ensure_indices``).  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["report.index_build"])
