"""unspanned_s: what no span names, the self time of the ``run`` span
(from ``DiscoveryRun(...)`` to the end of ``.close()``) and of the
``depth`` spans (each depth's ``DepthStats.seconds``).  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["run", "depth"], "self")
