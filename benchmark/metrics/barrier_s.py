"""barrier_s: the self time of the ``depth.barrier`` spans
(``runtime.DiscoveryRun.run``'s ``on_depth``): the jet snapshot, the
registry sidecar and the depth line, less the sink's flush and the DB
writes.  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["depth.barrier"], "self")
