"""enum_s: the sum of the depths' ``DepthStats.t_enum``, the host's
candidate generation (``enumerator.py``).  Mean per run."""

from benchmark.harness.record import stage_sum


def read(record):
    return stage_sum(record, "t_enum")
