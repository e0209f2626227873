"""gray_s: the sum of the depths' ``DepthStats.t_gray``, the float64
recheck's depth-end flush.  Mean per run."""

from benchmark.harness.record import stage_sum


def read(record):
    return stage_sum(record, "t_gray")
