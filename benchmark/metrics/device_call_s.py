"""device_call_s: the sum of the depths' ``DepthStats.t_device``, the host
clock around the kernel launches and the verdict copies
(``pipeline.route_segmented``, ``_unpack_start`` / ``_unpack_finish``).  Mean
per run."""

from benchmark.harness.record import stage_sum


def read(record):
    return stage_sum(record, "t_device")
