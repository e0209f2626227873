"""screen_roofline: the least time the runs' screen work could take on
the card (``harness/roofline.py``: the bytes the work needs at 3.35 TB/s)
over all kernel time in the window's CUDA activity trace, whatever the
kernels are named."""

from benchmark.harness import roofline


def read(record):
    trace = record["trace"]
    if not trace or not trace["kernel_s"]:
        return None
    least = len(record["runs"]) * roofline.least_seconds(record["config"])
    return 100.0 * least / trace["kernel_s"]
