"""The work a discovery run asks of the card, and the card's peaks.

The screen kernels read the jet cache, take each candidate's operand
indices, write its verdict, and write each new unique row's jets.  The
least traffic that work needs, counted from the configuration's data and
never from the program:

- at depth d, every cache row present when the depth starts, read once at
  the configuration's row width: the uniques of depths 1 .. d-1;
- for each candidate, two 4-byte operand indices and its 12-byte verdict;
- each new unique row's jets, written once at the row width.

At 3.35 TB/s these bytes take longer than the float32 operations at
67 TFLOP/s, so the bytes bound the run.  The bound counts the work, not
what an implementation writes, so a kernel that writes less cannot read
above 100%.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet): HBM3 bandwidth, dense float32 outside the
# tensor cores, at the full 700 W power limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}

INDEX_BYTES = 8      # two int32 operand ids a candidate
VERDICT_BYTES = 12   # the packed verdict a candidate


def run_bytes(config: dict) -> int:
    """Bytes one whole run to the configuration's depth needs."""
    counts, width = config["counts"], int(config["row_bytes"])
    total, cached = 0, 0
    for cand, uniq in zip(counts["candidates"][:config["max_depth"]],
                          counts["unique"][:config["max_depth"]]):
        total += (cached * width + cand * (INDEX_BYTES + VERDICT_BYTES)
                  + uniq * width)
        cached += uniq
    return total


def least_seconds(config: dict) -> float:
    """The least time the card could take for one run's screen work."""
    return run_bytes(config) / PEAKS["hbm_bytes_per_s"]
