"""Helpers of the per-layer readers over a traced run's record.

A record holds ``runs``, one entry per whole run of the window, each with
its ``wall_s`` and ``stats`` (the program's ``DepthStats`` of each depth,
as dicts); ``config`` and ``traffic``, the cell's files; and ``trace``,
the summary of the window's CUDA activity trace
(``harness/trace.summarize``).
"""

from __future__ import annotations

from statistics import mean


def per_run(record, fn) -> float:
    """The mean over the window's runs of ``fn(run)``."""
    return mean(fn(r) for r in record["runs"])


def stage_sum(record, field: str) -> float:
    """The mean over runs of the sum over depths of a ``DepthStats``
    field."""
    return per_run(record, lambda r: sum(s[field] for s in r["stats"]))
