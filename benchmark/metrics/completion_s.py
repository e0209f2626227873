"""completion_s: the run's wall (from ``DiscoveryRun(...)`` to
``.close()``) less the sum of its depths' ``DepthStats.seconds``: engine
construction, the knowns check, the family pass, the DB completion and the
report files (``runtime.py``, ``utils/report.py``, ``utils/db.py``).  Mean
per run."""

from benchmark.harness.record import per_run


def read(record):
    return per_run(record, lambda r: r["wall_s"]
                   - sum(s["seconds"] for s in r["stats"]))
