"""search_s.families: a whole run's wall, from ``DiscoveryRun(...)`` to
``.close()``, in a cell whose runs spread too widely for ``search_s`` to be
held to a bound there (the report's family pass runs SymPy's classing on
the main thread).  Mean per run."""

from benchmark.harness.record import per_run


def read(record):
    return per_run(record, lambda r: r["wall_s"])
