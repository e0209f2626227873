"""completion_s.families: ``completion_s`` where the report runs its family
pass: the run's wall less the sum of its depths' ``DepthStats.seconds``,
which holds the family pass and SymPy's classing of every valid row beside
the knowns check, the DB completion and the report files.  Mean per run."""

from benchmark.harness.record import per_run


def read(record):
    return per_run(record, lambda r: r["wall_s"]
                   - sum(s["seconds"] for s in r["stats"]))
