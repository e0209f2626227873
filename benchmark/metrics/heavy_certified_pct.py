"""heavy_certified_pct: the share of the heavy checks that the gray
worker's gradient certificate decided without SymPy
(``100 * heavy.certified / (heavy.certified + heavy.sympy)``, counters of
``pipeline._finalize_pass``; ``ops/gradcert.py``).  Mean per run."""

from benchmark.harness.record import per_run
from benchmark.harness.spans import count_sum, traced


def _share(run):
    certified = count_sum(run, "heavy.certified")
    return 100.0 * certified / max(certified
                                   + count_sum(run, "heavy.sympy"), 1)


def read(record):
    if not traced(record) or not any(
            count_sum(r, "heavy.certified") + count_sum(r, "heavy.sympy")
            for r in record["runs"]):
        return None
    return per_run(record, _share)
