"""classing_s.families: the ``report.classing`` span, SymPy's classing of
the novel valid rows in ``utils/report.build_report``
(``_canonical_class_key`` on each, then the classes' representatives).
Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["report.classing"])
