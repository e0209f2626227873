"""family_pass_s.families: the ``report.families`` span, the report's
array-level family tagging of the valid rows
(``runtime.DiscoveryRun._family_pass``, ``utils/families.py``).  Mean per
run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["report.families"])
