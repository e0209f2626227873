"""match_known_s: the ``match_known`` spans, each valid row's match
against the known solutions (``pipeline._match_known``: a fingerprint
test, then SymPy's ``simplify`` on a near match), summed over the depths.
Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["match_known"])
