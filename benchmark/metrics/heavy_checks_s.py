"""heavy_checks_s: the ``heavy_checks`` spans, each valid row's SymPy
heavy checks (``tape_to_sympy`` and ``problem.heavy_checks`` inside
``pipeline._finalize_pass``), summed over the depths: inside ``t_ingest``
for a screen passer, inside ``t_gray`` or outside the four timers for a
gray row.  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["heavy_checks"])
