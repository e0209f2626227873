"""row_emit_s: the self time of the ``gray.emit`` and ``finalize`` spans
(``pipeline._emit_gray_part``, ``_finalize_pass``): building the rows of
the gray rows and the screen passers and handing them to the run DB's
buffer, less their heavy checks and known match.  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["gray.emit", "finalize"], "self")
