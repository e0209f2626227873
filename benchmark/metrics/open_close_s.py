"""open_close_s: the self time of the ``run.open`` and ``run.close``
spans: the engine's and the run DB's construction, the knowns'
fingerprints and their validation, the fresh run's clean-up; the sink's,
the gray worker's and the DB's close.  Mean per run."""

from benchmark.harness.spans import span_sum


def read(record):
    return span_sum(record, ["run.open", "run.close"], "self")
