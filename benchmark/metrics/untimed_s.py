"""untimed_s: the stage time no timer of the program covers, summed over
the depths: ``seconds - t_enum - t_device - t_ingest - t_gray``.  Most of it
is the gray rows' finalisation on the main thread.  Mean per run."""

from benchmark.harness.record import per_run


def read(record):
    return per_run(record, lambda r: sum(
        s["seconds"] - s["t_enum"] - s["t_device"] - s["t_ingest"]
        - s["t_gray"] for s in r["stats"]))
