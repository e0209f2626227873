"""What the readers of the program's spans share.

With ``PDE_INGEST_TIMERS`` set, as the traced run sets it, the port
records spans and counters (``pde_engine_tpu_torch/utils/spans.py``) into
each depth's ``DepthStats``: ``spans`` maps a span's name to its calls
(``n``), inclusive seconds (``s``) and self seconds (``self``, less its
children on the same thread), and ``counts`` a counter's name to its
value.  A record none of whose depths holds ``spans`` (a run without the
variable, or a program without the recorder) reads None.
"""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark.harness.record import per_run


def traced(record) -> bool:
    return any(s.get("spans") for r in record["runs"] for s in r["stats"])


def span_sum(record, names: Iterable[str], key: str = "s"
             ) -> Optional[float]:
    """The mean over runs of the sum over depths of ``key`` of the spans
    ``names``."""
    if not traced(record):
        return None
    names = list(names)
    return per_run(record, lambda r: sum(
        s["spans"].get(n, {}).get(key, 0.0)
        for s in r["stats"] for n in names))


def count_sum(run, name: str) -> int:
    """A counter summed over a run's depths."""
    return sum(s.get("counts", {}).get(name, 0) for s in run["stats"])
