"""Spans and counters of the port's host work (``PDE_INGEST_TIMERS=1``).

The variable is read when this module is imported; ``benchmark/run.py
--trace 1`` sets it.  With it set, :func:`span` records a block: its
name, its start and end on ``time.perf_counter()`` (the host clock on
which ``benchmark/harness/trace.py`` places the card's events), the span
open below it on the same thread, the thread's name, and its self time,
its duration less that of its children on the same thread;
:func:`traced` records every call of a function as a span, and
:func:`count` adds to a counter.  The engine moves what has been
recorded into a depth's ``DepthStats`` (:func:`drain`): ``spans`` (calls,
inclusive and self seconds by name), ``counts``, ``span_events`` (every
span but the ``ingest.*`` sections) and ``ingest_sections`` (the seconds
of the ``ingest.<key>`` spans, by key).

Without the variable :func:`span` returns one shared object that does
nothing, :func:`traced` returns the function itself, and :func:`count`
and :func:`drain` return at once: no allocation and no clock read.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

ON = bool(os.environ.get("PDE_INGEST_TIMERS"))
SECTION = "ingest."

# closed spans not yet drained: (name, start, end, parent, thread, self)
_done: List[Tuple[str, float, float, Optional[str], str, float]] = []
_counts: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """The span of a process without the variable."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def end(self):
        return None


OFF = _Off()


def _stack() -> list:
    """The spans open on this thread, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "parent", "child", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.child = 0.0
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:                   # ended out of order (a run span)
            stack[:] = [s for s in stack if s is not self]
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child += dur
        rec = (self.name, self.t0, t1,
               None if parent is None else parent.name,
               threading.current_thread().name, dur - self.child)
        with _lock:
            _done.append(rec)

    def end(self):
        self.__exit__(None, None, None)


def span(name: str):
    """A context manager that records the block as span ``name``."""
    return _Span(name) if ON else OFF


def start(name: str):
    """Open span ``name`` now; its ``end()`` closes it (a span that
    outlives the function that opens it)."""
    return span(name).__enter__()


def traced(name: str):
    """Decorator: record every call of the function as span ``name``."""
    def wrap(fn):
        if not ON:
            return fn

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with _Span(name):
                return fn(*args, **kwargs)
        return timed
    return wrap


def count(name: str, n: int = 1) -> None:
    if ON:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def drain(st) -> None:
    """Move the spans closed and the counts added since the last drain
    into the ``DepthStats`` ``st``; with ``st`` None, drop them."""
    global _done, _counts
    if not ON:
        return
    with _lock:
        done, _done = _done, []
        counts, _counts = _counts, {}
    if st is None:
        return
    for name, t0, t1, parent, thread, self_s in done:
        agg = st.spans.get(name)
        if agg is None:
            agg = st.spans[name] = {"n": 0, "s": 0.0, "self": 0.0}
        agg["n"] += 1
        agg["s"] += t1 - t0
        agg["self"] += self_s
        if name.startswith(SECTION):
            key = name[len(SECTION):]
            st.ingest_sections[key] = (st.ingest_sections.get(key, 0.0)
                                       + t1 - t0)
        else:
            st.span_events.append((name, t0, t1, parent, thread))
    # in the order they ended: two threads may append out of it
    st.span_events.sort(key=lambda e: e[2])
    for k, v in counts.items():
        st.counts[k] = st.counts.get(k, 0) + v


def pending() -> Dict[str, float]:
    """Inclusive seconds by name of the spans closed since the last
    drain (a progress line's view of the current depth)."""
    with _lock:
        done = list(_done)
    out: Dict[str, float] = {}
    for name, t0, t1, *_ in done:
        out[name] = out.get(name, 0.0) + t1 - t0
    return out
