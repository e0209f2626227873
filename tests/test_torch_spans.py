"""The port's spans and counters (``utils/spans.py``, on with
``PDE_INGEST_TIMERS=1``) and the benchmark's readers of them.

On the CPU: a laplace depth-4 ``DiscoveryRun`` with ``--heavy-checks``
and the report's family pass, in a process of its own with the variable
set (it is read when the port is imported), and a depth-2 run without
it.  On a card (marked ``gpu``; ``python -m pytest tests/test_torch_spans.py
-m gpu --noconftest -s``): a laplace depth-3 run under the benchmark's
CUDA activity trace, each screen kernel held to the ``device`` span that
launched it, and the share of the card's idle time that a span names.

This file imports no JAX.
"""

from __future__ import annotations

import bisect
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = r"""
import dataclasses, json, sys, tempfile, time
import torch
torch.set_num_threads(1)
from pde_engine_tpu_torch.runtime import DiscoveryRun
from pde_engine_tpu_torch.utils import spans
from pde_engine_tpu_torch.utils.config import SearchConfig
out, depth = sys.argv[1], int(sys.argv[2])
with tempfile.TemporaryDirectory() as d:
    t0 = time.perf_counter()
    run = DiscoveryRun("laplace",
                       SearchConfig(max_depth=depth, defer_heavy_checks=False),
                       device="cpu", db_path=d + "/run.db",
                       report_families=True)
    try:
        run.run(depth)
    finally:
        run.close()
    wall = time.perf_counter() - t0
res = {"on": spans.ON, "wall_s": wall,
       "stats": [dataclasses.asdict(s) for s in run.engine.stats],
       "summary_keys": sorted(run.engine.summary()["depths"][0])}
if not spans.ON:
    def loop():
        for _ in range(100000):
            with spans.span("x"):
                spans.count("c")
    loop()
    b0 = sys.getallocatedblocks()
    loop()
    res["blocks"] = sys.getallocatedblocks() - b0
    res["shared"] = spans.span("a") is spans.span("b") is spans.OFF
    fn = lambda: 1
    res["traced_is_fn"] = spans.traced("f")(fn) is fn

    def no_clock():
        raise AssertionError("clock read")
    real, time.perf_counter = time.perf_counter, no_clock
    try:
        with spans.span("x"):
            spans.count("c")
        spans.start("y").end()
        spans.drain(run.engine.stats[-1])
        res["clock_untouched"] = True
    finally:
        time.perf_counter = real
json.dump(res, open(out, "w"))
"""

SECTIONS = {"keys", "dedup", "register", "verdicts", "rejects", "passers",
            "cache_append"}
# where each span's work runs: "every" depth, the depths from 2 on
# ("deep"), the run's "first" or "last" depth, or "any" of them
WHERE = {"run": "last", "run.open": "first", "depth": "every",
         "enum": "deep", "device": "deep", "ingest": "deep",
         "gray.flush": "every", "gray.emit": "any", "finalize": "every",
         "heavy_checks": "every", "match_known": "every", "gray.wait": "any",
         "db.write": "every", "depth.barrier": "every", "sink.wait": "every",
         "report.index_build": "last", "report": "last",
         "report.families": "last", "report.classing": "last",
         "run.close": "last", "gray.numeric": "any", "sink.write": "deep"}
THREADS = {"gray.numeric": "gray_", "sink.write": "sink"}
TIMERS = [("depth", "seconds"), ("enum", "t_enum"), ("device", "t_device"),
          ("ingest", "t_ingest"), ("gray.flush", "t_gray")]
READERS = ["heavy_checks_s", "match_known_s", "row_emit_s", "gray_wait_s",
           "gray_worker_s", "sink_wait_s", "sink_write_s",
           "sink_blocked_pct", "db_write_s", "barrier_s", "index_build_s",
           "report_s", "open_close_s", "unspanned_s",
           "family_pass_s.families", "classing_s.families"]


def _run(tmp, depth: int, on: bool):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("PDE_INGEST_TIMERS", None)
    if on:
        env["PDE_INGEST_TIMERS"] = "1"
    out = str(tmp / "run.json")
    r = subprocess.run([sys.executable, "-c", _RUN, out, str(depth)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out) as f:
        res = json.load(f)
    assert res["on"] is on
    res["stdout"] = r.stdout
    return res


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("traced"), 4, True)


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("untraced"), 2, False)


def _record(res):
    return {"runs": [{"wall_s": res["wall_s"], "stats": res["stats"]}],
            "trace": None}


def _events(res):
    return [tuple(e) for s in res["stats"] for e in s["span_events"]]


@pytest.mark.parametrize("name", sorted(WHERE))
def test_each_span_is_recorded_where_its_work_ran(traced, name):
    stats = traced["stats"]
    where = WHERE[name]
    got = [name in s["spans"] for s in stats]
    want = {"every": [True] * len(stats),
            "deep": [False] + [True] * (len(stats) - 1),
            "first": [True] + [False] * (len(stats) - 1),
            "last": [False] * (len(stats) - 1) + [True]}.get(where)
    if want is None:
        assert any(got), name
    else:
        assert got == want, (name, got)
    n = sum(s["spans"][name]["n"] for s in stats if name in s["spans"])
    assert n == sum(e[0] == name for e in _events(traced))
    if name == "run.open":
        assert n == 2          # the construction, then run()'s opening
    if name in ("run", "report", "report.classing", "report.families",
                "report.index_build", "run.close"):
        assert n == 1
    if name in ("depth", "depth.barrier"):
        assert all(s["spans"][name]["n"] == 1 for s in stats)


def test_sink_counters(traced):
    for s in traced["stats"][1:]:
        c = s["counts"]
        assert c["sink.rows"] >= c["sink.batches"] > 0
        assert 0 <= c.get("sink.blocked", 0) <= c["sink.batches"]
        assert c["sink.batches"] == s["spans"]["sink.write"]["n"]
    assert traced["stats"][0]["counts"] == {}


def test_self_time_within_inclusive_time(traced):
    for s in traced["stats"]:
        for name, v in s["spans"].items():
            assert v["n"] >= 1 and v["s"] >= 0.0, name
            assert -1e-9 <= v["self"] <= v["s"] + 1e-9, (name, v)


def test_children_lie_inside_their_parents(traced):
    """Each span lies inside a span of its parent's name on its thread
    (an ``ingest.*`` section's children inside an ``ingest`` span)."""
    by = {}
    for name, a, b, parent, thread in _events(traced):
        by.setdefault((name, thread), []).append((a, b))
    for v in by.values():
        v.sort()
    n_checked = 0
    for name, a, b, parent, thread in _events(traced):
        if parent is None:
            assert name in ("run", "gray.numeric", "sink.write"), name
            continue
        if parent.startswith("ingest."):
            parent = "ingest"
        spans = by[(parent, thread)]
        i = bisect.bisect_right(spans, (a, float("inf"))) - 1
        assert i >= 0 and spans[i][0] <= a and b <= spans[i][1], \
            (name, parent, a, b)
        n_checked += 1
    assert n_checked > 1000


def test_worker_spans_carry_their_threads_names(traced):
    threads = {}
    for name, _, _, _, thread in _events(traced):
        threads.setdefault(name, set()).add(thread)
    for name, ts in threads.items():
        prefix = THREADS.get(name)
        if prefix is None:
            assert ts == {"MainThread"}, (name, ts)
        else:
            assert len(ts) == 1 and ts.pop().startswith(prefix), (name, ts)


def test_events_are_ordered_and_inside_the_run(traced):
    ev = _events(traced)
    for s in traced["stats"]:
        ends = [e[2] for e in s["span_events"]]
        assert ends == sorted(ends)
    runs = [e for e in ev if e[0] == "run"]
    assert len(runs) == 1
    _, r0, r1, _, _ = runs[0]
    assert r1 - r0 <= traced["wall_s"]
    for name, a, b, _, _ in ev:
        assert r0 <= a <= b <= r1, name
    assert not any(e[0].startswith("ingest.") for e in ev)


@pytest.mark.parametrize("span,field", TIMERS)
def test_the_depth_spans_hold_the_depth_timers(traced, span, field):
    """``depth``, ``enum``, ``device``, ``ingest`` and ``gray.flush``
    time the intervals of ``seconds`` and the four ``t_*`` fields."""
    for s in traced["stats"]:
        if span not in s["spans"]:
            assert s[field] == 0.0
            continue
        v = s["spans"][span]
        assert s[field] <= v["s"] <= s[field] + 1e-3 + 5e-5 * v["n"], \
            (s["depth"], span, v, s[field])


def test_unspanned_time_is_under_5pct_of_the_wall(traced):
    rec = _record(traced)
    unspanned = spec.metric_reader("unspanned_s")(rec)
    assert 0.0 <= unspanned < 0.05 * traced["wall_s"]


def test_ingest_sections_within_t_ingest(traced):
    assert traced["stats"][0]["ingest_sections"] == {}
    for s in traced["stats"][1:]:
        sec = s["ingest_sections"]
        assert set(sec) == SECTIONS
        assert 0 < sum(sec.values()) <= s["t_ingest"]
        for k, v in sec.items():
            assert v == pytest.approx(s["spans"]["ingest." + k]["s"])


def test_spans_line_follows_each_depth_line(traced):
    lines = traced["stdout"].splitlines()
    depth_lines = [i for i, ln in enumerate(lines)
                   if ln.startswith("  depth ") and " candidates, " in ln]
    assert len(depth_lines) == len(traced["stats"])
    for i, s in zip(depth_lines, traced["stats"]):
        j = i + 1 + (s["depth"] > 1)
        if s["depth"] > 1:
            assert lines[i + 1].startswith("    ingest breakdown: ")
        assert lines[j].startswith("    spans: "), lines[j]
        assert " depth 1x " in lines[j], lines[j]


def test_summary_leaves_the_traced_fields_out(traced):
    assert not {"ingest_sections", "spans", "counts",
                "span_events"} & set(traced["summary_keys"])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_run_and_nothing_else(traced, untraced, name):
    read = spec.metric_reader(name)
    v = read(_record(traced))
    assert isinstance(v, float) and v >= 0.0, (name, v)
    if name.endswith("_pct"):
        assert v <= 100.0
    # tracing off, and a program whose DepthStats has no such fields
    assert read(_record(untraced)) is None
    older = [{k: v for k, v in s.items()
              if k not in ("spans", "counts", "span_events")}
             for s in traced["stats"]]
    assert read({"runs": [{"wall_s": 1.0, "stats": older}],
                 "trace": None}) is None


def test_without_the_variable_the_fields_stay_empty(untraced):
    for s in untraced["stats"]:
        assert s["spans"] == {} and s["counts"] == {}
        assert s["span_events"] == [] and s["ingest_sections"] == {}
    assert "    spans: " not in untraced["stdout"]


def test_without_the_variable_a_span_is_one_shared_object(untraced):
    """``span()`` hands out ``OFF`` itself: 100,000 spans and counts
    allocate nothing and read no clock, and ``traced`` leaves a function
    as it is."""
    assert untraced["shared"] and untraced["traced_is_fn"]
    assert untraced["blocks"] < 50
    assert untraced["clock_untouched"]


_GPU_RUN = r"""
import json, os, re, sys, tempfile, time
import torch
from benchmark.harness.trace import DeviceTrace, busy_intervals
from pde_engine_tpu_torch.parallel import cuda_engine
from pde_engine_tpu_torch.runtime import DiscoveryRun
from pde_engine_tpu_torch.utils import spans
from pde_engine_tpu_torch.utils.config import SearchConfig
assert spans.ON
out, depth, heavy = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
warm = sys.argv[4] == "1"
KERNEL = re.compile(r"\b(segmented|structured|tiled|universal)_kernel\b")


def one(d, depth):
    os.makedirs(d)
    run = DiscoveryRun("laplace", SearchConfig(
        max_depth=depth, defer_heavy_checks=not heavy), device="cuda",
        db_path=d + "/run.db", report_families=False, verbose=False)
    try:
        run.run(depth)
    finally:
        run.close()
    return run


with tempfile.TemporaryDirectory() as d:
    one(d + "/warm", depth - 1)           # builds or loads the kernels
    launches = []
    for k in ("segmented", "structured", "tiled", "universal"):
        def wrapped(*a, _f=getattr(cuda_engine, k), **kw):
            launches.append(time.perf_counter())
            return _f(*a, **kw)
        setattr(cuda_engine, k, wrapped)
    if warm:
        # the activity tracer's first start in the process delays the
        # next launch, DeviceTrace's marker
        from torch.profiler import ProfilerActivity, profile
        x = torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]):
            x.add_(1.0)
            torch.cuda.synchronize()
    trace = DeviceTrace()
    with trace:
        t0 = time.perf_counter()
        run = one(d + "/run", depth)
        t1 = time.perf_counter()
events = [e for e in trace.events() if e[2] > t0 and e[1] < t1]
kernels = sorted((e for e in events
                  if e[3] == "kernel" and KERNEL.search(e[0])),
                 key=lambda e: e[1])
main = [e for s in run.engine.stats for e in s.span_events
        if e[4] == "MainThread"]
device = sorted((a, b) for n, a, b, _, _ in main if n == "device")
leads = []
for t, k in zip(launches, kernels):
    enclosing = [(a, b) for a, b in device if a <= t <= b]
    leads.append(None if not enclosing else enclosing[-1][0] - k[1])
# the card's idle time in the window, and the part of it inside a span
# named below run and depth on the main thread
busy = busy_intervals(events)
idle, last = [], t0
for a, b in busy + [(t1, t1)]:
    if a > last:
        idle.append((last, min(a, t1)))
    last = max(last, b)
named = busy_intervals([(n, a, b, "") for n, a, b, _, _ in main
                        if n not in ("run", "depth")])
inside, j = 0.0, 0
for a, b in idle:               # both lists are ordered and disjoint
    while j < len(named) and named[j][1] <= a:
        j += 1
    k = j
    while k < len(named) and named[k][0] < b:
        inside += min(b, named[k][1]) - max(a, named[k][0])
        k += 1
json.dump({"launches": len(launches), "kernels": len(kernels),
           "leads_s": leads, "idle_s": sum(b - a for a, b in idle),
           "idle_in_named_s": inside, "window_s": t1 - t0,
           "card": torch.cuda.get_device_name(0)}, open(out, "w"))
"""


@pytest.mark.gpu
def test_device_spans_enclose_the_screen_kernels_on_the_card(tmp_path):
    """Each screen kernel's launch lies inside a ``device`` span, and the
    kernel starts no earlier than 0.5 ms before that span on the trace's
    host clock (``benchmark/harness/trace.DeviceTrace``'s marker); prints
    the share of the card's idle time that a span below ``run`` and
    ``depth`` names.  The activity tracer is started once before the
    trace: its first start in a process delays the next launch, the
    marker, by milliseconds, and the marker's launch time then places
    every device event that much early."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the screen kernels have no CPU "
                    "mode)")
    env = dict(os.environ, PDE_INGEST_TIMERS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = str(tmp_path / "gpu.json")
    r = subprocess.run(
        [sys.executable, "-c", _GPU_RUN, out, "3", "0", "1"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out) as f:
        res = json.load(f)
    assert res["launches"] == res["kernels"] > 0, res
    assert all(lead is not None and lead <= 0.5e-3
               for lead in res["leads_s"]), res["leads_s"]
    share = res["idle_in_named_s"] / res["idle_s"]
    print(f"\n{res['card']}: laplace depth 3, {res['kernels']} screen "
          f"kernels; idle {res['idle_s']:.4f} s of {res['window_s']:.4f} "
          f"s, {100 * share:.2f}% of it inside a named span")
    assert 0.0 < share <= 1.0 + 1e-9
