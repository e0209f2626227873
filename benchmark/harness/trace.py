"""The traced run's device record and what the host did while the card
idled.

The CUDA activity trace (``torch.profiler`` with CUDA activity alone, so
that no host operator is recorded) gives every kernel, copy and memset
on the card.  A thread samples the main thread's stack every
``SAMPLE_S`` seconds and keeps the innermost frame of the program, so
that each idle gap on the card is named by what the host was doing.
Host and device clocks are tied by one marker kernel launched on an
idle card at a known host time.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

SAMPLE_S = 0.02
PROGRAM = "pde_engine_tpu_torch"


class StackSampler:
    """Samples the innermost program frame of one thread."""

    def __init__(self, thread_id: int, period: float = SAMPLE_S):
        self.thread_id, self.period = thread_id, period
        self.samples: List[Tuple[float, str]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="bench-stack-sampler")

    def _label(self, frame) -> str:
        inner = None
        while frame is not None:
            mod = frame.f_globals.get("__name__", "")
            if mod.startswith(PROGRAM) and inner is None:
                inner = (f"{mod[len(PROGRAM) + 1:] or mod}."
                         f"{frame.f_code.co_name}")
            frame = frame.f_back
        return inner or "outside the program"

    def _loop(self):
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self.thread_id)
            if frame is not None:
                self.samples.append((time.perf_counter(), self._label(frame)))

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


class DeviceTrace:
    """The window's CUDA activity trace and the host's stack samples."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.sampler = StackSampler(threading.get_ident())
        self.t_marker: Optional[float] = None

    def __enter__(self):
        import torch
        marker = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t_marker = time.perf_counter()
        marker.add_(1.0)          # the first device event of the trace
        torch.cuda.synchronize()
        self.sampler.start()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.sampler.stop()
        self.prof.__exit__(*exc)

    def events(self) -> List[Tuple[str, float, float, str]]:
        """(name, start, end, kind) of every device event, on the host's
        clock in seconds; kind is kernel, copy or memset."""
        from torch.autograd import DeviceType
        raw = []
        for e in self.prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            kind = ("copy" if "Memcpy" in e.name else
                    "memset" if "Memset" in e.name else "kernel")
            raw.append((e.name, e.time_range.start / 1e6,
                        e.time_range.end / 1e6, kind))
        if not raw:
            return []
        raw.sort(key=lambda r: r[1])
        shift = self.t_marker - raw[0][1]
        return [(n, a + shift, b + shift, k) for n, a, b, k in raw]


def busy_intervals(events) -> List[Tuple[float, float]]:
    """The union of the events' intervals, in order."""
    out: List[List[float]] = []
    for _, a, b, _ in sorted(events, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(trace: DeviceTrace, t0: float, t1: float) -> Dict:
    """What the per-layer readers and the result line take from a traced
    window [t0, t1] (host clock)."""
    ev = [e for e in trace.events() if e[2] > t0 and e[1] < t1]
    kernels = [e for e in ev if e[3] == "kernel"]
    busy = busy_intervals(ev)
    busy_s = sum(b - a for a, b in busy)
    by_name = Counter()
    for n, a, b, _ in ev:
        by_name[n.split("(")[0]] += b - a
    # idle time by what the host was doing: each stack sample taken while
    # the card idled stands for the time to the next sample
    idle_by = Counter()
    samples = trace.sampler.samples
    j = 0
    gaps = [(a, b) for (_, a), (b, _) in zip([(0, t0)] + busy,
                                             busy + [(t1, 0)]) if b > a]
    for (ts, label), nxt in zip(samples, samples[1:] + [(t1, None)]):
        while j < len(gaps) and gaps[j][1] <= ts:
            j += 1
        if j < len(gaps) and gaps[j][0] <= ts:
            idle_by[label] += min(nxt[0], gaps[j][1]) - ts
    return {
        "window_s": t1 - t0,
        "busy_s": busy_s,
        "kernel_s": sum(b - a for _, a, b, _ in kernels),
        "n_kernels": len(kernels),
        "n_events": len(ev),
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in idle_by.most_common(10)],
    }
