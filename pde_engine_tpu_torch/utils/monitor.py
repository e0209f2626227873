"""Run monitoring (parity with the reference's monitor thread,
general_method_paper_reproduction.py:913-971: a 5-second status line built
from run_metadata + worker_progress, stopping when the run completes).

The pipeline writes heartbeats per device batch; the monitor reads them
back from the (WAL) database so it also works from a *separate* process —
``python -m pde_engine_tpu_torch --watch-run <id>`` attaches to a live run.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from typing import Optional


def format_status(db_path: str, run_id: str) -> Optional[str]:
    try:
        conn = sqlite3.connect(db_path)
        conn.execute("PRAGMA busy_timeout=2000")
        row = conn.execute(
            "SELECT status, total_generated, total_validated, "
            "valid_solutions, started_at FROM run_metadata WHERE run_id=?",
            (run_id,)).fetchone()
        if row is None:
            return None
        status, gen, val, sols, started = row
        hb = conn.execute(
            "SELECT role, validated, current_expr_snippet, "
            "last_completed_at FROM worker_progress WHERE run_id=? "
            "ORDER BY last_completed_at DESC LIMIT 1", (run_id,)).fetchone()
        conn.close()
        extra = ""
        if hb:
            extra = f" | {hb[0]}: {hb[1]} processed"
            if hb[2]:
                extra += f" | last: {hb[2][:48]}"
        return (f"[monitor] {status}: generated={gen or 0} "
                f"validated={val or 0} valid={sols or 0}{extra}")
    except Exception:
        return None


class Monitor:
    """Background thread printing a status line every ``interval`` seconds
    until stopped or the run reaches a terminal status."""

    def __init__(self, db_path: str, run_id: str, interval: float = 5.0,
                 printer=print):
        self.db_path = db_path
        self.run_id = run_id
        self.interval = interval
        self.printer = printer
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            line = format_status(self.db_path, self.run_id)
            if line:
                self.printer(line)
                if any(s in line for s in ("completed", "aborted")):
                    return

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def watch(db_path: str, run_id: str, interval: float = 5.0,
          max_seconds: Optional[float] = None):
    """Foreground watch loop (the --watch-run CLI verb)."""
    t0 = time.time()
    while True:
        line = format_status(db_path, run_id)
        if line:
            print(line, flush=True)
            if "completed" in line or "aborted" in line:
                return
        if max_seconds is not None and time.time() - t0 > max_seconds:
            return
        time.sleep(interval)
