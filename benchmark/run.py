#!/usr/bin/env python3
"""One cell of the benchmark of pde_engine_tpu_torch, run once.

    python3 benchmark/run.py --workload laplace.d5.heavy --seed 7 \\
        --seconds 51 --trace 0

From the root of a checkout, on a machine with a CUDA card.  The cell's
configuration and traffic mix come from ``BENCHMARK.json`` and the files
under ``benchmark/`` that it names (``benchmark/harness/spec.py``).

1. Set-up (``setup_s``): import torch and the port, create the CUDA
   context, load the problem, and make one whole run to depth D-1 through
   the window's entry, without the report's family pass, which builds or
   loads the screen kernels and the native ingest core in the checkout's
   build directory; its files are deleted.
2. The window: whole fresh discovery runs to depth D, back to back, each
   a new ``runtime.DiscoveryRun(problem, config=SearchConfig(...),
   db_path=<tmp>/<i>/run.db, device="cuda")``, ``.run(D)``, ``.close()``,
   as ``cli.main`` makes a fresh run.  A run that has started when
   ``--seconds`` have passed finishes and counts.  Each run's directory
   is deleted after it, inside the window, but the first run's, which the
   check reads.  ``search_s`` is the window over the runs it holds;
   ``host_peak_gib`` the process's peak resident memory when it ends.
   With ``--trace 1`` the window runs under the CUDA activity trace with
   the port's ingest timers on and gives the per-layer metrics instead.
3. The check (``harness/check.py``): every run's counts and the first
   run's stored rows and state against the configuration's data and the
   plain reference; each number with its limit goes to standard error and
   under ``checks``, the last key of the result.
4. The result: one JSON line, the last of standard output.

Exits 2 with no result when there is no CUDA card or fewer than the cell
asks for, and 3 when jax, jaxlib, flax or the JAX package is loaded once
the window has closed.  Everything a run writes goes under ``$TMPDIR``.
"""

from __future__ import annotations

import os
import sys
import time

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    # one hash seed in every process, so that every seed and every run
    # iterates its sets and dicts of strings in one order: the same work
    os.environ["PYTHONHASHSEED"] = "0"
    os.execv(sys.executable, [sys.executable] + sys.argv)

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import List, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import check, spec  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "pde_engine_tpu")


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FOREIGN``, compared
    whole: ``pde_engine_tpu_torch`` is not ``pde_engine_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def tree_bytes(path: str) -> int:
    """Bytes of the files under ``path``: what a run leaves on disk."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def one_run(problem, keys: dict, directory: str, device: str,
            families: bool = True) -> dict:
    """One whole fresh discovery run, the way ``cli.main`` makes one."""
    from pde_engine_tpu_torch.runtime import DiscoveryRun
    from pde_engine_tpu_torch.utils.config import SearchConfig
    os.makedirs(directory)
    t0 = time.perf_counter()
    run = DiscoveryRun(problem, config=SearchConfig(**keys),
                       db_path=os.path.join(directory, "run.db"),
                       device=device, report_families=families)
    try:
        run.run(keys["max_depth"])
    finally:
        run.close()
    return {"wall_s": time.perf_counter() - t0,
            "stats": [dataclasses.asdict(s) for s in run.engine.stats]}


def window(problem, keys: dict, seconds: float, workdir: str,
           device: str, families: bool
           ) -> Tuple[List[dict], float, int, List[str]]:
    """Whole runs back to back for ``seconds``: (runs, window seconds,
    runs attempted, errors)."""
    runs: List[dict] = []
    errors: List[str] = []
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        d = os.path.join(workdir, str(i))
        i += 1
        # every run starts from a cold SymPy cache, as a user's process
        # does, so that a window's runs do the same work
        if "sympy" in sys.modules:
            sys.modules["sympy"].core.cache.clear_cache()
        try:
            runs.append(one_run(problem, keys, d, device, families))
        except Exception:          # a failed run fails the cell
            errors.append(traceback.format_exc())
            break
        if len(runs) > 1:
            shutil.rmtree(d)
    return runs, time.perf_counter() - t0, i, errors


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> Tuple[dict, List[str]]:
    """Set-up, window, check: the result line's object and the notes on
    what the check found wrong."""
    import torch
    from pde_engine_tpu_torch.models import load_problem
    if device == "cuda":
        torch.zeros(1, device="cuda")
    problem = load_problem(cell.problem)
    keys = cell.search_keys()
    workdir = tempfile.mkdtemp(prefix=f"bench-{cell.name}-")
    try:
        # the warm-up loads the kernels and the native core; its report
        # skips the family pass and SymPy's classing, which serve nothing
        with contextlib.redirect_stdout(sys.stderr):
            one_run(problem, dict(keys, max_depth=cell.warmup_depth),
                    os.path.join(workdir, "warmup"), device, families=False)
        shutil.rmtree(os.path.join(workdir, "warmup"))
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        tracer = None
        if trace:
            from benchmark.harness.trace import DeviceTrace
            tracer = DeviceTrace()
        with contextlib.redirect_stdout(sys.stderr), \
                (tracer or contextlib.nullcontext()):
            tw0 = time.perf_counter()
            runs, window_s, attempted, errors = window(
                problem, keys, seconds, os.path.join(workdir, "w"), device,
                cell.report_families)
            tw1 = time.perf_counter()
        # this process alone: its children are the first run's nvcc and
        # g++ builds, part of set-up
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
        if device == "cuda":
            dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes":
                   int(torch.cuda.max_memory_allocated())}
        found = foreign_modules()
        if found:
            raise ForeignModules(found)
        for i, r in enumerate(runs):
            print(f"run {i}: {r['wall_s']:.3f} s; " + "; ".join(
                f"d{s['depth']} {s['candidates']}/{s['unique']}/"
                f"{s['valid']} {s['seconds']:.3f} s" for s in r["stats"]),
                file=sys.stderr)
        print(f"window {window_s:.3f} s, {len(runs)} runs; first run's "
              f"files {tree_bytes(os.path.join(workdir, 'w', '0'))} B; "
              f"set-up {setup_s:.3f} s", file=sys.stderr)
        for e in errors:
            print(e, file=sys.stderr)
        record = {"runs": runs, "config": cell.config,
                  "traffic": cell.traffic, "trace": None}
        result = {"correct": False, "attempted": attempted,
                  "failed": len(errors), "metrics": {}, "device": dev}
        if tracer is not None:
            from benchmark.harness.trace import summarize
            record["trace"] = summarize(tracer, tw0, tw1)
            tr = record["trace"]
            if tr["n_kernels"] == 0:
                raise RuntimeError("the activity trace holds no kernel "
                                   "event: device metrics not measured")
            dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
            for m in cell.per_layer:
                v = spec.metric_reader(m["name"])(record)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
        elif runs:
            values = {"search_s": window_s / len(runs),
                      "host_peak_gib": peak / 2**20, "setup_s": setup_s}
            for m in cell.end_to_end:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        # the program's state goes before the reference runs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        checks, notes = {}, []
        if runs and not errors:
            db = os.path.join(workdir, "w", "0", "run.db")
            audit = bool(keys.get("audit_rejects", True))
            tc = time.perf_counter()
            checks, notes = check.judge(runs, db, cell.config, audit, seed)
            print(f"check {time.perf_counter() - tc:.3f} s", file=sys.stderr)
        result["correct"] = bool(checks) and not errors and \
            check.passed(checks)
        result["checks"] = checks
        return result, notes
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


class ForeignModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if args.trace:
        # read by the port's pipeline when it is imported
        os.environ["PDE_INGEST_TIMERS"] = "1"
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result, notes = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace))
    except ForeignModules as e:
        print(f"error: loaded once the window closed: {', '.join(e.args[0])}",
              file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for n in notes:
        print(f"check: {n}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
