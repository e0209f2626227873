"""Benchmark of the port: candidate residual validations per second on one
GPU.

    python -m pde_engine_tpu_torch.bench [seed_depth] [--device cuda|cpu]
    python -m pde_engine_tpu_torch.bench [seed_depth] --devices K

Counterpart of ``main`` in the JAX package's ``bench.py``.  The port's
own engine runs force_free through ``seed_depth`` (default 4) with
``audit_rejects=False, snapshot_jets=False``; the depth-``seed_depth + 1``
candidate stream is then laid out in launches exactly as the engine lays
it out (:func:`pipeline.route_segmented`: structured for whole-superbatch
runs, tiled for per-tile runs, segmented for the rest) and timed through
the screen kernels, the host ingest left out.  The engine reads the
cache's capacity as it routes, and the cache grows as the depth appends
rows; the bench routes on the capacity the cache had when the depth
began.  A run's parents lie below the cache's rows, so the capacity
decides a run only when it ends within 511 rows of it:
``detail.capacity_slack_rows`` (capacity less rows) of at least 511
means no decision of the bench can differ from the engine's.

Timing: every launch's index arrays are on the device before the clock
starts; the entry points' launch counts are then set to 0 (the seed's
launches are reported apart); one launch of each kind warms up (on the
GPU its outputs are also held bit for bit against the plain torch twin,
and a difference fails the bench); then each repetition launches the
whole stream back to back on one stream, copies each launch's 12-byte
verdicts into one pinned host buffer (``non_blocking``) and
synchronises once.  A launch's screen and
fingerprint jets are dropped as soon as it is enqueued.  ``value`` is the
median of ``REPS`` repetitions; one more, untimed, repetition runs under
the CUDA activity trace for the kernels' and the verdict copies' device
time.

Environment: ``PDE_BENCH_BATCH`` (candidates per superbatch, default
262,144, a multiple of 512) and ``PDE_BENCH_MAX_SUPERS`` (a cap on the
launches timed; default none, the whole stream).  ``--device cuda`` (the
default) without a usable GPU raises.

The seed (the cache rows through ``seed_depth``, the cache's capacity
and the stream) is kept in ``~/.cache/pde_engine_tpu_torch_bench/``,
keyed by a digest of the port's sources by their paths relative to the
repository root, the problem, the seed depth, the batch and the device
type.

Stdout carries exactly one JSON line, ``{"metric", "value", "unit",
"vs_baseline", "detail"}``; progress goes to stderr.  On SIGTERM before
that line, the best measurement so far is printed instead, flagged
``partial``; after it, nothing more is printed.

``--devices K`` (:func:`bench_mesh`, the JAX ``bench_mesh``) times the
mesh instead: the port's per-op engine runs force_free through
``seed_depth`` (default 3), its cache is copied onto every device of a
K-device mesh (the first K cards, or K CPU shards with ``--device
cpu``), and the depth-``seed_depth + 1`` stream, one batch of at most
``PDE_BENCH_BATCH`` candidates per op as the engine's per-op path makes
them, goes through the replicated mesh call
(``incremental.make_op_kernel_sharded``: one ``universal`` launch per
non-empty shard), each batch's verdicts copied to one pinned host
buffer; ``mesh_sharded_validations_per_sec`` is the median of ``REPS``
repetitions, with the launches of each kind in a repetition.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .models import load_problem
from .pipeline import (TILE, DiscoveryEngine, Launch, launch_screen,
                       launched_rows_of, resolve_device, route_segmented,
                       tally_launch)
from .parallel import cuda_engine
from .utils.config import SearchConfig

METRIC = "candidate_residual_validations_per_sec_per_chip"
BASELINE = 50.0   # the reference's validations/s per process (BASELINE.md)
PROBLEM = "force_free"
REPS = 5
SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp")
_T0 = time.perf_counter()


def _progress(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


class Output:
    """The bench's one line on stdout: the result, or, on SIGTERM before
    it, the best measurement so far flagged partial."""

    def __init__(self):
        self.partial: Optional[dict] = None
        self.printed = False

    def emit(self, result: dict) -> None:
        if self.printed:
            return
        print(json.dumps(result), flush=True)
        self.printed = True

    def on_sigterm(self, signum=None, frame=None) -> None:
        if self.partial is not None:
            out = dict(self.partial)
            out["detail"] = dict(out["detail"], partial=True,
                                 killed_at_s=time.perf_counter() - _T0)
            self.emit(out)
        _progress("SIGTERM")
        sys.exit(143)


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def source_digest(root: str) -> str:
    """Digest of the port's sources under ``root``, each by its path
    relative to ``root`` and its bytes: equal for two checkouts of the
    same tree wherever they lie."""
    h = hashlib.sha256()
    pkg = os.path.join(root, "pde_engine_tpu_torch")
    for path in sorted(glob.glob(os.path.join(pkg, "**", "*"),
                                 recursive=True)):
        if not path.endswith(SOURCE_SUFFIXES):
            continue
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        h.update(rel.encode() + b"\0")
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def seed_cache_path(seed_depth: int, batch: int, device: torch.device,
                    problem: str = PROBLEM) -> str:
    key = hashlib.sha256(
        f"{source_digest(repo_root())}|{problem}|{seed_depth}|{batch}|"
        f"{device.type}".encode()).hexdigest()[:16]
    d = os.path.join(os.path.expanduser("~"), ".cache",
                     "pde_engine_tpu_torch_bench")
    return os.path.join(d, f"seed_{key}.npz")


def smi_line() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _engine(seed_depth: int, batch: int, device, problem: str
            ) -> DiscoveryEngine:
    return DiscoveryEngine(load_problem(problem), SearchConfig(
        max_depth=seed_depth, batch_size=batch, audit_rejects=False,
        snapshot_jets=False), device=device)


def seed(seed_depth: int, batch: int, device: torch.device,
         problem: str = PROBLEM):
    """(engine whose cache holds the rows through ``seed_depth``, the
    depth-``seed_depth + 1`` stream as ``(op_name, a_u, b_u)`` batches,
    uniques through ``seed_depth``, whether the seed cache hit, the
    cache's capacity when the engine's depth ``seed_depth`` ended)."""
    path = seed_cache_path(seed_depth, batch, device, problem)
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            eng = _engine(seed_depth, batch, device, problem)
            eng.cache.load_rows(z["screen"], z["fp"])
            capacity = int(z["capacity"])
            if eng.cache.capacity < capacity:
                eng.cache._grow(capacity)
            names = [str(s) for s in z["op_names"].tolist()]
            stream, pos = [], 0
            a_cat, b_cat = z["a"], z["b"]
            for oi, ln in zip(z["ops"].tolist(), z["lens"].tolist()):
                b_u = b_cat[pos:pos + ln]
                stream.append((names[oi], a_cat[pos:pos + ln],
                               None if ln and b_u[0] < 0 else b_u))
                pos += ln
            n_uniques = int(z["n_uniques"])
        _progress(f"seed cache hit: {n_uniques} uniques, {len(stream)} "
                  f"stream batches ({path})")
        return eng, stream, n_uniques, True, capacity
    _progress(f"seeding depths 1..{seed_depth} through the port's engine "
              f"on {device}")
    eng = _engine(seed_depth, batch, device, problem)
    with contextlib.redirect_stdout(sys.stderr):
        eng.run(seed_depth)
    n_uniques = eng.enumerator.count_uniques()
    capacity = eng.cache.capacity
    stream = list(eng.enumerator.vector_batches_at_depth(
        seed_depth + 1, batch, max_parent_uid=eng.cache.n))
    _progress(f"seed done: {n_uniques} uniques, cache rows {eng.cache.n} "
              f"of {capacity}, {len(stream)} stream batches")
    names = sorted({s[0] for s in stream})
    ix = {n: i for i, n in enumerate(names)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp.npz"
    np.savez(tmp, n_uniques=np.int64(n_uniques),
             capacity=np.int64(capacity),
             screen=eng.cache.screen[:eng.cache.n].cpu().numpy(),
             fp=eng.cache.fp[:eng.cache.n].cpu().numpy(),
             ops=np.asarray([ix[s[0]] for s in stream], np.int16),
             lens=np.asarray([s[1].size for s in stream], np.int64),
             a=np.concatenate([s[1] for s in stream]).astype(np.int32),
             b=np.concatenate([np.full(s[1].size, -1, np.int32)
                               if s[2] is None else s[2].astype(np.int32)
                               for s in stream]),
             op_names=np.asarray(names))
    os.replace(tmp, path)
    _progress(f"seed cache saved: {path}")
    return eng, stream, n_uniques, False, capacity


def assemble(stream, batch: int, tiled_min_rows: int, capacity: int,
             max_supers: Optional[int] = None):
    """(the stream's launches as the engine lays them out on a cache of
    ``capacity`` rows, whether ``max_supers`` cut them)."""
    launches: List[Launch] = []
    for ln in route_segmented(iter(stream), batch, tiled_min_rows,
                              lambda: capacity):
        if max_supers is not None and len(launches) >= max_supers:
            return launches, True
        launches.append(ln)
    return launches, False


def launched_rows(launches: List[Launch]) -> Dict[str, Dict[str, int]]:
    """Per kernel, as ``DiscoveryEngine.launched_rows``: rows launched,
    candidates among them, rows of the 512-row tiles holding one."""
    table = {k: [0, 0, 0] for k in ("segmented", "structured", "tiled")}
    for ln in launches:
        tally_launch(table[ln.kernel], ln.rows,
                     [s[2].size for s in ln.segs])
    return launched_rows_of(table)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rows_differ(a, b) -> int:
    """Rows of two ``(packed, jets, fj)`` outputs that differ in any bit."""
    bad = torch.zeros(a[0].shape[0], dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        bad |= (x.view(torch.int32) != y.view(torch.int32)).any(1)
    return int(bad.sum())


def main(argv=None, out: Optional[Output] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seed_depth", nargs="?", type=int, default=None,
                    help="depths seeded before the timed one (default 4; "
                         "3 with --devices)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="time the replicated mesh call over K devices")
    args = ap.parse_args(argv)
    out = out or Output()
    device = resolve_device(args.device)
    batch = int(os.environ.get("PDE_BENCH_BATCH", "262144"))
    if batch <= 0 or batch % TILE:
        raise ValueError(f"PDE_BENCH_BATCH={batch}: want a positive "
                         f"multiple of {TILE}")
    if args.devices is not None:
        return bench_mesh(args.devices, 3 if args.seed_depth is None
                          else args.seed_depth, device, batch, out)
    if args.seed_depth is None:
        args.seed_depth = 4
    cap = os.environ.get("PDE_BENCH_MAX_SUPERS")
    max_supers = int(cap) if cap else None

    cuda_engine.reset_launch_counts()
    t_seed = time.perf_counter()
    eng, stream, n_uniques, hit, capacity = seed(args.seed_depth, batch,
                                                 device)
    t_seed = time.perf_counter() - t_seed
    seed_launches = dict(cuda_engine.LAUNCHES)
    cache, spec = eng.cache, eng._spec

    t_asm = time.perf_counter()
    launches, truncated = assemble(stream, batch, eng.config.tiled_min_rows,
                                   capacity, max_supers)
    del stream
    index = [tuple(torch.from_numpy(x).to(device) for x in ln.index)
             for ln in launches]
    candidates = sum(ln.candidates for ln in launches)
    rows = [ln.rows for ln in launches]
    offsets = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    verdicts = torch.empty((int(offsets[-1]), 3), dtype=torch.int32,
                           pin_memory=device.type == "cuda")
    _sync(device)
    t_asm = time.perf_counter() - t_asm
    kinds = {k: sum(ln.kernel == k for ln in launches)
             for k in ("segmented", "structured", "tiled")}
    _progress(f"assembled {len(launches)} launches {kinds}, {candidates} "
              f"candidates, {int(offsets[-1])} rows, capacity slack "
              f"{capacity - cache.n} rows"
              + (" (stream truncated)" if truncated else ""))

    # from here on the counts are the bench's own: one warm-up launch of
    # each kind routed, then every launch of each repetition
    cuda_engine.reset_launch_counts()
    differ = {} if device.type == "cuda" else None
    for k in kinds:
        i = next((i for i, ln in enumerate(launches) if ln.kernel == k),
                 None)
        if i is None:
            continue
        got = launch_screen(spec, cache, launches[i], index[i],
                            eng._spoints, eng._fpoints)
        _sync(device)
        if differ is not None:
            ref = launch_screen(spec, cache, launches[i], index[i],
                                eng._spoints, eng._fpoints, plain=True)
            differ[k] = rows_differ(got, ref)
            if differ[k]:
                raise RuntimeError(
                    f"{k}: {differ[k]} of {launches[i].rows} rows of the "
                    "first launch differ from the plain torch twin")
        del got
        _progress(f"warm-up: {k} launch of {launches[i].rows} rows"
                  + ("" if differ is None else
                     ", bit-equal to its plain torch twin"))

    def one_rep():
        for ln, idx, lo in zip(launches, index, offsets.tolist()):
            packed = launch_screen(spec, cache, ln, idx, eng._spoints,
                                   eng._fpoints)[0]
            verdicts[lo:lo + ln.rows].copy_(packed, non_blocking=True)
        _sync(device)

    card = smi_line() if device.type == "cuda" else None

    def result(secs: List[float], trace=None) -> dict:
        med = statistics.median(secs)
        value = candidates / med
        return {
            "metric": METRIC, "value": value, "unit": "validations/s",
            "vs_baseline": value / BASELINE,
            "detail": {
                "problem": PROBLEM,
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                "card": card,
                "candidates_timed": candidates,
                "depth_timed": args.seed_depth + 1,
                "cache_uniques": n_uniques, "cache_rows": cache.n,
                "batch": batch,
                "launches": kinds,
                "launched_rows": launched_rows(launches),
                "capacity_slack_rows": capacity - cache.n,
                # the entry points' launch counts: warm-up, repetitions
                # and trace; the seed's apart
                "kernel_launches": dict(cuda_engine.LAUNCHES),
                "seed_kernel_launches": seed_launches,
                "verdict_bytes": int(offsets[-1]) * 12,
                "seconds": {"median": med, "min": min(secs),
                            "max": max(secs)},
                "rep_seconds": secs, "reps": len(secs),
                **(trace or {"kernel_device_ms": None,
                             "copy_device_ms": None}),
                "first_launch_rows_differ": differ,
                "stream_truncated": truncated,
                "seed_cache_hit": hit,
                "seed_seconds": t_seed, "assemble_seconds": t_asm,
            }}

    secs: List[float] = []
    for rep in range(REPS):
        _sync(device)
        t0 = time.perf_counter()
        one_rep()
        secs.append(time.perf_counter() - t0)
        out.partial = result(secs)
        _progress(f"rep {rep + 1}/{REPS}: {secs[-1]:.4f} s "
                  f"({candidates / secs[-1]:,.0f} candidates/s)")
    out.emit(result(secs, device_times(one_rep, len(launches))
                    if device.type == "cuda" else None))
    return 0


MESH_METRIC = "mesh_sharded_validations_per_sec"


def bench_mesh(n_devices: int, seed_depth: int, device: torch.device,
               batch: int, out: Output) -> int:
    """The mesh bench (module docstring, ``--devices``)."""
    from .parallel.incremental import JetCache, make_op_kernel_sharded
    from .parallel.mesh import candidate_mesh
    mesh = candidate_mesh(n_devices, device)
    _progress(f"seeding depths 1..{seed_depth} through the port's per-op "
              f"engine on {mesh.home}")
    t_seed = time.perf_counter()
    eng = DiscoveryEngine(load_problem(PROBLEM), SearchConfig(
        max_depth=seed_depth, batch_size=batch, audit_rejects=False,
        snapshot_jets=False, use_segmented=False), device=mesh.home)
    with contextlib.redirect_stdout(sys.stderr):
        eng.run(seed_depth)
    p = eng.problem
    cache = JetCache(len(p.screen_points), eng.cache.sdim
                     // len(p.screen_points), len(p.fingerprint_points),
                     mesh.home, initial_capacity=eng.cache.capacity,
                     mesh=mesh)
    snap = eng.cache.snapshot()
    cache.load_rows(snap["screen"], snap["fp"])
    t_seed = time.perf_counter() - t_seed
    kw = dict(order=p.residual_order, residual_key=p.get_residual_key(),
              screen_rtol=float(eng.screen_rtol),
              n_screen=len(p.screen_points),
              n_fp=len(p.fingerprint_points))
    stream = []
    for op_name, a_u, b_u in eng.enumerator.vector_batches_at_depth(
            seed_depth + 1, batch, max_parent_uid=eng.cache.n):
        if a_u.size == 0:
            continue
        ab = np.zeros((a_u.size, 2), np.int32)
        ab[:, 0] = a_u
        if b_u is not None:
            ab[:, 1] = b_u
        stream.append((op_name, torch.from_numpy(ab).to(mesh.home)))
    calls = {op: make_op_kernel_sharded(mesh, op, **kw)
             for op in {op for op, _ in stream}}
    candidates = sum(int(ab.shape[0]) for _, ab in stream)
    offsets = np.concatenate([[0], np.cumsum(
        [int(ab.shape[0]) for _, ab in stream])]).astype(np.int64)
    verdicts = torch.empty((candidates, 3), dtype=torch.int32,
                           pin_memory=device.type == "cuda")

    def sync():
        for d in set(mesh.devices):
            _sync(d)

    sync()
    _progress(f"{len(stream)} batches, {candidates} candidates over "
              f"{mesh}")
    # warm-up: the first batch, held bit for bit to the plain twin on the
    # card
    cuda_engine.reset_launch_counts()
    op0, ab0 = stream[0]
    got = calls[op0](cache, ab0, eng._spoints, eng._fpoints)
    differ = None
    if device.type == "cuda":
        ref = cuda_engine.universal_ref(
            eng._spec, cache.screen, cache.fp, ab0,
            cuda_engine.incremental.OP_INDEX[op0], eng._spoints,
            eng._fpoints)
        differ = rows_differ(got[:3], ref)
        if differ:
            raise RuntimeError(f"{op0}: {differ} of {int(ab0.shape[0])} "
                               "rows of the first batch differ from the "
                               "plain torch twin")
    del got
    cuda_engine.reset_launch_counts()

    def one_rep():
        for (op_name, ab), lo, hi in zip(stream, offsets[:-1].tolist(),
                                         offsets[1:].tolist()):
            packed = calls[op_name](cache, ab, eng._spoints,
                                    eng._fpoints)[0]
            verdicts[lo:hi].copy_(packed, non_blocking=True)
        sync()

    card = smi_line() if device.type == "cuda" else None

    def result(secs: List[float]) -> dict:
        med = statistics.median(secs)
        value = candidates / med
        return {
            "metric": MESH_METRIC, "value": value,
            "unit": "validations/s", "vs_baseline": value / BASELINE,
            "detail": {
                "problem": PROBLEM, "n_devices": mesh.size,
                "devices": [str(d) for d in mesh.devices],
                "device": (torch.cuda.get_device_name(mesh.home)
                           if device.type == "cuda" else "cpu"),
                "card": card, "candidates_timed": candidates,
                "depth_timed": seed_depth + 1, "batch": batch,
                "batches": len(stream),
                "cache_rows": cache.n,
                # the entry points' launches over the repetitions, and in
                # one: a launch per non-empty shard of each batch
                "kernel_launches": dict(cuda_engine.LAUNCHES),
                "launches_per_rep": {
                    k: v // len(secs) for k, v in
                    cuda_engine.LAUNCHES.items()},
                "first_batch_rows_differ": differ,
                "seconds": {"median": med, "min": min(secs),
                            "max": max(secs)},
                "rep_seconds": secs, "reps": len(secs),
                "seed_seconds": t_seed,
            }}

    secs: List[float] = []
    for rep in range(REPS):
        sync()
        t0 = time.perf_counter()
        one_rep()
        secs.append(time.perf_counter() - t0)
        out.partial = result(secs)
        _progress(f"rep {rep + 1}/{REPS}: {secs[-1]:.4f} s "
                  f"({candidates / secs[-1]:,.0f} candidates/s)")
    out.emit(result(secs))
    return 0


def device_times(rep, n_launches: int) -> dict:
    """Device ms of the screen kernels (in all and by kernel) and of the
    device-to-host verdict copies in one run of ``rep``, from the CUDA
    activity trace; None (not measured) unless the trace holds one
    kernel and one copy for each of the ``n_launches`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep()
    by_kernel = {k: [] for k in cuda_engine.KERNELS}
    copies = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        k = next((k for k in by_kernel if f"{k}_kernel" in e.name), None)
        if k is not None:
            by_kernel[k].append(ms)
        elif "Memcpy" in e.name and "DtoH" in e.name:
            copies.append(ms)
    n_kernels = sum(len(v) for v in by_kernel.values())
    events = {"kernels": n_kernels, "copies": len(copies)}
    if n_kernels != n_launches or len(copies) != n_launches:
        return {"kernel_device_ms": None, "copy_device_ms": None,
                "trace_events": events}
    return {"kernel_device_ms": sum(map(sum, by_kernel.values())),
            "kernel_device_ms_by_kernel": {k: sum(v) for k, v in
                                           by_kernel.items() if v},
            "copy_device_ms": sum(copies), "trace_events": events}


if __name__ == "__main__":
    _out = Output()
    signal.signal(signal.SIGTERM, _out.on_sigterm)
    sys.exit(main(out=_out))
