"""A persisted discovery run on one torch device: fresh runs, resume and
the post-hoc audits.

Counterpart of ``DiscoveryRun`` in ``pde_engine_tpu/runtime.py``.  The run
DB has the JAX package's schema, reject rows go through the native sqlite
sink when the C++ core loads, known solutions are validated first, and
each depth barrier logs one line and writes the generator state, the jet
snapshot (``<db>.jets.d/shard_<lo>_<hi>.npz``) and the registry sidecar
(``<db>.registry.npz`` plus ``<db>.registry.d/part_<lo>_<hi>.npz``), in
the JAX package's file formats.  :meth:`DiscoveryRun.resume` rebuilds a
run from its registry sidecar, or, without one, from the rows of the run
DB, and continues at the next depth with the op set and pruning the run
recorded.  The audits (``--print-run-id`` and
its verbs) read a run back from its DB alone.

On a mesh (``mesh=``, ``parallel/mesh.py``) the run is the same; across
processes (``--multihost``, ``parallel/distributed.py``) only rank 0
writes the run DB, the reports, the jet snapshot and the registry
sidecar, the others reading the writer's files through
``ReadOnlyRunDB``; with ``shard_registry`` every rank also writes its
slice of the dedup keys (``<db>.registry.keys.<rank>.npz``), which a
resume merges, in as many processes or in one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import sqlite3
import time
from typing import Dict, List, Optional

import numpy as np

from .enumerator import Candidate, wrap_operand
from .ops import optable as ot
from .models.base import Problem, load_problem
from .pipeline import DepthStats, DiscoveryEngine, Row
from .utils import spans
from .utils.config import SearchConfig
from .utils.db import ReadOnlyRunDB, RunDB, db_path_for, new_run_id
from .utils.report import build_report, format_report_text, write_report_files


class DiscoveryRun:
    """A persisted discovery run (a fresh one, or one attached to an
    existing run DB by :meth:`resume`)."""

    def __init__(self, problem_name, config: Optional[SearchConfig] = None,
                 run_id: Optional[str] = None,
                 db_path: Optional[str] = None, device="cuda",
                 verbose: bool = True, report_families: bool = True,
                 mesh=None):
        # spans that ended outside a run belong to none
        spans.drain(None)
        self._run_span = spans.start("run")
        with spans.span("run.open"):
            from .parallel.distributed import agree, is_writer
            self.problem = (problem_name if isinstance(problem_name, Problem)
                            else load_problem(problem_name))
            self.config = config or SearchConfig()
            # every process of a multi-process run takes rank 0's id
            self.run_id = run_id or (new_run_id() if mesh is None
                                     else agree(new_run_id()))
            if db_path:
                self.db_path = db_path
                self.out_dir = os.path.dirname(os.path.abspath(db_path))
            else:
                self.out_dir = self.problem.get_output_dir()
                self.db_path = db_path_for(self.out_dir, self.run_id)
            self.verbose = verbose
            self.report_families = report_families
            if self.config.spill_strings == "auto":
                # resolved here, where the run DB's directory is known
                self.config.spill_strings = self.out_dir
            self.mesh = mesh
            self.engine = DiscoveryEngine(self.problem, self.config,
                                          device=device, mesh=mesh)
            # single-writer discipline: across processes only rank 0
            # owns the run DB, the reports and the sidecars; the others
            # read through
            self.is_writer = not self.engine._multihost or is_writer()
            if self.is_writer:
                self.db = RunDB(self.db_path, self.run_id)
            else:
                self.db = ReadOnlyRunDB(self.db_path, self.run_id)
            # native reject sink: mass reject rows go straight into the run
            # DB through the C++ writer
            self._native_sink = None
            if self.is_writer and self.config.use_native is not False:
                from .utils.native import NativeRejectSink, load_core
                if load_core() is not None:
                    self._native_sink = NativeRejectSink(self.db_path,
                                                         self.db.table)
                    self.engine.native_sink = self._native_sink
                elif self.config.use_native is True:
                    raise RuntimeError("use_native=True but the native "
                                       "core failed to build/load")

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _validate_knowns(self):
        """Check each known solution and print the verdicts."""
        self._log("Validating known solutions:")
        for expr_str, name in self.problem.known_solutions.items():
            ok, rel, note = self.problem.validate_known(expr_str)
            mark = "✓" if ok else "✗"
            suffix = f"  [{note}]" if note else ""
            self._log(f"  {mark} {name:24s} {expr_str}  "
                      f"(max relres {rel:.2e}){suffix}")

    def run(self, max_depth: Optional[int] = None,
            start_depth: int = 1) -> Dict:
        max_depth = max_depth or self.config.max_depth
        with spans.span("run.open"):
            if start_depth == 1 and not hasattr(self, "_resume_start_depth"):
                self._fresh_cleanup()
            with spans.span("db.write"):
                self.db.start_run(max_depth)
            t_start = time.time()
            self._log(f"Run {self.run_id}: {self.problem.name}, "
                      f"max_depth={max_depth}, device={self.engine.device}, "
                      f"db={self.db_path}" + self._mesh_note())
            self._validate_knowns()

        def on_row(row: Row):
            self.db.add_row(row)

        def on_rows(tuples):
            self.db.add_row_tuples(tuples)

        last_beat = [0.0]

        def on_batch(st):
            now = time.time()
            if now - last_beat[0] < 2.0:
                return
            last_beat[0] = now
            with spans.span("db.write"):
                self.db.flush()
                self.db.update_metadata(
                    sum(s.candidates for s in self.engine.stats)
                    + st.candidates,
                    self.engine.n_rows, len(self.engine.valid_rows))
                self.db.worker_heartbeat(os.getpid(), "device",
                                         self.engine.candidates_screened,
                                         errors=self.engine.errors,
                                         snippet=self.engine.last_expr)

        @spans.traced("depth.barrier")
        def on_depth(st):
            # every queued native-sink batch is in the DB before the depth
            # is marked completed
            if self._native_sink is not None:
                self._native_sink.flush()
            with spans.span("db.write"):
                self.db.flush()
                generated = sum(s.candidates for s in self.engine.stats)
                self.db.update_metadata(generated, self.engine.n_rows,
                                        len(self.engine.valid_rows))
                self.db.save_generator_state({
                    "completed_depth": st.depth,
                    "max_depth": max_depth,
                    "include_special_ops": self.config.include_special_ops,
                    "prune": self.config.prune,
                    "audit_rejects": self.config.audit_rejects,
                    "math_definition": self.engine._math_def,
                    "cache_n": self.engine.cache.n,
                    "device": str(self.engine.device),
                    "by_depth_counts": {
                        str(s.depth): {"generated": s.unique,
                                       "valid": s.valid,
                                       "candidates": s.candidates}
                        for s in self.engine.stats},
                })
            self._save_jet_snapshot()
            self._save_registry_sidecar(st.depth)
            with spans.span("db.write"):
                self.db.worker_heartbeat(os.getpid(), "device",
                                         self.engine.n_rows,
                                         errors=self.engine.errors)
            rate = (st.candidates / st.seconds) if st.seconds > 0 else 0
            self._log(f"  depth {st.depth}: {st.candidates} candidates, "
                      f"{st.unique} unique, {st.valid} valid "
                      f"[{st.seconds:.1f}s, {rate:,.0f} cand/s | "
                      f"enum {st.t_enum:.1f} dev {st.t_device:.1f} "
                      f"ingest {st.t_ingest:.1f} gray {st.t_gray:.1f}]")
            if st.ingest_sections:
                self._log("    ingest breakdown: " + " ".join(
                    f"{k} {v:.1f}" for k, v in st.ingest_sections.items()))
            if st.spans:
                self._log("    spans: " + " ".join(
                    f"{k} {v['n']}x {v['s']:.2f}/{v['self']:.2f}"
                    for k, v in st.spans.items()
                    if not k.startswith(spans.SECTION)) + " | " + " ".join(
                    f"{k} {v}" for k, v in st.counts.items()))
            if self.engine._multihost:
                from .parallel.distributed import EXCHANGE, backend
                self._log(f"    exchange ({backend()}): {EXCHANGE['calls']} "
                          f"all-gathers, {EXCHANGE['seconds']:.3f} s, "
                          f"{EXCHANGE['bytes'] / 1e6:.1f} MB so far")

        try:
            self.engine.run(max_depth, on_row=on_row, on_depth=on_depth,
                            start_depth=start_depth, on_batch=on_batch,
                            on_rows=on_rows)
        except KeyboardInterrupt:
            self.db.complete_run("aborted")
            raise
        return self._complete(max_depth, t_start)

    @spans.traced("report")
    def _complete(self, max_depth: int, t_start: float) -> Dict:
        """The completion after the last depth: the DB's indices, the
        report (family pass and classing) and its files."""
        with spans.span("db.write"):
            self.db.flush()
        # idempotent: the first read of the rows would build them
        with spans.span("report.index_build"):
            self.db.ensure_indices()
        # a non-writer's view of the shared DB races the writer's inserts:
        # its engine's rows and stats are its record
        valid = (self.db.rows("is_valid=1") if self.is_writer
                 else [dataclasses.asdict(r)
                       for r in self.engine.valid_rows])
        report = build_report(
            self.problem, stats=self.engine.stats,
            run_id=self.run_id, max_depth=max_depth,
            classify_novel=(len(self.engine.valid_rows)
                            <= self.config.novel_class_limit),
            by_depth_counts=(
                self.db.depth_counts()
                if self.config.audit_rejects and self.is_writer
                else {s.depth: {"generated": s.unique, "valid": s.valid}
                      for s in self.engine.stats}),
            valid_rows=valid,
            **self._report_extras(valid, families=self.report_families))
        report["wall_seconds"] = time.time() - t_start
        report["device"] = str(self.engine.device)
        report["device_seconds"] = self.engine.device_seconds
        report["candidates_screened"] = self.engine.candidates_screened
        report["dispatches"] = self.engine.dispatch_counts()
        report["launched_rows"] = self.engine.launched_rows()
        if self.mesh is not None:
            report["mesh"] = self._mesh_report()
        paths = (write_report_files(report, self.out_dir)
                 if self.is_writer else None)
        with spans.span("db.write"):
            self.db.update_metadata(
                sum(s.candidates for s in self.engine.stats)
                or report["total_generated"],
                self.engine.n_rows, report["total_valid"])
            self.db.complete_run("completed")
        self._log(format_report_text(report))
        if self.engine._multihost:
            # each rank's own record: it writes no report
            from .parallel import cuda_engine
            m = self._mesh_report()
            self._log(f"process {m['rank']} of {m['processes']}: "
                      f"{sum(s.unique for s in self.engine.stats)} uniques, "
                      f"dedup map {m['dedup_map_keys']} keys, "
                      f"{m['shard_launches']} shard launches, kernel "
                      f"launches {json.dumps(cuda_engine.LAUNCHES)}")
        if paths is not None:
            self._log(f"Reports: {paths['json']}  {paths['txt']}")
        report["report_paths"] = paths
        return report

    def _mesh_note(self) -> str:
        if self.mesh is None:
            return ""
        eng = self.engine
        note = (f", mesh {[str(d) for d in self.mesh.devices]} "
                f"({'uid-range-sharded' if eng._cache_sharded else 'replicated'}"
                " cache)")
        if eng._multihost:
            from .parallel.distributed import (backend, process_count,
                                               process_index)
            note += (f", process {process_index()} of {process_count()} "
                     f"({backend()}"
                     + (", sharded registry" if eng._reg_world > 1 else "")
                     + (", writer" if self.is_writer else "") + ")")
        return note

    def _mesh_report(self) -> Dict:
        """What the report says of the mesh and the process group."""
        from .parallel.distributed import (EXCHANGE, backend, process_count,
                                           process_index)
        eng = self.engine
        out = {"devices": [str(d) for d in self.mesh.devices],
               "shard_cache": eng._cache_sharded,
               "processes": process_count(), "rank": process_index(),
               "backend": backend(), "writer": self.is_writer,
               "registry_shards": eng._reg_world,
               "dedup_map_keys": len(eng.fp_to_uid),
               "shard_launches": eng.shard_launches}
        if eng._multihost:
            out["exchange"] = dict(EXCHANGE)
        return out

    @spans.traced("report.families")
    def _family_pass(self, valid_rows):
        """Array-level family tagging of the valid rows (utils/families):
        (breakdown, codes, names, is_novel), all None when there is no
        row.  Rows whose ids map onto the live registry take its tapes;
        the others (a report read back from the DB alone) parse their
        expression strings."""
        from .utils.families import summarize, tag_rows
        if not valid_rows:
            return None, None, None, None
        exprs = [r["expression"] for r in valid_rows]
        is_novel = np.array([not r["paper_solution_name"]
                             for r in valid_rows])
        enum = self.engine.enumerator
        uids = np.array([int(r["id"]) - 1 - self.engine.id_offset
                         for r in valid_rows], np.int64)
        tapes_fn = None
        if uids.min() >= 0 and uids.max() < enum.count_uniques():
            def tapes_fn(lo, hi):  # registry fast path
                return enum.tapes_batch(uids[lo:hi])
        codes, names = tag_rows(self.problem, exprs, tapes_fn=tapes_fn,
                                progress=self._log)
        breakdown = summarize(codes, names, exprs)
        for nm, note in (getattr(self.problem, "family_notes", {})
                         or {}).items():
            if nm in breakdown:
                breakdown[nm]["note"] = note
        return breakdown, codes, names, is_novel

    def _report_extras(self, valid_rows, families: bool = True) -> Dict:
        """build_report's family breakdown of the valid set and, when the
        novel set exceeds the SymPy classing limit, classing limited to
        the non-degenerate 'general' family; nothing with ``families``
        off."""
        if not families:
            return {}
        breakdown, codes, names, is_novel = self._family_pass(valid_rows)
        if breakdown is None:
            return {}
        out: Dict = {"family_breakdown": breakdown}
        n_novel = int(is_novel.sum())
        if n_novel > self.config.novel_class_limit:
            general = {i for i, nm in enumerate(names) if nm == "general"}
            keep = [r for r, c, nov in zip(valid_rows, codes, is_novel)
                    if nov and int(c) in general]
            out["novel_class_rows"] = keep
            out["novel_class_note"] = (
                f"{n_novel - len(keep)} of {n_novel} novel rows belong "
                "to array-tagged degenerate families (see breakdown); "
                f"SymPy classing covers the {len(keep)} non-degenerate "
                "rows")
        return out

    # ------------------------------------------------------------------
    # Depth-barrier state: jet snapshot and registry sidecar
    # ------------------------------------------------------------------

    @property
    def _snapshot_dir(self) -> str:
        return self.db_path + ".jets.d"         # incremental shard format

    _SHARD_ROWS = 1 << 19   # ~275 MB per shard at order-4 dims

    @staticmethod
    def _range_files(d: str, prefix: str):
        """Sorted [(lo, hi, path)] of ``<prefix><lo>_<hi>.npz`` in ``d``."""
        if not os.path.isdir(d):
            return []
        out = []
        for fn in os.listdir(d):
            if not (fn.startswith(prefix) and fn.endswith(".npz")):
                continue
            try:
                lo, hi = fn[len(prefix):-len(".npz")].split("_")
                out.append((int(lo), int(hi), os.path.join(d, fn)))
            except ValueError:
                continue
        out.sort()
        return out

    def _shard_files(self):
        return self._range_files(self._snapshot_dir, "shard_")

    def _save_jet_snapshot(self):
        """Write the cache rows appended since the last barrier as a new
        shard beside the run DB.  Resume loads them bit for bit, so the
        resumed cache equals the one the run had (float64 re-derivation
        would shift fingerprint keys).  Rows are append-only, so a depth
        costs its delta.  Only the writer writes it."""
        if not self.config.snapshot_jets or not self.is_writer:
            return
        cache = self.engine.cache
        shards = self._shard_files()
        saved = shards[-1][1] if shards else 0
        n = cache.n
        if n <= saved:
            return
        row_bytes = (cache.sdim + cache.fdim) * 4
        cap_rows = self.config.snapshot_max_bytes // max(row_bytes, 1)
        if saved >= cap_rows:
            self._log(f"  [snapshot capped at {saved} rows "
                      "(snapshot_max_bytes); resume rebuilds the tail]")
            return
        n = min(n, cap_rows)
        os.makedirs(self._snapshot_dir, exist_ok=True)
        lo = saved
        while lo < n:
            hi = min(lo + self._SHARD_ROWS, n)
            part = cache.snapshot_range(lo, hi)
            path = os.path.join(self._snapshot_dir, f"shard_{lo}_{hi}.npz")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **part)
            os.replace(tmp, path)
            lo = hi

    def _invalidate_jet_snapshot(self):
        """Remove the on-disk jet snapshot.  Called when a resume could
        not use it: the next barrier then rewrites the snapshot from row 0
        of the live cache instead of appending to a base this run did not
        load.  Only the writer removes it."""
        if self.is_writer:
            shutil.rmtree(self._snapshot_dir, ignore_errors=True)

    def _fresh_cleanup(self):
        """A fresh run removes another run's resume state at the same
        db_path (jet shards, registry parts and manifest, key shards), so
        that none of it becomes the delta base of this run's files.  The
        writer removes the shared files; every rank of a sharded-registry
        run its own key shard."""
        import glob
        eng = self.engine
        if eng._reg_world > 1:
            try:
                os.remove(self._keys_shard_path(eng._reg_rank))
            except OSError:
                pass
        if not self.is_writer:
            return
        self._invalidate_jet_snapshot()
        shutil.rmtree(self._registry_dir, ignore_errors=True)
        for p in [self._registry_path] + glob.glob(
                self.db_path + ".registry.keys.*.npz"):
            try:
                os.remove(p)
            except OSError:
                pass

    def _load_jet_snapshot(self):
        """The jet snapshot from the shard directory; None when absent,
        non-contiguous or unreadable."""
        shards = self._shard_files()
        if not shards:
            return None
        expect = 0
        for lo, hi, _ in shards:
            if lo != expect:
                self._log("resume: snapshot shards non-contiguous; "
                          "ignoring snapshot")
                return None
            expect = hi
        n = expect
        try:
            with np.load(shards[0][2]) as z0:
                sdim = z0["screen"].shape[1]
                fdim = z0["fp"].shape[1]
            screen = np.empty((n, sdim), np.float32)
            fp = np.empty((n, fdim), np.float32)
            for lo, hi, path in shards:
                with np.load(path) as z:
                    screen[lo:hi] = z["screen"]
                    fp[lo:hi] = z["fp"]
            return {"screen": screen, "fp": fp, "n": n}
        except Exception:
            return None

    @property
    def _registry_path(self) -> str:
        return self.db_path + ".registry.npz"

    @property
    def _registry_dir(self) -> str:
        return self.db_path + ".registry.d"     # incremental part format

    def _registry_part_files(self):
        return self._range_files(self._registry_dir, "part_")

    def _save_registry_sidecar(self, completed_depth: int):
        """Persist the enumeration state at a depth barrier: the
        structural triple (op, a, b, depth) and the uint64 dedup key of
        every unique in uid order, plus the depth-1 spellings.  Each
        barrier writes only the delta since the last one
        (``part_<lo>_<hi>.npz``, run_id-tagged) and a small manifest.
        Resume rebuilds the registry and the dedup map from it, also for
        runs whose reject rows are not in the DB."""
        eng = self.engine
        enum = eng.enumerator
        n = enum.count_uniques()
        if n == 0:
            return
        sharded = eng._reg_world > 1
        if sharded:
            # every rank writes the key slice it owns; the manifest's
            # keys_sharded tells a resume to merge the slices
            self._save_keys_shard()
        if not self.is_writer:
            return
        if not sharded and len(eng.fp_to_uid) != n:
            self._log(f"  [registry sidecar skipped: {len(eng.fp_to_uid)} "
                      f"keys != {n} uniques]")
            return
        d1 = enum.uid_array(1)
        k = int(d1.size)
        if not (np.array_equal(d1, np.arange(k, dtype=d1.dtype))
                and bool((enum.u_depth[k:n] != 1).all())):
            self._log("  [registry sidecar skipped: depth-1 uniques are "
                      "not the uid prefix]")
            return
        # delta base: the existing parts must be this run's, contiguous
        # from 0 and not ahead of the registry; anything else is wiped
        # and rewritten
        parts = self._registry_part_files()
        saved = 0
        if parts:
            expect = 0
            ok = True
            for lo, hi, path in parts:
                if lo != expect:
                    ok = False
                    break
                expect = hi
                try:
                    with np.load(path) as z:
                        if str(z["run_id"]) != self.run_id:
                            ok = False
                            break
                except Exception:
                    ok = False
                    break
            if ok and expect <= n:
                saved = expect
            else:
                shutil.rmtree(self._registry_dir, ignore_errors=True)
        if n > saved:
            keys = np.zeros(0 if sharded else n - saved, np.uint64)
            if not sharded:
                ks, vs = eng.fp_to_uid.items_arrays()
                m = vs >= saved
                keys[vs[m] - saved] = ks[m]
            os.makedirs(self._registry_dir, exist_ok=True)
            path = os.path.join(self._registry_dir, f"part_{saved}_{n}.npz")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f,
                         op=enum.u_op[saved:n].copy(),
                         a=enum.u_a[saved:n].copy(),
                         b=enum.u_b[saved:n].copy(),
                         depth=enum.u_depth[saved:n].copy(),
                         keys=keys, run_id=np.str_(self.run_id))
            os.replace(tmp, path)
        d1_exprs = np.array([enum.expr_str_of(int(u)) for u in d1])
        tmp = self._registry_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f,
                     d1_exprs=d1_exprs,
                     n_uniques=np.int64(n),
                     run_id=np.str_(self.run_id),
                     completed_depth=np.int64(completed_depth),
                     cache_n=np.int64(eng.cache.n),
                     n_rows=np.int64(eng.n_rows),
                     keys_sharded=np.int64(eng._reg_world if sharded
                                           else 0))
        os.replace(tmp, self._registry_path)

    def _keys_shard_path(self, rank: int) -> str:
        return self.db_path + f".registry.keys.{rank}.npz"

    def _save_keys_shard(self):
        """This rank's owned slice of the dedup keys (uids and uint64
        keys).  Ownership is key mod world, so every key, the depth-1 keys
        that every rank holds included, lies in exactly one shard file."""
        eng = self.engine
        ks, vs = eng.fp_to_uid.items_arrays()
        own = (ks % np.uint64(eng._reg_world)) == np.uint64(eng._reg_rank)
        path = self._keys_shard_path(eng._reg_rank)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, keys=ks[own], uids=vs[own].astype(np.int64),
                     world=np.int64(eng._reg_world),
                     run_id=np.str_(self.run_id))
        os.replace(tmp, path)

    def _load_sharded_keys(self, n: int, world: int) -> np.ndarray:
        """The ``world`` key shard files merged into the uid-ordered key
        array.  Each file must carry this world size and run_id (stale
        shards of another run at the same db_path are never merged), and
        together they must cover every uid."""
        keys = np.zeros(n, np.uint64)
        seen = np.zeros(n, np.bool_)
        for rank in range(world):
            path = self._keys_shard_path(rank)
            if not os.path.exists(path):
                raise RuntimeError(
                    f"registry key shard for rank {rank}/{world} missing "
                    f"({path}): cannot resume a sharded-registry run "
                    "from an incomplete sidecar")
            with np.load(path) as z:
                w, rid = int(z["world"]), str(z["run_id"])
                if w != world or rid != self.run_id:
                    raise RuntimeError(
                        f"registry key shard {path} belongs to another run "
                        f"(world {w} vs {world}, run_id {rid!r} vs "
                        f"{self.run_id!r}); refusing to merge it")
                uids = z["uids"]
                m = uids < n          # a shard may be ahead of the manifest
                keys[uids[m]] = z["keys"][m]
                seen[uids[m]] = True
        if not bool(seen.all()):
            raise RuntimeError(
                f"registry key shards ({world} files) cover "
                f"{int(seen.sum())} of the {n} uniques of "
                f"{self._registry_path}: cannot resume from them")
        return keys

    def _load_registry_sidecar(self):
        """The registry sidecar as uid-ordered arrays (op, a, b, depth,
        keys) plus its manifest; None when absent or inconsistent."""
        path = self._registry_path
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                reg = {k: z[k] for k in z.files}
        except Exception:
            return None
        try:
            n = int(reg["n_uniques"])
            run_id = str(reg["run_id"])
            parts = self._registry_part_files()
            if not parts:
                return None
            op = np.empty(n, np.int16)
            a = np.empty(n, np.int32)
            b = np.empty(n, np.int32)
            depth = np.empty(n, np.int16)
            keys = np.zeros(n, np.uint64)
            expect = 0
            for lo, hi, p in parts:
                if lo >= n:
                    break
                if lo != expect:
                    return None     # non-contiguous
                with np.load(p) as z:
                    if str(z["run_id"]) != run_id:
                        return None  # stale part from another run
                    m = min(hi, n) - lo   # a part may be newer than the
                    op[lo:lo + m] = z["op"][:m]   # manifest by a crash
                    a[lo:lo + m] = z["a"][:m]
                    b[lo:lo + m] = z["b"][:m]
                    depth[lo:lo + m] = z["depth"][:m]
                    kk = z["keys"]
                    if kk.size:
                        keys[lo:lo + m] = kk[:m]
                expect = hi
            if expect < n:
                return None         # parts do not cover the registry
        except Exception:
            return None
        reg.update(op=op, a=a, b=b, depth=depth, keys=keys)
        return reg

    # ------------------------------------------------------------------
    # Resume
    # ------------------------------------------------------------------

    @classmethod
    def resume(cls, problem_name, run_id: str,
               config: Optional[SearchConfig] = None,
               db_path: Optional[str] = None, device="cuda",
               verbose: bool = True, report_families: bool = True,
               mesh=None) -> "DiscoveryRun":
        """Rebuild a run and continue it at the next depth
        (:meth:`continue_run`): from its registry sidecar when one
        matches the last completed depth, else from the rows of the run
        DB (:meth:`_resume_from_db`).  A run recorded without reject rows
        and without a matching sidecar cannot be rebuilt from its DB and
        is refused, and so is a run recorded for another PDE than the
        problem's (an Ω run resumed without its ``omega``).  The engine
        is built with the op set and pruning the run recorded
        (:func:`recorded_config`), so the resumed depths extend the
        enumeration of the stored ones.  Across processes every rank
        waits at a barrier first, so that none rebuilds before the writer
        has flushed the run it resumes; every rank then reads the same
        stored state."""
        if mesh is not None:
            from .parallel.distributed import barrier
            barrier()
        problem = (problem_name if isinstance(problem_name, Problem)
                   else load_problem(problem_name))
        state = stored_state(
            db_path or db_path_for(problem.get_output_dir(), run_id),
            run_id)
        # the engine enumerates the resumed depths as the run recorded
        config = recorded_config(config or SearchConfig(), state, run_id)
        self = cls(problem, config, run_id=run_id, db_path=db_path,
                   device=device, verbose=verbose,
                   report_families=report_families, mesh=mesh)
        try:
            stored = state.get("math_definition")
            if stored is not None and stored != self.engine._math_def:
                # e.g. a rotating force_free run resumed without --omega:
                # its deeper depths would be screened by another residual
                raise ValueError(
                    f"run {run_id} was recorded for {stored!r}, not for "
                    f"this problem's {self.engine._math_def!r}: resume it "
                    "with the problem it ran (--omega of a rotating "
                    "force_free run)")
            completed = int(state.get("completed_depth", 0))
            with self._secondary_indices_dropped():
                reg = self._load_registry_sidecar()
                if (reg is not None and completed
                        and int(reg["completed_depth"]) == completed):
                    self._resume_from_registry(reg, state, completed)
                elif state.get("audit_rejects") is False:
                    # the DB holds only the valid rows: a rebuild from it
                    # would under-enumerate every deeper depth without a
                    # word
                    raise RuntimeError(
                        f"run {run_id} was recorded with "
                        "audit_rejects=False and has no registry sidecar "
                        f"for its completed depth {completed} "
                        f"({self._registry_path}): its DB holds only the "
                        "valid rows, so it cannot be resumed")
                else:
                    self._resume_from_db(state, completed)
        except BaseException:
            self.close()
            raise
        return self

    @contextlib.contextmanager
    def _secondary_indices_dropped(self):
        """Rebuild the run in the body, then write the resumed depths as
        a fresh run writes its depths: without the run table's secondary
        indices.  ``RunDB.ensure_indices`` owns them: it builds them at
        ``complete_run`` and at any read while ``_indices_made`` is
        False.  The rebuild's reads pass them by (a cut run's file does
        not build them only to drop them); then the writer drops those
        the reopened file holds, since every reject row of a resumed
        depth would update each of them, and leaves them to
        ``complete_run`` (for a run that is cut, to its first reader).
        Only the writer holds the file."""
        db = self.db
        db._indices_made = True
        yield
        if self.is_writer:
            for name, in db.conn.execute(
                    "SELECT name FROM sqlite_master WHERE type='index' "
                    "AND tbl_name=? AND name LIKE 'idx_%'",
                    (db.table,)).fetchall():
                db.conn.execute(f"DROP INDEX {name}")
            db.conn.commit()
        db._indices_made = False

    def _resume_from_db(self, state, completed: int):
        """Rebuild the engine from the stored rows of the completed
        depths.  Rows of a depth that was cut mid-way are not registered:
        the re-run of that depth makes them again with the same ids, and
        the DB keeps the stored ones.

        Every composed row re-registers from its structural triple
        (:func:`_struct_columns`: the ``struct_op``, ``a``, ``b`` columns
        where they spell the row, else, as in DBs older than those
        columns, the triple its spelling names), so the jet cache replays
        it through the kernels as a fresh run computed it.  Depth-1 rows,
        and a composed row whose spelling does not invert, re-parse with
        SymPy and register as leaves.  The dedup map takes each row's key
        from its ``signature`` column.  A jet snapshot is used only if
        every stored row re-registered (uid = id - 1)."""
        rows = (self.db.rows("depth <= ?", (completed,)) if completed
                else self.db.rows())
        eng = self.engine
        depth = np.fromiter((r["depth"] for r in rows), np.int64, len(rows))
        ids = np.fromiter((r["id"] for r in rows), np.int64, len(rows))
        op, a, b, spelled = _struct_columns(rows, depth)
        uid, leaves = self._register_rows(rows, op, a, b, depth, ids)
        n_comp = int(np.count_nonzero(depth > 1))
        lost = int(np.count_nonzero(uid < 0))
        if spelled or leaves or lost:
            self._log(f"resume: parse path: {spelled} composed rows "
                      "re-registered from their spelling, "
                      f"{leaves} as leaves"
                      + (f", {lost} rows lost (SymPy cannot parse them)"
                         if lost else ""))
        else:
            self._log(f"resume: structural fast path for {n_comp} composed "
                      f"rows ({len(rows) - n_comp} depth-1 rows parsed)")
        for r in rows:
            if r["is_valid"]:
                eng.valid_rows.append(_valid_row(r))
        if eng._reg_world > 1:
            eng.keep_owned_keys()
        self._restore_stats_stubs(state, completed)
        snap = self._load_jet_snapshot()
        if snap is not None and eng.id_offset != 0:
            # some stored rows did not re-register, so the snapshot's rows
            # no longer align with the uids
            snap = None
        if snap is None:
            self._invalidate_jet_snapshot()
        eng.seed_cache_from_uniques(
            snapshot=snap,
            limit=self._resume_seed_limit(state, completed,
                                          state.get("cache_n")))
        self._resume_start_depth = completed + 1
        self._log(f"Resumed {self.run_id} from its DB rows: {len(rows)} "
                  f"rows ({len(eng.valid_rows)} valid), completed depth "
                  f"{completed}, cache {eng.cache.n} rows"
                  + (f", jet snapshot x{snap['n']}" if snap else
                     ", no jet snapshot (rows rebuilt by the float64 "
                     "oracle and the kernels)"))

    def _register_rows(self, rows, op, a, b, depth, ids):
        """Register the stored ``rows`` in id order and return each row's
        uid (-1 for a row SymPy cannot parse: it is lost, and the id gap
        shows in ``id_offset``) and the number of composed rows
        registered as leaves.  Each run of rows with a triple (``op`` >=
        0, parents ``a``, ``b`` as row positions) goes through
        ``register_from_struct`` at array speed, as the sidecar resume
        registers them; every other row, and a row whose parent was
        lost, re-parses as a leaf.  The flags are the forward path's: a
        composed row's come from its parents, a leaf's ``has_var`` is
        structural (a variable's name in the string; a re-parsed tape is
        SymPy-normalised, and ``log_mul(rho, 1)`` parses to a constant)
        and ``is_one`` marks only the literal depth-1 constant."""
        eng = self.engine
        enum = eng.enumerator
        consts = self.problem.consts
        var_pat = re.compile("|".join(rf"\b{re.escape(v)}\b"
                                      for v in self.problem.var_names))
        n = len(rows)
        keys = np.fromiter((_row_key(r) for r in rows), np.uint64, n)
        uid = np.full(n, -1, np.int64)
        parsed = np.zeros(n, bool)
        leaf = op < 0
        leaf_at = np.flatnonzero(leaf)
        i = 0
        while i < n:
            if leaf[i]:
                expr = rows[i]["expression"]
                try:
                    tape = self.problem.parse(expr)
                except Exception:   # noqa: BLE001 - any SymPy failure
                    i += 1
                    continue
                u = enum.add_unique(Candidate(
                    tape=tape, depth=int(depth[i]), expr_str=expr,
                    top_op=_top_op_of(expr),
                    has_var=bool(var_pat.search(expr)),
                    is_one=bool(depth[i] == 1
                                and tape.is_const_one(consts)),
                    consts=consts))
                uid[i] = u.uid
                parsed[i] = True
                eng.fp_to_uid[int(keys[i])] = u.uid
                eng.n_rows += 1
                i += 1
                continue
            k = np.searchsorted(leaf_at, i)
            j = int(leaf_at[k]) if k < leaf_at.size else n
            uid[i:j] = enum.count_uniques() + np.arange(j - i)
            ua = uid[a[i:j]]
            ub = np.where(b[i:j] < 0, -1, uid[b[i:j]])
            lost = np.flatnonzero((ua < 0) | ((b[i:j] >= 0) & (ub < 0)))
            if lost.size:
                # a parent did not re-parse: from that row on, re-parse
                j = i + int(lost[0])
                uid[j:] = -1
                leaf[j] = True
                leaf_at = np.insert(leaf_at, k, j)
            if j > i:
                enum.register_from_struct(
                    op[i:j].astype(np.int16), ua[:j - i].astype(np.int32),
                    ub[:j - i].astype(np.int32),
                    depth[i:j].astype(np.int16),
                    [r["expression"] for r in rows[i:j]])
                eng.fp_to_uid.set_batch(keys[i:j], uid[i:j])
                eng.n_rows += j - i
            i = j
        kept = uid >= 0
        eng.id_offset = int((ids[kept] - 1 - uid[kept]).max(initial=0))
        return uid, int(np.count_nonzero(parsed & (depth > 1)))

    def _resume_from_registry(self, reg, state, completed: int):
        """Rebuild the engine from the registry sidecar: depth-1 rows
        re-parse, composed rows re-register from their structural triples
        (display strings regenerated by the forward composition), the
        dedup map is restored key for key, and the jet cache is seeded
        (``DiscoveryEngine.seed_cache_from_uniques``).  A sharded-registry
        run's keys are merged from its key shard files, and a
        sharded-registry engine keeps the slice it owns."""
        eng = self.engine
        enum = eng.enumerator
        d1_exprs = [str(s) for s in reg["d1_exprs"].tolist()]
        for s in d1_exprs:
            tape = self.problem.parse(s)
            enum.add_unique(Candidate(
                tape=tape, depth=1, expr_str=s, top_op="",
                has_var=tape.uses_var(),
                is_one=tape.is_const_one(self.problem.consts),
                consts=self.problem.consts))
        k = len(d1_exprs)
        n = int(reg["op"].size)
        if enum.count_uniques() != k:
            raise RuntimeError(
                "registry sidecar: depth-1 re-registration mismatch")
        if n > k:
            op_ids = np.asarray(reg["op"][k:], np.int16)
            a_arr = np.asarray(reg["a"][k:], np.int32)
            b_arr = np.asarray(reg["b"][k:], np.int32)
            d_arr = np.asarray(reg["depth"][k:], np.int16)
            if self.config.audit_rejects and eng.persist_host:
                enum.register_from_struct_compose(op_ids, a_arr, b_arr,
                                                  d_arr)
            else:
                # no reject rows are emitted (a no-audit run, or a
                # non-writer of a sharded-registry run), and valid rows
                # rebuild their strings lazily from structure: skip
                # regenerating them
                enum.register_from_struct(op_ids, a_arr, b_arr, d_arr,
                                          exprs=None)
                for d in np.unique(d_arr).tolist():
                    enum._dropped_string_depths.add(int(d))
        if int(reg.get("keys_sharded", 0)) > 1:
            keys = self._load_sharded_keys(n, int(reg["keys_sharded"]))
        else:
            keys = np.asarray(reg["keys"], np.uint64)
        uids = np.arange(n, dtype=np.int64)
        if eng._reg_world > 1:
            own = (keys % np.uint64(eng._reg_world)) == np.uint64(
                eng._reg_rank)
            keys, uids = keys[own], uids[own]
        eng.fp_to_uid.set_batch(keys, uids)
        eng.n_rows = int(reg["n_rows"])
        for r in self.db.rows("is_valid=1 AND depth <= ?", (completed,)):
            eng.valid_rows.append(_valid_row(r))
        self._restore_stats_stubs(state, completed)
        snap = self._load_jet_snapshot()
        if snap is None:
            self._invalidate_jet_snapshot()
        eng.seed_cache_from_uniques(
            snapshot=snap,
            limit=self._resume_seed_limit(state, completed,
                                          int(reg["cache_n"])))
        self._resume_start_depth = completed + 1
        self._log(f"Resumed {self.run_id} via registry sidecar: {n} "
                  f"uniques ({len(eng.valid_rows)} valid), completed "
                  f"depth {completed}, cache {eng.cache.n} rows"
                  + (f", jet snapshot x{snap['n']}" if snap else
                     ", no jet snapshot (rows rebuilt by the kernels)"))

    def _resume_seed_limit(self, state, completed: int,
                           cache_n) -> Optional[int]:
        """Parent window to restore on resume: the saved ``cache_n``,
        which re-running an interrupted depth must reproduce exactly.  A
        completed run extended past its recorded max_depth widens it to
        what a fresh run at the new max_depth would have cached (the
        saved window was clamped by the final depth's append limit); the
        missing rows replay through the kernels."""
        if cache_n is None:
            return None
        limit = int(cache_n)
        try:
            orig_max = int(state.get("max_depth") or completed)
        except (TypeError, ValueError):
            orig_max = completed
        if completed >= orig_max and self.config.max_depth > completed:
            eng = self.engine
            limit = max(limit, min(eng.enumerator.count_uniques(),
                                   eng.cache_row_limit))
            if limit > int(cache_n):
                self._log(f"resume: extending parent window "
                          f"{int(cache_n)} -> {limit} rows (completed "
                          f"run extended past its recorded max_depth "
                          f"{orig_max}; missing jets replay through the "
                          "kernels)")
        return limit

    def _restore_stats_stubs(self, state, completed: int):
        """DepthStats of the completed depths from the saved per-depth
        counts, so the resumed run's state and report keep them."""
        bdc = state.get("by_depth_counts") or {}
        for d_str in sorted(bdc, key=int):
            d = int(d_str)
            if d > completed:
                continue
            v = bdc[d_str]
            self.engine.stats.append(DepthStats(
                depth=d, candidates=int(v.get("candidates", 0)),
                unique=int(v.get("generated", 0)),
                valid=int(v.get("valid", 0))))

    def continue_run(self, max_depth: Optional[int] = None) -> Dict:
        start = getattr(self, "_resume_start_depth", 1)
        return self.run(max_depth=max_depth, start_depth=start)

    # ------------------------------------------------------------------
    # Post-hoc audits: read a run back from its DB
    # ------------------------------------------------------------------

    def print_report_from_db(self, classify_novel: bool = True,
                             families: bool = True) -> Dict:
        """The run's report from its DB alone.  A run recorded without
        reject rows holds only its valid rows: its per-depth totals come
        from the saved generator state.  ``families=False`` skips the
        family breakdown, which on a DB alone parses every valid row."""
        rows = self.db.rows()
        state = self.db.load_generator_state() or {}
        counts = None
        if state.get("audit_rejects") is False:
            counts = state.get("by_depth_counts") or {}
        valid = [r for r in rows if r["is_valid"]]
        meta = self.db.metadata()
        report = build_report(
            self.problem, rows if counts is None else None,
            run_id=self.run_id,
            max_depth=(meta["max_depth"] if meta is not None else 0) or 0,
            classify_novel=classify_novel, by_depth_counts=counts,
            valid_rows=valid if counts is not None else None,
            **self._report_extras(valid, families=families))
        if counts is not None:
            self._log("NOTE: reject rows were not persisted "
                      "(audit_rejects=0); totals come from the saved "
                      "generator state")
        self._log(format_report_text(report))
        return report

    def _scoped_rows(self, scope: str):
        """The stored rows of ``scope``: 'novel' (valid, not a known
        solution), 'valid' or 'all'."""
        if scope == "novel":
            return self.db.rows("is_valid=1 AND is_paper_solution=0")
        if scope == "valid":
            return self.db.rows("is_valid=1")
        return self.db.rows()

    def _limited(self, rows, scope: str, limit: Optional[int], verb: str,
                 flag: str):
        """The ``limit`` shortest of ``rows`` (all of them without one)."""
        if limit is None or len(rows) <= limit:
            return rows
        self._log(f"{verb}: limited to the {limit} shortest of "
                  f"{len(rows)} {scope} rows ({flag})")
        return sorted(rows, key=lambda r: len(r["expression"]))[:limit]

    def _sympy_of(self, expr: str):
        return self.problem.tape_to_sympy(self.problem.parse(expr))

    def verify_pde_from_db(self, scope: str = "novel",
                           limit: Optional[int] = None) -> Dict:
        """Prove residual == 0 symbolically for stored rows, the shortest
        ``limit`` first (a SymPy proof takes about 0.1-1 s a row)."""
        rows = self._limited(self._scoped_rows(scope), scope, limit,
                             "verify-pde", "--verify-limit")
        confirmed, refuted, skipped = [], [], []
        t0 = time.time()
        for i, r in enumerate(rows):
            expr = r["expression"]
            try:
                ok = self.problem.exact_zero_residual(self._sympy_of(expr))
            except Exception:   # noqa: BLE001 - SymPy fails many ways
                skipped.append(expr)
            else:
                (confirmed if ok else refuted).append(expr)
            if (i + 1) % 500 == 0:
                rate = (i + 1) / max(time.time() - t0, 1e-9)
                self._log(f"  verify-pde: {i + 1}/{len(rows)} "
                          f"({rate:.1f} rows/s)")
        self._log(f"verify-pde [{scope}]: {len(confirmed)} confirmed, "
                  f"{len(refuted)} refuted, {len(skipped)} skipped")
        for e in refuted[:20]:
            self._log(f"  REFUTED: {e}")
        return {"confirmed": confirmed, "refuted": refuted,
                "skipped": skipped}

    def heavy_validate_from_db(self, scope: str = "valid",
                               limit: Optional[int] = None) -> Dict:
        """Run the heavy checks (regularity, finiteness, anchor) over
        stored rows, the shortest ``limit`` first, and write each verdict
        into the row's ``heavy_*`` columns."""
        rows = self._limited(self._scoped_rows(scope), scope, limit,
                             "heavy-validate", "--heavy-limit")
        passed = failed = 0
        for r in rows:
            try:
                ok, reason = self.problem.heavy_checks(
                    self._sympy_of(r["expression"]))
            except Exception as e:  # noqa: BLE001 - recorded on the row
                ok, reason = False, f"heavy check error: {e}"
            self.db.update_heavy(int(r["id"]), ok, reason)
            passed += int(ok)
            failed += int(not ok)
        self._log(f"heavy-validate [{scope}]: {passed} passed, "
                  f"{failed} failed")
        return {"passed": passed, "failed": failed}

    def find_monopole_extensions(self, scope: str = "valid",
                                 target: str = "either") -> List[str]:
        """Kerr: the stored rows whose a -> 0 limit is the monopole
        (``target``: '1-x', 'x' or either)."""
        if not hasattr(self.problem, "is_monopole_extension"):
            self._log("find-monopole: not a Kerr problem")
            return []
        old = self.problem.monopole_target
        self.problem.monopole_target = target
        hits = []
        try:
            for r in self._scoped_rows(scope):
                try:
                    hit = self.problem.is_monopole_extension(
                        self._sympy_of(r["expression"]))
                except Exception:   # noqa: BLE001 - not a candidate
                    continue
                if hit:
                    hits.append(r["expression"])
        finally:
            self.problem.monopole_target = old
        self._log(f"find-monopole [{scope}, target={target}]: "
                  f"{len(hits)} candidates")
        for e in hits[:20]:
            self._log(f"  {e}")
        return hits

    def audit_kerr_candidates(self, scope: str = "valid") -> Dict:
        """Tag stored rows as constant, without r or x dependence, or a
        disguised monopole (``1 - x`` or ``x``)."""
        import sympy as sp
        r_sym, x_sym = self.problem.sympy_vars()
        tags: Dict[str, List[str]] = {
            "constant": [], "no_r_dependence": [], "no_x_dependence": [],
            "disguised_monopole": [], "other": []}
        for r in self._scoped_rows(scope):
            expr = r["expression"]
            try:
                u = sp.simplify(self._sympy_of(expr))
            except Exception:   # noqa: BLE001 - not taggable
                continue
            has_r, has_x = u.has(r_sym), u.has(x_sym)
            if not has_r and not has_x:
                tag = "constant"
            elif not has_r:
                try:
                    mono = (sp.simplify(u - (1 - x_sym)) == 0
                            or sp.simplify(u - x_sym) == 0)
                except Exception:   # noqa: BLE001 - undecided
                    mono = False
                tag = "disguised_monopole" if mono else "no_r_dependence"
            elif not has_x:
                tag = "no_x_dependence"
            else:
                tag = "other"
            tags[tag].append(expr)
        for k, v in tags.items():
            self._log(f"audit-kerr [{scope}] {k}: {len(v)}")
        return tags

    def certify_from_db(self, scope: str = "valid",
                        limit: Optional[int] = None) -> Dict:
        """Write machine-checkable exactness certificates for stored rows,
        the shortest ``limit`` first, beside the run DB
        (``tools/check_certificates.py`` re-verifies them)."""
        from .utils.certify import certify_rows
        rows = self._limited(self._scoped_rows(scope), scope, limit,
                             "certify", "--certify-limit")
        out = certify_rows(self.problem, rows, self.out_dir,
                           run_id=self.run_id)
        self._log(f"certify [{scope}]: {out['n']} certificates "
                  f"{out['counts']} -> {out['path']}")
        return out

    def close(self):
        with spans.span("run.close"):
            if self._native_sink is not None:
                self._native_sink.close()
                self._native_sink = None
            self.engine._gray_pool.shutdown(wait=True)
            self.db.close()
        self._run_span.end()
        self._run_span = spans.OFF
        # what ended after the last depth's stats were written: the
        # report, close() and the run itself
        spans.drain(self.engine.stats[-1] if self.engine.stats else None)


# the generator-state flags that decide which expressions a run
# enumerates, each with the CLI flag that turns it off
RECORDED_FLAGS = (("include_special_ops", "--no-special-ops"),
                  ("prune", "--no-prune"))


class ResumeConflict(ValueError):
    """A resume asked for another enumeration than its run recorded."""


def stored_state(db_path: str, run_id: str) -> Dict:
    """A run's generator state, read before the run is opened: {} when
    there is no DB or no state.  A plain connection closes the WAL it
    opens, where a read-only one would leave its ``-wal`` and ``-shm``
    files behind, so a resume that is refused leaves the run's files as
    they were."""
    if not os.path.exists(db_path):
        return {}
    con = sqlite3.connect(db_path)
    try:
        r = con.execute("SELECT state_json FROM generator_progress "
                        "WHERE run_id=?", (run_id,)).fetchone()
    finally:
        con.close()
    return json.loads(r[0]) if r else {}


def recorded_config(config: SearchConfig, state: Dict,
                    run_id: str) -> SearchConfig:
    """``config`` with the op set and pruning a run recorded in its
    generator ``state``: a flag left on (the default) takes the stored
    setting, and a flag turned off on a run recorded with it on raises
    :class:`ResumeConflict`, since the resumed depths would be another
    enumeration.  A state from before a flag was stored counts as the
    default (on); without a state the config is kept as it is."""
    if not state:
        return config
    stored = {k: bool(state.get(k, True)) for k, _ in RECORDED_FLAGS}
    for k, flag in RECORDED_FLAGS:
        if stored[k] and not getattr(config, k):
            raise ResumeConflict(
                f"run {run_id} was recorded with {k}=True: {flag} would "
                "enumerate its deeper depths from another set of "
                f"expressions; resume it without {flag}")
    return dataclasses.replace(config, **stored)


def _row_key(r) -> int:
    """A stored row's dedup key: its ``signature`` column in hex (what
    the engine writes), else the structural key of its expression."""
    try:
        return int(r["signature"], 16)
    except (TypeError, ValueError):
        from .utils.hashing import struct_key_for_expr
        return struct_key_for_expr(r["expression"])


def _valid_row(r) -> Row:
    """The engine's Row of a stored valid row."""
    return Row(id=int(r["id"]), expression=r["expression"],
               normalized=r["normalized"] or r["expression"],
               signature=r["signature"] or "", depth=int(r["depth"]),
               is_valid=True,
               validation_reason=r["validation_reason"] or "",
               validator_method=r["validator_method"] or "",
               is_paper_solution=bool(r["is_paper_solution"]),
               paper_solution_name=r["paper_solution_name"])


def _struct_columns(rows, depth):
    """(op, a, b, spelled) of stored rows in id order (``depth``: their
    column as an array): for each composed row its op id (the
    ``ALL_SURFACE_OPS`` order the forward path stores) and its parents as
    row positions (b -1 for a unary op); op -1 for a depth-1 row and for
    a row no triple spells.  The ``struct_op``, ``a``, ``b`` columns hold
    the writer's uids, which are row positions only if the writer had
    re-registered every row before (a resume that lost a row, in the
    port or in the JAX package, writes shifted uids), so a stored triple
    is taken only where its parents at those positions spell the row
    (:func:`_spelling`).  Every other composed row, and every row of a DB
    older than the columns, takes the triple its spelling names over the
    rows before it (:func:`_triple_of_spelling`); ``spelled`` counts
    those."""
    n = len(rows)

    def col(name):
        return np.fromiter((-1 if r[name] is None else r[name]
                            for r in rows), np.int64, n)
    op, a, b = col("struct_op"), col("struct_a"), col("struct_b")
    names = list(ot.ALL_SURFACE_OPS)
    exprs = [r["expression"] for r in rows]
    pos = np.arange(n)
    ok = ((depth > 1) & (op >= 0) & (op < len(names)) & (a >= 0)
          & (a < pos) & (b < pos))
    wrapped = [wrap_operand(s) if d == 1 else s
               for s, d in zip(exprs, depth.tolist())]
    for i, o, ai, bi in zip(*(x[ok].tolist() for x in (pos, op, a, b))):
        if _spelling(names[o], ai, bi, exprs, wrapped) != exprs[i]:
            ok[i] = False
    op[~ok], a[~ok], b[~ok] = -1, -1, -1
    todo = np.flatnonzero(~ok & (depth > 1))
    if not todo.size:
        return op, a, b, 0
    op_id = {name: i for i, name in enumerate(names)}
    raw, wrap = {}, {}
    for i, s in enumerate(exprs[:int(todo[-1]) + 1]):
        if op[i] < 0 and depth[i] > 1:
            t = _triple_of_spelling(s, raw, wrap)
            if t is not None:
                op[i], a[i] = op_id[t[0]], t[1]
                b[i] = -1 if t[2] is None else t[2]
        raw.setdefault(s, i)
        wrap.setdefault(wrapped[i], i)
    spelled = int(np.count_nonzero(op[todo] >= 0))
    return op, a, b, spelled


def _spelling(name: str, a: int, b: int, exprs: List[str],
              wrapped: List[str]) -> str:
    """The forward path's spelling of ``name`` over the rows at ``a`` and
    ``b`` (b -1 for a unary op; ``exprs``: the rows' spellings,
    ``wrapped``: their wrapped operand forms): ``op(a)``, ``op(a, b)``
    or the infix format of ``SURFACE_FORMAT`` over wrapped operands."""
    if b < 0:
        return f"{name}({exprs[a]})"
    fmt = ot.SURFACE_FORMAT.get(name)
    if fmt is None:
        return f"{name}({exprs[a]}, {exprs[b]})"
    p1, rest = fmt.split("{a}")
    mid, p2 = rest.split("{b}")
    return p1 + wrapped[a] + mid + wrapped[b] + p2


def _triple_of_spelling(expr: str, raw: Dict[str, int],
                        wrapped: Dict[str, int]):
    """(op, a uid, b uid or None) of a composed expression from its
    spelling, over the registered spellings (``raw``: expression ->
    uid; ``wrapped``: its wrapped operand form -> uid), or None.  The
    forward path spells ``op(a)``, ``op(a, b)`` and the infix formats of
    ``SURFACE_FORMAT`` over wrapped operands; a split counts only if
    composing its parts gives ``expr`` back."""
    def top_level(s: str, sep: str):
        depth = 0
        for i, ch in enumerate(s):
            depth += (ch == "(") - (ch == ")")
            if depth == 0 and s.startswith(sep, i):
                yield s[:i], s[i + len(sep):]

    head, _, rest = expr.partition("(")
    if head in ot.ALL_SURFACE_OPS and rest.endswith(")"):
        inner = rest[:-1]
        if head in ot.UNARY_OPS:
            if inner in raw:
                return head, raw[inner], None
        else:
            for a, b in top_level(inner, ", "):
                if a in raw and b in raw:
                    return head, raw[a], raw[b]
    if expr.startswith("(") and expr.endswith(")"):
        for op, fmt in ot.SURFACE_FORMAT.items():
            # "(" {a} infix {b} tail
            infix = fmt[fmt.index("{a}") + 3:fmt.index("{b}")]
            tail = fmt[fmt.index("{b}") + 3:]
            for a, rest in top_level(expr[1:], infix):
                b = rest[:len(rest) - len(tail)]
                if (a in wrapped and b in wrapped
                        and fmt.format(a=a, b=b) == expr):
                    return op, wrapped[a], wrapped[b]
    return None


def _top_op_of(expr_str: str) -> str:
    """The surface op that made a stored expression, from its spelling
    (only 'inv' matters, for the prune rules)."""
    for name in ("inv", "neg", "sqrt", "square", "pow_3_2", "pow_neg_3_2",
                 "exp_neg", "exp", "log"):
        if expr_str.startswith(name + "("):
            return name
    return ""
