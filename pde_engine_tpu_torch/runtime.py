"""A persisted discovery run on one torch device: fresh runs and resume.

Counterpart of ``DiscoveryRun`` in ``pde_engine_tpu/runtime.py``.  The run
DB has the JAX package's schema (``python -m pde_engine_tpu --print-run-id``
reads a port run), reject rows go through the native sqlite sink when the
C++ core loads, known solutions are validated first, and each depth
barrier logs one line and writes the generator state, the jet snapshot
(``<db>.jets.d/shard_<lo>_<hi>.npz``) and the registry sidecar
(``<db>.registry.npz`` plus ``<db>.registry.d/part_<lo>_<hi>.npz``), in
the JAX package's file formats.  :meth:`DiscoveryRun.resume` rebuilds a
run from its registry sidecar and continues at the next depth.  Not
ported: the resume that re-parses the run DB (a run without a matching
sidecar), the multi-host registry key shards and the post-hoc audits.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Optional

import numpy as np

from .enumerator import Candidate
from .models.base import Problem, load_problem
from .pipeline import DepthStats, DiscoveryEngine, Row
from .utils.config import SearchConfig
from .utils.db import RunDB, db_path_for, new_run_id
from .utils.report import build_report, format_report_text, write_report_files


class DiscoveryRun:
    """A persisted discovery run (a fresh one, or one attached to an
    existing run DB by :meth:`resume`)."""

    def __init__(self, problem_name, config: Optional[SearchConfig] = None,
                 run_id: Optional[str] = None,
                 db_path: Optional[str] = None, device="cuda",
                 verbose: bool = True, report_families: bool = True):
        self.problem = (problem_name if isinstance(problem_name, Problem)
                        else load_problem(problem_name))
        self.config = config or SearchConfig()
        self.run_id = run_id or new_run_id()
        if db_path:
            self.db_path = db_path
            self.out_dir = os.path.dirname(os.path.abspath(db_path))
        else:
            self.out_dir = self.problem.get_output_dir()
            self.db_path = db_path_for(self.out_dir, self.run_id)
        self.verbose = verbose
        self.report_families = report_families
        self.engine = DiscoveryEngine(self.problem, self.config,
                                      device=device)
        self.db = RunDB(self.db_path, self.run_id)
        # native reject sink: mass reject rows go straight into the run DB
        # through the C++ writer
        self._native_sink = None
        if self.config.use_native is not False:
            from .utils.native import NativeRejectSink, load_core
            if load_core() is not None:
                self._native_sink = NativeRejectSink(self.db_path,
                                                     self.db.table)
                self.engine.native_sink = self._native_sink
            elif self.config.use_native is True:
                raise RuntimeError("use_native=True but the native core "
                                   "failed to build/load")

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
        if start_depth == 1 and not hasattr(self, "_resume_start_depth"):
            self._fresh_cleanup()
        self.db.start_run(max_depth)
        t_start = time.time()
        self._log(f"Run {self.run_id}: {self.problem.name}, "
                  f"max_depth={max_depth}, device={self.engine.device}, "
                  f"db={self.db_path}")
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
            self.db.flush()
            self.db.update_metadata(
                sum(s.candidates for s in self.engine.stats) + st.candidates,
                self.engine.n_rows, len(self.engine.valid_rows))
            self.db.worker_heartbeat(os.getpid(), "device",
                                     self.engine.candidates_screened,
                                     errors=self.engine.errors,
                                     snippet=self.engine.last_expr)

        def on_depth(st):
            # every queued native-sink batch is in the DB before the depth
            # is marked completed
            if self._native_sink is not None:
                self._native_sink.flush()
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
                    str(s.depth): {"generated": s.unique, "valid": s.valid,
                                   "candidates": s.candidates}
                    for s in self.engine.stats},
            })
            self._save_jet_snapshot()
            self._save_registry_sidecar(st.depth)
            self.db.worker_heartbeat(os.getpid(), "device",
                                     self.engine.n_rows,
                                     errors=self.engine.errors)
            rate = (st.candidates / st.seconds) if st.seconds > 0 else 0
            self._log(f"  depth {st.depth}: {st.candidates} candidates, "
                      f"{st.unique} unique, {st.valid} valid "
                      f"[{st.seconds:.1f}s, {rate:,.0f} cand/s | "
                      f"enum {st.t_enum:.1f} dev {st.t_device:.1f} "
                      f"ingest {st.t_ingest:.1f} gray {st.t_gray:.1f}]")

        try:
            self.engine.run(max_depth, on_row=on_row, on_depth=on_depth,
                            start_depth=start_depth, on_batch=on_batch,
                            on_rows=on_rows)
        except KeyboardInterrupt:
            self.db.complete_run("aborted")
            raise
        self.db.flush()
        valid = self.db.rows("is_valid=1")
        report = build_report(
            self.problem, stats=self.engine.stats,
            run_id=self.run_id, max_depth=max_depth,
            classify_novel=(len(self.engine.valid_rows)
                            <= self.config.novel_class_limit),
            by_depth_counts=(
                self.db.depth_counts() if self.config.audit_rejects
                else {s.depth: {"generated": s.unique, "valid": s.valid}
                      for s in self.engine.stats}),
            valid_rows=valid,
            **self._report_extras(valid))
        report["wall_seconds"] = time.time() - t_start
        report["device"] = str(self.engine.device)
        report["device_seconds"] = self.engine.device_seconds
        report["candidates_screened"] = self.engine.candidates_screened
        report["dispatches"] = self.engine.dispatch_counts()
        report["launched_rows"] = self.engine.launched_rows()
        paths = write_report_files(report, self.out_dir)
        self.db.update_metadata(
            sum(s.candidates for s in self.engine.stats)
            or report["total_generated"],
            self.engine.n_rows, report["total_valid"])
        self.db.complete_run("completed")
        self._log(format_report_text(report))
        self._log(f"Reports: {paths['json']}  {paths['txt']}")
        report["report_paths"] = paths
        return report

    def _report_extras(self, valid_rows) -> Dict:
        """Family breakdown of the valid set (utils/families) and, when
        the novel set exceeds the SymPy classing limit, classing limited
        to the non-degenerate 'general' family."""
        if not (self.report_families and valid_rows):
            return {}
        from .utils.families import summarize, tag_rows
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
        costs its delta."""
        if not self.config.snapshot_jets:
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
        load."""
        shutil.rmtree(self._snapshot_dir, ignore_errors=True)

    def _fresh_cleanup(self):
        """A fresh run removes another run's resume state at the same
        db_path (jet shards, registry parts and manifest, key shards), so
        that none of it becomes the delta base of this run's files."""
        import glob
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
        if len(eng.fp_to_uid) != n:
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
            ks, vs = eng.fp_to_uid.items_arrays()
            m = vs >= saved
            keys = np.zeros(n - saved, np.uint64)
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
                     keys_sharded=np.int64(0))
        os.replace(tmp, self._registry_path)

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
               verbose: bool = True,
               report_families: bool = True) -> "DiscoveryRun":
        """Rebuild a run from its registry sidecar and jet snapshot and
        continue it at the next depth (:meth:`continue_run`).  A run with
        no sidecar matching its last completed depth would need the JAX
        package's resume from the DB rows, which is not ported: it
        raises."""
        self = cls(problem_name, config, run_id=run_id, db_path=db_path,
                   device=device, verbose=verbose,
                   report_families=report_families)
        state = self.db.load_generator_state() or {}
        completed = int(state.get("completed_depth", 0))
        self.config.include_special_ops = bool(
            state.get("include_special_ops",
                      self.config.include_special_ops))
        reg = self._load_registry_sidecar()
        if (reg is not None and completed
                and int(reg["completed_depth"]) == completed):
            self._resume_from_registry(reg, state, completed)
            return self
        self.close()
        raise RuntimeError(
            f"run {run_id} has no registry sidecar for its completed depth "
            f"{completed} ({self._registry_path}); resuming it would need "
            "the resume that re-parses the run DB, which the torch port "
            "does not have yet")

    def _resume_from_registry(self, reg, state, completed: int):
        """Rebuild the engine from the registry sidecar: depth-1 rows
        re-parse, composed rows re-register from their structural triples
        (display strings regenerated by the forward composition), the
        dedup map is restored key for key, and the jet cache is seeded
        (``DiscoveryEngine.seed_cache_from_uniques``)."""
        if int(reg.get("keys_sharded", 0)) > 1:
            raise RuntimeError("registry sidecar with per-host key shards "
                               "(a multi-host run); the torch port resumes "
                               "single-device runs only")
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
            if self.config.audit_rejects:
                enum.register_from_struct_compose(op_ids, a_arr, b_arr,
                                                  d_arr)
            else:
                # no reject rows are emitted, and valid rows rebuild their
                # strings lazily from structure: skip regenerating them
                enum.register_from_struct(op_ids, a_arr, b_arr, d_arr,
                                          exprs=None)
                for d in np.unique(d_arr).tolist():
                    enum._dropped_string_depths.add(int(d))
        eng.fp_to_uid.set_batch(np.asarray(reg["keys"], np.uint64),
                                np.arange(n, dtype=np.int64))
        eng.n_rows = int(reg["n_rows"])
        for r in self.db.rows("is_valid=1 AND depth <= ?", (completed,)):
            eng.valid_rows.append(Row(
                id=int(r["id"]), expression=r["expression"],
                normalized=r["normalized"] or r["expression"],
                signature=r["signature"] or "",
                depth=int(r["depth"]), is_valid=True,
                validation_reason=r["validation_reason"] or "",
                validator_method=r["validator_method"] or "",
                is_paper_solution=bool(r["is_paper_solution"]),
                paper_solution_name=r["paper_solution_name"]))
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

    def close(self):
        if self._native_sink is not None:
            self._native_sink.close()
            self._native_sink = None
        self.engine._gray_pool.shutdown(wait=True)
        self.db.close()
