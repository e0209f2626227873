"""A finished gray chunk finalised as arrays
(``pipeline.DiscoveryEngine._emit_gray_part``): one known-fingerprint test
for the chunk's rows (``_match_known_rows``) and one display-string fetch
(``pipeline._fill_exprs``), held to the per-row code they replace, which
this file keeps as the reference (``match_known_per_row``,
``emit_per_row``).

On the CPU: the gray chunks of whole port runs (force_free's default path
to depth 3; laplace and force_free with heavy checks), captured as the
run emits them and emitted again by both versions on the same engine;
hand-made rows for the known test; every uid of a run for the string
fetch, with and without the native arena.

This file imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from pde_engine_tpu_torch import pipeline
from pde_engine_tpu_torch.enumerator import Candidate
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.utils import native, spans
from pde_engine_tpu_torch.utils.config import SearchConfig


# ---------------------------------------------------------------------------
# the per-row reference
# ---------------------------------------------------------------------------

def match_known_per_row(eng, cand, fp_vals):
    """The known test of one row, a loop over the knowns."""
    import sympy as sp
    v = np.asarray(fp_vals, dtype=np.float64)
    for name, kv in eng._known_fp.items():
        denom = np.abs(kv) + 1.0
        if np.max(np.abs(v - kv) / denom) < 1e-3:
            try:
                u = eng.problem.tape_to_sympy(cand.tape)
                if sp.simplify(u - eng._known_sympy[name]) == 0:
                    return name
            except Exception:
                continue
    return None


def emit_per_row(eng, part, res, depth, st, on_row):
    """A finished gray chunk's rows one at a time, each valid row's known
    test inside ``_finalize_pass`` (``eng._match_known`` is the caller's)
    and each display string read lazily."""
    const64, finite, relmax, cert = res
    for j, (cand, ev, key) in enumerate(part):
        if const64[j]:
            eng._add_row(cand, depth, False, eng._R_CONST,
                         "screen+f64", ev, on_row, key=key)
        elif finite[j] and relmax[j] < eng.confirm_rtol:
            eng._finalize_pass(cand, ev, float(relmax[j]),
                               "screen+f64", depth, st, on_row,
                               key, bool(cert[j]))
        else:
            eng._add_row(
                cand, depth, False,
                f"Invalid (f64 recheck relres ≈ {relmax[j]:.2e})",
                "screen+f64", ev, on_row, key=key)


# ---------------------------------------------------------------------------
# captured runs
# ---------------------------------------------------------------------------

class _Run:
    """A finished CPU run of the port and the gray chunks it emitted:
    ``(rows, res, depth)``, a row ``(uid, expr set before the emit or
    None, the candidate if not a _Passer, ev, key)``."""

    def __init__(self, slug, depth, **kw):
        self.eng = eng = pipeline.DiscoveryEngine(
            load_problem(slug), SearchConfig(max_depth=depth, **kw),
            device="cpu")
        self.chunks = []
        emit = eng._emit_gray_part

        def capture(part, res, d, st, on_row):
            self.chunks.append((
                [(c.uid, c._expr, None, ev, key)
                 if type(c) is pipeline._Passer else
                 (c.uid, None, c, ev, key) for c, ev, key in part],
                tuple(np.array(a) for a in res), d))
            return emit(part, res, d, st, on_row)
        eng._emit_gray_part = capture
        eng.run(depth)
        del eng._emit_gray_part
        self.valid = [r.paper_solution_name for r in eng.valid_rows]

    def part(self, rows, strings=True):
        """Fresh candidates of a captured chunk: new ``_Passer``s with
        the display string they had before the emit, or (``strings``
        False) with none, as the ingest leaves them beside the native
        reject sink."""
        out = []
        for uid, expr, cand, ev, key in rows:
            if cand is None:
                cand = pipeline._Passer(self.eng.enumerator, uid)
                cand._expr = expr if strings else None
            out.append((cand, ev, key))
        return out

    def replay(self, emit, chunks=None, strings=True):
        """Emit the chunks again from a clean row state; what each
        observable of the emit ends as."""
        eng = self.eng
        eng.rows, eng.valid_rows, eng.n_rows, eng.last_expr = [], [], 0, ""
        eng.errors = 0
        seen, stats = [], {}
        for rows, res, depth in self.chunks if chunks is None else chunks:
            st = stats.setdefault(depth, pipeline.DepthStats(depth=depth))
            emit(self.part(rows, strings), res, depth, st, seen.append)
        return {"on_row": _dicts(seen), "rows": _dicts(eng.rows),
                "valid_rows": _dicts(eng.valid_rows),
                "valid": {d: st.valid for d, st in stats.items()},
                "n_rows": eng.n_rows, "last_expr": eng.last_expr,
                "errors": eng.errors}


def _dicts(rows):
    return [dataclasses.asdict(r) for r in rows]


@pytest.fixture(scope="module")
def runs():
    return {
        "force_free": _Run("force_free", 3),
        "laplace.heavy": _Run("laplace", 4, defer_heavy_checks=False),
        "force_free.heavy": _Run("force_free", 3, defer_heavy_checks=False),
        "force_free.python": _Run("force_free", 3, use_native=False),
    }


def _per_row(run, monkeypatch, chunks=None, strings=True):
    with monkeypatch.context() as m:
        m.setattr(run.eng, "_match_known",
                  lambda cand, fp: match_known_per_row(run.eng, cand, fp))
        return run.replay(lambda *a: emit_per_row(run.eng, *a), chunks,
                          strings)


def _valid_rows(run):
    """(candidates, fingerprint values) of every row of the run's chunks
    that passes the float64 recheck."""
    cands, fps = [], []
    for rows, (const64, finite, relmax, _), _ in run.chunks:
        part = run.part(rows)
        for j in np.flatnonzero(~const64 & finite
                                & (relmax < run.eng.confirm_rtol)):
            cands.append(part[j][0])
            fps.append(part[j][1]["fp_vals"])
    return cands, fps


# ---------------------------------------------------------------------------
# the known test
# ---------------------------------------------------------------------------

def test_known_test_matches_the_per_row_loop_on_a_depth_3_run(runs):
    """Every valid row of force_free's default path to depth 3 gets the
    known, or None, that the per-row loop gives it; the knowns found are
    the run's own."""
    run = runs["force_free"]
    cands, fps = _valid_rows(run)
    assert len(cands) == len(run.valid) == 2250
    batch = run.eng._match_known_rows(cands, fps)
    assert batch == [match_known_per_row(run.eng, c, v)
                     for c, v in zip(cands, fps)]
    assert batch == run.valid
    assert len(run.eng._known_fp) == 7
    assert {n for n in batch if n} == {"Parabolic", "Vertical field",
                                       "X-point"}
    # the single-row entry, as the screen passers' path calls it
    some = [i for i, n in enumerate(batch) if n] + list(range(64))
    assert [run.eng._match_known(cands[i], fps[i]) for i in some] == \
        [batch[i] for i in some]


def _engine(monkeypatch, knowns):
    """A force_free engine whose known solutions are ``knowns``."""
    problem = load_problem("force_free")
    monkeypatch.setattr(problem, "known_solutions", knowns)
    return pipeline.DiscoveryEngine(problem, SearchConfig(max_depth=1),
                                    device="cpu")


def _cand(eng, expr):
    return Candidate(depth=3, expr_str=expr, top_op="", has_var=True,
                     tape=eng.problem.parse(expr), consts=eng.problem.consts)


def _both(eng, cands, fps):
    batch = eng._match_known_rows(cands, fps)
    assert batch == [match_known_per_row(eng, c, v)
                     for c, v in zip(cands, fps)]
    return batch


def test_nan_and_inf_fingerprint_values_match_no_known(runs):
    eng = runs["force_free"].eng
    name, kv = next(iter(eng._known_fp.items()))
    expr = next(e for e, n in eng.problem.known_solutions.items()
                if n == name)
    rows = []
    for bad in (np.nan, np.inf, -np.inf):
        v = kv.astype(np.float32)
        v[3] = bad
        rows.append(v)
    rows.append(np.full_like(rows[0], np.nan))
    rows.append(kv.astype(np.float32))
    assert _both(eng, [_cand(eng, expr)] * len(rows), rows) == \
        [None] * (len(rows) - 1) + [name]


def test_a_row_near_two_knowns_takes_the_first_that_sympy_confirms(
        monkeypatch):
    """The knowns pass the tolerance test together (their values differ
    by 1e-4 relative at most); for ``z`` SymPy rejects the first and
    confirms the second and the third, and the second wins."""
    eng = _engine(monkeypatch, {"z*(10001/10000)": "near", "z": "exact",
                                "(z + z)/2": "twice"})
    assert list(eng._known_fp) == ["near", "exact", "twice"]
    kn, ke = eng._known_fp["near"], eng._known_fp["exact"]
    assert np.max(np.abs(kn - ke) / (np.abs(ke) + 1)) < 1e-3
    cands = [_cand(eng, "z"), _cand(eng, "z*(10001/10000)"),
             _cand(eng, "rho")]
    fps = [ke.astype(np.float32), kn.astype(np.float32),
           ke.astype(np.float32)]
    assert _both(eng, cands, fps) == ["exact", "near", None]


class _Unreadable:
    """A row whose tape SymPy cannot read."""

    @property
    def tape(self):
        raise ValueError("no tape")


def test_a_row_whose_sympy_form_raises_matches_no_known_alone(monkeypatch):
    eng = _engine(monkeypatch, {"z*(10001/10000)": "near", "z": "exact"})
    ke = eng._known_fp["exact"].astype(np.float32)
    assert _both(eng, [_Unreadable(), _cand(eng, "z"), _Unreadable()],
                 [ke, ke, ke]) == [None, "exact", None]


def test_a_problem_with_no_knowns(monkeypatch, runs):
    eng = _engine(monkeypatch, {})
    assert eng._known_fp == {}
    fp = np.zeros(len(eng.problem.fingerprint_points) * 3, np.float32)
    assert _both(eng, [_cand(eng, "z")] * 3, [fp] * 3) == [None] * 3
    assert eng._match_known_rows([], []) == []
    # the chunks of a run emit as before on an engine without knowns
    run = runs["force_free"]
    with monkeypatch.context() as m:
        m.setattr(run.eng, "_known_fp", {})
        new = run.replay(run.eng._emit_gray_part)
        old = _per_row(run, m)
    assert new == old
    assert not any(r["is_paper_solution"] for r in new["rows"])


def test_the_counters_say_how_many_rows_reach_sympy(monkeypatch, runs):
    run = runs["force_free"]
    cands, fps = _valid_rows(run)
    monkeypatch.setattr(spans, "ON", True)
    spans.drain(None)
    run.eng._match_known_rows(cands, fps)
    st = pipeline.DepthStats(depth=3)
    spans.drain(st)
    near = sum(any(np.max(np.abs(np.asarray(v, np.float64) - kv)
                          / (np.abs(kv) + 1)) < 1e-3
                   for kv in run.eng._known_fp.values()) for v in fps)
    assert st.counts == {"known.tested": 2250, "known.near": near}
    assert 8 <= near < 2250


# ---------------------------------------------------------------------------
# the chunk's emit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strings", [True, False],
                         ids=["strings_set", "strings_fetched"])
@pytest.mark.parametrize("name", ["force_free", "laplace.heavy",
                                  "force_free.heavy", "force_free.python"])
def test_chunk_emit_equals_the_per_row_emit(runs, monkeypatch, name,
                                            strings):
    """Every field of every row, the ``on_row`` order, each depth's valid
    count, the valid rows, the row count and the last expression."""
    run = runs[name]
    new = run.replay(run.eng._emit_gray_part, strings=strings)
    assert new == _per_row(run, monkeypatch, strings=strings)
    assert new["valid_rows"] and new["on_row"] == new["rows"]
    if name == "force_free.heavy":
        # force_free's heavy check is SymPy's, and rejects rows here
        assert any(r["heavy_is_valid"] is False and not r["is_valid"]
                   for r in new["rows"])


def test_chunk_emit_with_sympy_heavy_rows_and_demotions(runs, monkeypatch):
    """laplace's chunks, with the certificate taken from every third
    valid row (SymPy's heavy check decides it) and with the rows its
    zero-row decision made constant let through as valid, uncertified:
    the heavy check demotes them."""
    run = runs["laplace.heavy"]
    chunks, n_zero = [], 0
    for rows, (const64, finite, relmax, cert), d in run.chunks:
        cert = cert.copy()
        ok = np.flatnonzero(~const64 & finite
                            & (relmax < run.eng.confirm_rtol))
        cert[ok[::3]] = False
        zero = const64 & finite & (relmax < run.eng.confirm_rtol)
        n_zero += int(zero.sum())
        chunks.append((rows, (const64 & ~zero, finite, relmax, cert), d))
    assert n_zero
    new = run.replay(run.eng._emit_gray_part, chunks, strings=False)
    assert new == _per_row(run, monkeypatch, chunks, strings=False)
    heavy = [r for r in new["rows"] if r["heavy_is_valid"] is not None]
    assert any(r["heavy_is_valid"] is False and not r["is_valid"]
               for r in heavy)
    assert any(r["heavy_is_valid"] and r["is_valid"] for r in heavy)


def test_chunk_emit_without_audit(monkeypatch):
    """A no-audit run keeps only valid rows and counts the rest."""
    run = _Run("laplace", 3, audit_rejects=False)
    new = run.replay(run.eng._emit_gray_part)
    assert new == _per_row(run, monkeypatch)
    assert new["n_rows"] > len(new["rows"]) > 0


# ---------------------------------------------------------------------------
# the string fetch
# ---------------------------------------------------------------------------

def _check_strings(enum, uids, preset=None):
    """Fill fresh ``_Passer``s of ``uids`` (``preset``: their ``_expr``
    before the fill) and a row of another kind; each string then equals
    ``expr_str_of``'s byte for byte.  The rows the fill left lazy."""
    preset = preset or {}
    cands = [pipeline._Passer(enum, u) for u in uids]
    for c in cands:
        c._expr = preset.get(c.uid)
    pipeline._fill_exprs(enum, cands + [object()])
    lazy = [c.uid for c in cands if c._expr is None]
    for c in cands:
        want = preset.get(c.uid) or enum.expr_str_of(c.uid)
        assert c.expr_str.encode() == want.encode()
    return cands, lazy


def test_strings_from_the_arena_equal_expr_str_of(runs):
    """Arena-backed uids, uids with an ``expr_strs`` entry, and rows whose
    ``_expr`` is set already; one fetch, in any order of uids."""
    enum = runs["force_free"].eng.enumerator
    assert enum.arena is not None
    n = len(enum.arena)
    uids = np.random.default_rng(0).permutation(n).tolist()
    set_ = [u for u in range(n) if enum.expr_strs[u] is not None]
    over = uids[:5]
    old = {u: enum.expr_strs[u] for u in over}
    try:
        for u in over:
            enum.expr_strs[u] = f"override_{u}"
        cands, lazy = _check_strings(enum, uids, {uids[7]: "already set"})
    finally:
        for u, s in old.items():
            enum.expr_strs[u] = s
    assert [c._expr for c in cands[:5]] == [f"override_{u}" for u in over]
    assert cands[7]._expr == "already set"
    assert len(set_) < n and lazy == []


def test_strings_past_the_arena_keep_the_lazy_path():
    """A uid the arena no longer holds is spelt from its structure, as
    ``expr_str_of`` does."""
    run = _Run("force_free", 2)
    enum = run.eng.enumerator
    n = len(enum.arena)
    enum.arena.truncate(n - 20)
    _, lazy = _check_strings(enum, range(n))
    assert lazy == [u for u in range(n - 20, n) if enum.expr_strs[u] is None]
    assert lazy


def test_strings_without_the_native_core(monkeypatch):
    """``PDE_ENGINE_NO_NATIVE``: no arena, the Python list of strings."""
    monkeypatch.setenv("PDE_ENGINE_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_core", None)
    monkeypatch.setattr(native, "_core_tried", False)
    run = _Run("force_free", 3)
    enum = run.eng.enumerator
    assert enum.arena is None
    _, lazy = _check_strings(enum, range(len(enum.expr_strs)))
    assert lazy == [u for u in range(len(enum.expr_strs))
                    if enum.expr_strs[u] is None]
    # the ingest set each passer's string (the Python-list path)
    passers = [expr for rows, _, _ in run.chunks
               for _, expr, cand, _, _ in rows if cand is None]
    assert passers and None not in passers
    assert run.replay(run.eng._emit_gray_part) == _per_row(run, monkeypatch)
