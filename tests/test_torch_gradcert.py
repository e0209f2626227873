"""The gradient certificate (``ops/gradcert.py``) and the heavy checks it
decides.

On the CPU: enclosures of tapes written row by row through the
``ops.optable`` surface operations (``problem.parse`` would let SymPy fold
a planted constant to 0 before it becomes a tape); then whole
``--heavy-checks`` runs in processes of their own with
``PDE_INGEST_TIMERS`` set, for the ``heavy.*`` counters: laplace to depth
4 with the certificate and with ``pipeline._CERTIFIED_CHECKS`` emptied
by monkeypatch, which store the same rows; force_free to depth 3, whose
heavy checks never reach the certificate; and laplace to depth 3 with
every passer finalised screen-tagged, which keeps SymPy.

This file imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest

from pde_engine_tpu_torch import pipeline
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.ops import gradcert
from pde_engine_tpu_torch.ops import optable as ot
from pde_engine_tpu_torch.ops.tape import ConstTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = load_problem("laplace").screen_points


class _Tape:
    """Rows of one tape, written through the surface operations."""

    def __init__(self):
        self.rows = []
        self.consts = ConstTable()

    def X(self):
        return ot._emit(self.rows, ot.VAR0)

    def Y(self):
        return ot._emit(self.rows, ot.VAR1)

    def c(self, v):
        return ot._emit(self.rows, ot.CONST, 0,
                        self.consts.intern(Fraction(v)))

    def log(self, a):
        return ot._emit(self.rows, ot.LOG, a)

    def __getattr__(self, name):
        op = ot.ALL_SURFACE_OPS[name]
        return lambda *regs: op.emit(self.rows, self.consts.intern, *regs)


def _trap(t):
    e = t.exp(t.exp(t.exp(t.X())))
    return t.sub(t.add(e, t.c(1)), e)


def _x_inv_x(t):
    x = t.X()
    return t.sub(t.c(1), t.mul(x, t.inv(x)))


def _exp_minus_exp(t):
    x = t.X()
    return t.sub(t.exp(x), t.exp(x))


UNDECIDED = {
    # planted constants
    "log_mul(X, ((Y + 1) - Y))": lambda t: t.log_mul(
        t.X(), t.sub(t.add(t.Y(), t.c(1)), t.Y())),
    "1 - (X * inv(X))": _x_inv_x,
    "exp(X) - exp(X)": _exp_minus_exp,
    "(X + 1) - X": lambda t: t.sub(t.add(t.X(), t.c(1)), t.X()),
    # a cancellation trap: exp(exp(exp(X))) absorbs the 1
    "(exp(exp(exp(X))) + 1) - exp(exp(exp(X)))": _trap,
    # domain edges
    "log(X - X)": lambda t: t.log(t.sub(t.X(), t.X())),
    "log(X - 2)": lambda t: t.log(t.sub(t.X(), t.c(2))),
    "sqrt(Y - Y)": lambda t: t.sqrt(t.sub(t.Y(), t.Y())),
    "sqrt(0.1 - X)": lambda t: t.sqrt(t.sub(t.c(Fraction(1, 10)), t.X())),
    "pow_neg_3_2(Y - Y)": lambda t: t.pow_neg_3_2(t.sub(t.Y(), t.Y())),
    "inv(X - X)": lambda t: t.inv(t.sub(t.X(), t.X())),
    "X * inv(Y - Y)": lambda t: t.mul(t.X(), t.inv(t.sub(t.Y(), t.Y()))),
    # overflow at every point
    "exp(exp(exp(exp(exp(X)))))": lambda t: t.exp(
        t.exp(t.exp(t.exp(t.exp(t.X()))))),
}

CERTIFIED = {
    "X": lambda t: t.X(),
    "X*Y": lambda t: t.mul(t.X(), t.Y()),
    "log(X**2 + Y**2)": lambda t: t.log(t.add(t.square(t.X()),
                                              t.square(t.Y()))),
    "Y*exp_neg(X)": lambda t: t.mul(t.Y(), t.exp_neg(t.X())),
    "square(X) - square(Y)": lambda t: t.sub(t.square(t.X()),
                                             t.square(t.Y())),
    "geom_sum(Y, X)": lambda t: t.geom_sum(t.Y(), t.X()),
    "pow_3_2(X) + pow_neg_3_2(Y)": lambda t: t.add(t.pow_3_2(t.X()),
                                                   t.pow_neg_3_2(t.Y())),
    "sqrt_shift_neg(X, Y)": lambda t: t.sqrt_shift_neg(t.X(), t.Y()),
    "neg(inv(X))": lambda t: t.neg(t.inv(t.X())),
    # log(X - 1) leaves its domain at the points where X < 1 only
    "log(X - 1)": lambda t: t.log(t.sub(t.X(), t.c(1))),
    "square(Y - 1)": lambda t: t.square(t.sub(t.Y(), t.c(1))),
}


def _tape(build):
    t = _Tape()
    build(t)
    return np.array(t.rows, np.int32), t.consts.values


def _certify_one(build) -> bool:
    rows, consts = _tape(build)
    return bool(gradcert.certify(rows[None], np.array([len(rows)]),
                                 consts, POINTS)[0])


@pytest.mark.parametrize("name", sorted(UNDECIDED))
def test_constant_or_out_of_domain_rows_stay_undecided(name):
    assert not _certify_one(UNDECIDED[name])


@pytest.mark.parametrize("name", sorted(CERTIFIED))
def test_non_constant_rows_are_certified(name):
    assert _certify_one(CERTIFIED[name])


def test_a_padded_batch_certifies_each_row_as_alone():
    """Rows of many lengths in one batch, NOP-padded, one shared constant
    table: each row's bit is its bit alone."""
    cases = [UNDECIDED[k] for k in sorted(UNDECIDED)] + \
        [CERTIFIED[k] for k in sorted(CERTIFIED)]
    t_all = _Tape()
    tapes = []
    for build in cases:
        t = _Tape()
        t.consts = t_all.consts
        build(t)
        tapes.append(np.array(t.rows, np.int32))
    L = max(len(t) for t in tapes)
    batch = np.zeros((len(tapes), L, 3), np.int32)
    for i, t in enumerate(tapes):
        batch[i, :len(t)] = t
    got = gradcert.certify(batch, np.array([len(t) for t in tapes]),
                           t_all.consts.values, POINTS)
    assert got.tolist() == [False] * len(UNDECIDED) + [True] * len(CERTIFIED)


@pytest.mark.parametrize("n,L", [(1300, 25), (700, 2000), (3, 3)])
def test_sub_batches_keep_to_512_rows(monkeypatch, n, L):
    seen = []
    real = gradcert._certify_block

    def block(tapes, lengths, cb, points):
        seen.append(tapes.shape[:2] + points.shape[:1])
        return real(tapes, lengths, cb, points)
    monkeypatch.setattr(gradcert, "_certify_block", block)
    rows, consts = _tape(CERTIFIED["X*Y"])
    tapes = np.zeros((n, L, 3), np.int32)
    tapes[:, :len(rows)] = rows
    out = gradcert.certify(tapes, np.full(n, len(rows)), consts, POINTS)
    assert out.all() and sum(s[0] for s in seen) == n
    for k, width, n_points in seen:
        assert k <= gradcert.MAX_ROWS == 512
        assert width == len(rows)


@pytest.mark.parametrize("slug", ["force_free", "kerr", "laplace",
                                  "grad_shafranov"])
def test_only_laplace_heavy_check_is_decided(slug):
    check = load_problem(slug).heavy_checks.__func__
    assert (check in pipeline._CERTIFIED_CHECKS) == (slug == "laplace")


_RUN = r"""
import dataclasses, json, sqlite3, sys, tempfile
import numpy as np
import pytest
import torch
torch.set_num_threads(1)
from pde_engine_tpu_torch import pipeline
from pde_engine_tpu_torch.ops import gradcert
from pde_engine_tpu_torch.runtime import DiscoveryRun
from pde_engine_tpu_torch.utils.config import SearchConfig
out, problem, depth, mode, skip = (sys.argv[1], sys.argv[2],
                                   int(sys.argv[3]), sys.argv[4],
                                   float(sys.argv[5]))
mp = pytest.MonkeyPatch()
if mode == "empty":
    mp.setattr(pipeline, "_CERTIFIED_CHECKS", frozenset())
if mode == "trap":
    def trap(*a, **k):
        raise AssertionError("the certificate ran")
    mp.setattr(gradcert, "certify", trap)
with tempfile.TemporaryDirectory() as d:
    run = DiscoveryRun(problem, SearchConfig(
        max_depth=depth, defer_heavy_checks=False, f64_skip_below=skip),
        device="cpu", db_path=d + "/run.db", report_families=False)
    try:
        run.run(depth)
    finally:
        run.close()
    con = sqlite3.connect(d + "/run.db")
    table = [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='table' "
        "AND name LIKE 'expressions_%'")][0]
    rows = con.execute(
        f"SELECT id, is_valid, validation_reason, heavy_is_valid, "
        f"heavy_reason FROM {table} ORDER BY id").fetchall()
    con.close()
stats = run.engine.stats
counts = {}
for s in stats:
    for k, v in s.counts.items():
        counts[k] = counts.get(k, 0) + v
res = {"rows": rows, "counts": counts,
       "depths": [[s.depth, s.candidates, s.unique, s.valid] for s in stats],
       "certify_threads": sorted({e[4] for s in stats for e in s.span_events
                                  if e[0] == "gray.certify"}),
       "certify_parents": sorted({e[3] for s in stats for e in s.span_events
                                  if e[0] == "gray.certify"})}
heavy = [r for r in rows if r[3] is not None]
if heavy and mode == "empty":
    eng = run.engine
    uids = np.array([r[0] - 1 for r in heavy], np.int64)
    tapes, lengths = eng.enumerator.tapes_batch(uids)
    cert = gradcert.certify(tapes, lengths, eng.problem.consts.values,
                            eng.problem.screen_points)
    res["certified_sympy"] = [[bool(c), r[3], r[4]]
                              for c, r in zip(cert, heavy)]
json.dump(res, open(out, "w"))
"""


def _run(tmp, problem: str, depth: int, mode: str, skip: float = 0.0):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), PDE_INGEST_TIMERS="1")
    out = str(tmp / f"{problem}_{depth}_{mode}.json")
    r = subprocess.run([sys.executable, "-c", _RUN, out, problem,
                        str(depth), mode, str(skip)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def laplace(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("laplace")
    return {mode: _run(tmp, "laplace", 4, mode) for mode in ("cert", "empty")}


@pytest.fixture(scope="module")
def force_free(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("force_free")
    return {mode: _run(tmp, "force_free", 3, mode)
            for mode in ("trap", "empty")}


def test_laplace_rows_equal_the_sympy_only_run(laplace):
    """Every row's verdict, reason and heavy verdict, and the depth
    counts, are those of the run whose heavy checks all take SymPy."""
    cert, sympy_only = laplace["cert"], laplace["empty"]
    assert cert["depths"] == sympy_only["depths"]
    assert len(cert["rows"]) == len(sympy_only["rows"]) > 60000
    assert cert["rows"] == sympy_only["rows"]


def test_laplace_counters_and_span(laplace):
    """Depth 4: 1,612 rows certified, the 10 that SymPy rejects as a zero
    gradient left to it; the emptied table sends all 1,622 to SymPy."""
    c, e = laplace["cert"]["counts"], laplace["empty"]["counts"]
    assert (c.get("heavy.certified", 0), c.get("heavy.sympy", 0)) == \
        (1612, 10)
    assert (e.get("heavy.certified", 0), e.get("heavy.sympy", 0)) == \
        (0, 1622)
    rejects = [r for r in laplace["cert"]["rows"]
               if r[3] == 0 and r[4].startswith("Zero gradient")]
    assert len(rejects) == 10
    assert len(laplace["cert"]["certify_threads"]) == 1
    assert laplace["cert"]["certify_threads"][0].startswith("gray_")
    assert laplace["cert"]["certify_parents"] == ["gray.numeric"]
    assert laplace["empty"]["certify_threads"] == []


def test_a_certified_row_is_never_rejected_by_sympy(laplace):
    """Over every row that reaches the heavy checks to depth 4, SymPy
    passes each row the certificate proves non-constant; it rejects
    exactly the rows left undecided."""
    pairs = laplace["empty"]["certified_sympy"]
    assert len(pairs) == 1622
    assert all(ok == 1 and reason == "ok"
               for certified, ok, reason in pairs if certified)
    assert all(ok == 0 for certified, ok, _ in pairs if not certified)


def test_force_free_heavy_checks_bypass_the_certificate(force_free):
    """force_free's heavy checks (the axis first) never call the
    certificate; every row takes SymPy and is stored as without it."""
    trap, sympy_only = force_free["trap"], force_free["empty"]
    n_heavy = sum(r[3] is not None for r in trap["rows"])
    assert n_heavy > 1000
    assert trap["counts"].get("heavy.certified", 0) == 0
    assert trap["counts"]["heavy.sympy"] == n_heavy
    assert trap["certify_threads"] == []
    assert trap["rows"] == sympy_only["rows"]
    assert trap["depths"] == sympy_only["depths"]


def test_screen_tagged_passers_keep_sympy(tmp_path):
    """With every screen passer finalised in ``ingest.passers``
    (``f64_skip_below=1``), laplace's heavy checks all take SymPy."""
    res = _run(tmp_path, "laplace", 3, "cert", skip=1.0)
    n_heavy = sum(r[3] is not None for r in res["rows"])
    assert n_heavy > 100
    assert res["counts"].get("heavy.certified", 0) == 0
    assert res["counts"]["heavy.sympy"] == n_heavy


def test_a_wrapper_of_the_recheck_still_runs(monkeypatch, tmp_path):
    """``_gray_numeric`` keeps its three arrays ``(const64, finite,
    relmax)``, so a wrapper that unpacks them runs; the gray worker's job
    certifies the rows whatever the wrapper passes."""
    from pde_engine_tpu_torch.runtime import DiscoveryRun
    from pde_engine_tpu_torch.utils.config import SearchConfig
    orig = pipeline.DiscoveryEngine._gray_numeric
    seen = []

    def wrapped(self, part):
        const64, finite, relmax = orig(self, part)
        seen.append(len(part))
        return const64, finite, relmax
    monkeypatch.setattr(pipeline.DiscoveryEngine, "_gray_numeric", wrapped)
    calls = []
    real = gradcert.certify

    def counting(tapes, *a):
        calls.append(len(tapes))
        return real(tapes, *a)
    monkeypatch.setattr(gradcert, "certify", counting)
    run = DiscoveryRun("laplace", SearchConfig(
        max_depth=3, defer_heavy_checks=False), device="cpu",
        db_path=str(tmp_path / "run.db"), report_families=False)
    try:
        run.run(3)
    finally:
        run.close()
    assert seen and calls
    assert sum(calls) >= sum(s.valid for s in run.engine.stats) > 100
