"""The tape engine and the tape interpreter of the port, against the JAX
package on the CPU.

- ``ops/interpreter.batched_evaluator`` (torch) against the JAX
  ``batched_evaluator`` and the float64 oracle on the batch of
  ``tests/test_jets.py::test_jax_interpreter_matches_np`` (force_free's
  knowns and five more expressions): after scaling each coefficient by
  max(|jet|, 1), within 3e-5 of either, the tolerance that test uses
  (float32 against float64; XLA may contract FMAs where torch rounds
  twice).  A NaN of a branch the opcode does not select never reaches
  the result.
- ``parallel.search.make_search_kernel_raw`` against the JAX one on the
  same tapes: every verdict flag and both fingerprint hashes equal,
  ``rel_max`` equal within 1e-4 relative where it is above 1e-3, and
  under 1e-6 on both sides where either is (the knowns: roundoff of a
  zero residual).  The library smoke of the verify skill: the seven
  knowns under 1e-6, ``rho*z`` about 0.78.
- ``SearchConfig(engine="tape")`` to depth 3 against the JAX tape
  engine: equal counts (9,835 / 6,665 / 1,474 at depth 3), equal key
  sets and knowns, the cache rows on the engine's device.  Both sides
  key each candidate from its whole tape evaluated by the float64
  oracle, so the keys are exact.
- Why the tape engine's counts are not the incremental engine's (9,965 /
  8,976 / 2,153 on the port, 9,965 / 8,977 / 2,152 in the JAX package):
  the incremental path keys a candidate from float32 jets composed on
  its parents' cache rows, whose fingerprint jets are snapped to a
  12-bit significand, so one function reached by two routes can land in
  two cells.  Measured in ``test_tape_and_incremental_counts_classified``.
"""

import hashlib

import numpy as np
import pytest
import sympy as sp
import torch

from pde_engine_tpu.models import load_problem as jax_load_problem
from pde_engine_tpu.utils.config import SearchConfig as JaxSearchConfig
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.ops import tape as tp
from pde_engine_tpu_torch.ops.interpreter import (batched_evaluator,
                                                  eval_jets_np)
from pde_engine_tpu_torch.utils.config import SearchConfig

JET_ATOL = 3e-5
REL_RTOL = 1e-4
MAX_NODES = 32
RHO = sp.Symbol("rho", real=True, positive=True)
Z = sp.Symbol("z", real=True)
# tests/test_jets.py's batch
KNOWN_FF = [
    RHO**2,
    RHO**2 * Z,
    1 - Z / sp.sqrt(RHO**2 + Z**2),
    RHO**2 / (RHO**2 + Z**2) ** sp.Rational(3, 2),
    sp.sqrt(RHO**2 + Z**2) - Z,
    sp.sqrt(Z**2 + (RHO - 1) ** 2) - sp.sqrt(Z**2 + (RHO + 1) ** 2),
    RHO**2 * sp.exp(-2 * Z),
]
EXTRA = [
    sp.log(RHO) * Z,
    sp.exp(RHO * Z) / (RHO + Z),
    (RHO + Z) ** sp.Rational(-3, 2),
    RHO / (1 - Z),
    sp.Rational(1, 3) * RHO + 2,
]
POINTS = np.array([[0.8, 6 / 7], [0.5, 0.31], [1.2, 0.9]])
# force_free strings for the search kernel: the knowns, the smoke's
# rho*z, domain violations (log and sqrt of negatives, 1/0 at z = 1 is
# not a point), a constant and a product whose log branch is NaN
SEARCH_EXTRA = ["rho*z", "log(rho)*z", "sqrt(z - 2)", "exp(rho*z)/(rho+z)",
                "rho/(1-z)", "1", "(rho-2)*z", "log(z - 2)"]
TAPE_D3 = [(5, 5, 4), (168, 151, 91), (9835, 6665, 1474)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jets_batch():
    consts = tp.ConstTable()
    tapes, lengths = [], []
    for expr in KNOWN_FF + EXTRA:
        t = tp.from_sympy(expr, consts, (RHO, Z))
        tapes.append(t.padded(MAX_NODES))
        lengths.append(len(t))
    return (np.stack(tapes), np.array(lengths, dtype=np.int32), consts)


def _scaled_close(got, want):
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=JET_ATOL)


@pytest.mark.parametrize("order", [1, 2, 4])
def test_batched_evaluator_matches_oracle(order):
    tapes, lengths, consts = _jets_batch()
    carr = consts.as_array(np.float32, pad_to=8)
    run = batched_evaluator(order, MAX_NODES)
    got = run(torch.from_numpy(tapes), torch.from_numpy(lengths),
              torch.from_numpy(carr),
              torch.as_tensor(POINTS, dtype=torch.float32))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    for n in range(len(tapes)):
        want = eval_jets_np(tapes[n], lengths[n], consts.as_array(),
                            POINTS, order)
        _scaled_close(got[n], want)


def test_batched_evaluator_matches_jax():
    import jax.numpy as jnp
    from pde_engine_tpu.ops.interpreter import batched_evaluator as jax_be
    tapes, lengths, consts = _jets_batch()
    carr = consts.as_array(np.float32, pad_to=8)
    want = np.asarray(jax_be(4, MAX_NODES)(
        jnp.asarray(tapes), jnp.asarray(lengths), jnp.asarray(carr),
        jnp.asarray(POINTS, np.float32)))
    got = batched_evaluator(4, MAX_NODES)(
        torch.from_numpy(tapes), torch.from_numpy(lengths),
        torch.from_numpy(carr),
        torch.as_tensor(POINTS, dtype=torch.float32)).numpy()
    assert got.shape == want.shape == (len(tapes), len(POINTS), 15)
    _scaled_close(got, want)


def test_batched_evaluator_discards_unselected_nans():
    """``(rho - 2) * z`` computes log and sqrt of a negative value at its
    SUB node (unselected branches): the result stays finite.
    ``sqrt(z - 2)`` selects one: NaN.  A padded tape runs its nodes only,
    and a batch of one tape equals its row of the batch."""
    p = load_problem("force_free")
    tapes = [p.parse(s) for s in ("(rho - 2)*z", "sqrt(z - 2)", "rho")]
    args = (torch.as_tensor(np.stack([t.padded(MAX_NODES) for t in tapes])),
            torch.as_tensor(np.array([len(t) for t in tapes])),
            torch.as_tensor(p.consts.as_array(np.float32)),
            torch.as_tensor(p.screen_points, dtype=torch.float32))
    jets = batched_evaluator(4, MAX_NODES)(*args)
    assert torch.isfinite(jets[0]).all()
    assert torch.isnan(jets[1][:, 0]).all()
    one = batched_evaluator(4, MAX_NODES)(args[0][2:], args[1][2:],
                                          *args[2:])
    assert torch.equal(one[0], jets[2])


def _search_inputs(p, exprs, lib):
    tapes = [p.parse(s) for s in exprs]
    arrs = (np.stack([t.padded(MAX_NODES) for t in tapes]),
            np.array([len(t) for t in tapes], np.int32),
            p.consts.as_array(np.float32),
            np.asarray(p.screen_points, np.float32),
            np.asarray(p.fingerprint_points, np.float32))
    return tuple(lib(a) for a in arrs)


def test_make_search_kernel_raw_matches_jax():
    import jax.numpy as jnp
    from pde_engine_tpu.parallel.search import \
        make_search_kernel_raw as jax_raw
    from pde_engine_tpu_torch.parallel import make_search_kernel_raw
    p, jp = load_problem("force_free"), jax_load_problem("force_free")
    exprs = list(p.known_solutions) + SEARCH_EXTRA
    key = p.get_residual_key()
    dims = (p.residual_order, MAX_NODES, key, p.screen_rtol,
            len(p.screen_points), len(p.fingerprint_points))
    want = jax_raw(*dims)(*_search_inputs(jp, exprs, jnp.asarray))
    got = make_search_kernel_raw(*dims)(*_search_inputs(p, exprs,
                                                        torch.as_tensor))
    for f in ("screen_ok", "nonfinite", "is_const", "fp_finite", "fp_a",
              "fp_b"):
        assert np.array_equal(getattr(got, f).numpy().astype(np.int64),
                              np.asarray(getattr(want, f)).astype(np.int64)
                              ), f
    np.testing.assert_array_equal(got.fp_vals.numpy(),
                                  np.asarray(want.fp_vals))
    rel, j_rel = got.rel_max.numpy(), np.asarray(want.rel_max)
    big = (rel > 1e-3) | (j_rel > 1e-3)
    np.testing.assert_allclose(rel[big], j_rel[big], rtol=REL_RTOL)
    assert (rel[~big] < 1e-6).all() and (j_rel[~big] < 1e-6).all()
    # every kind of verdict is represented
    assert got.screen_ok.any() and got.nonfinite.any() and \
        got.is_const.any() and (~got.screen_ok).any()


def test_make_tape_jets_kernel_matches_jax():
    """``make_tape_jets_kernel`` (the full verdict packing, screen jets and
    snapped fingerprint jets of each tape) against the JAX package's on
    the same tapes: the packing's verdict, hash and fingerprint columns
    bit-equal, rel_max as in ``make_search_kernel_raw``'s test, and the
    unpacked verdicts those of ``make_search_kernel_raw``."""
    import jax.numpy as jnp
    from pde_engine_tpu.parallel.search import \
        make_tape_jets_kernel as jax_kernel
    from pde_engine_tpu_torch.parallel import (make_search_kernel_raw,
                                               make_tape_jets_kernel)
    from pde_engine_tpu_torch.parallel.search import unpack_screen_result
    p, jp = load_problem("force_free"), jax_load_problem("force_free")
    exprs = list(p.known_solutions) + SEARCH_EXTRA
    dims = (p.residual_order, MAX_NODES, p.get_residual_key(),
            p.screen_rtol, len(p.screen_points), len(p.fingerprint_points))
    want = [np.asarray(a) for a in jax_kernel(*dims)(
        *_search_inputs(jp, exprs, jnp.asarray))]
    args = _search_inputs(p, exprs, torch.as_tensor)
    got = [a.numpy() for a in make_tape_jets_kernel(*dims)(*args)]
    assert [a.shape for a in got] == [a.shape for a in want]
    exact = [0, 2, 3] + list(range(4, got[0].shape[1]))
    np.testing.assert_array_equal(got[0][:, exact], want[0][:, exact])
    rel, j_rel = got[0][:, 1], want[0][:, 1]
    big = (rel > 1e-3) | (j_rel > 1e-3)
    np.testing.assert_allclose(rel[big], j_rel[big], rtol=REL_RTOL)
    assert (rel[~big] < 1e-6).all() and (j_rel[~big] < 1e-6).all()
    np.testing.assert_array_equal(got[2], want[2])
    fin = np.isfinite(want[1])
    assert np.array_equal(fin, np.isfinite(got[1]))
    np.testing.assert_allclose(got[1][fin], want[1][fin], rtol=REL_RTOL,
                               atol=1e-6)
    sr = make_search_kernel_raw(*dims)(*args)
    up = unpack_screen_result(got[0])
    for f in ("screen_ok", "nonfinite", "is_const", "fp_finite", "fp_a",
              "fp_b"):
        assert np.array_equal(getattr(up, f).astype(np.int64),
                              getattr(sr, f).numpy().astype(np.int64)), f
    np.testing.assert_array_equal(up.fp_vals, sr.fp_vals.numpy())


def test_library_smoke():
    """The verify skill's library smoke through the port's package
    boundary: force_free's seven knowns screen with a relative residual
    under 1e-6, ``rho*z`` at about 0.78."""
    from pde_engine_tpu_torch.parallel import make_search_kernel
    p = load_problem("force_free")
    exprs = list(p.known_solutions) + ["rho*z"]
    kernel = make_search_kernel(p.residual_order, MAX_NODES,
                                p.get_residual_key(), p.screen_rtol,
                                len(p.screen_points),
                                len(p.fingerprint_points))
    sr = kernel(*_search_inputs(p, exprs, torch.as_tensor))
    rel = sr.rel_max.numpy()
    assert (rel[:7] < 1e-6).all() and sr.screen_ok[:7].all()
    assert 0.7 < rel[7] < 0.9 and not sr.screen_ok[7]


@pytest.fixture(scope="module")
def tape_engines():
    from pde_engine_tpu.pipeline import DiscoveryEngine as JaxEngine
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    jax_eng = JaxEngine(jax_load_problem("force_free"),
                        JaxSearchConfig(max_depth=3, engine="tape"))
    jax_eng.run(3)
    port = DiscoveryEngine(load_problem("force_free"),
                           SearchConfig(max_depth=3, engine="tape"),
                           device="cpu")
    port.run(3)
    return jax_eng, port


def _counts(eng):
    return [(s.candidates, s.unique, s.valid) for s in eng.stats]


def _keys(eng):
    return {(r.depth, r.signature) for r in eng.rows}


def test_tape_engine_depth3_matches_jax(tape_engines):
    jax_eng, port = tape_engines
    assert _counts(port) == _counts(jax_eng) == TAPE_D3
    assert _keys(port) == _keys(jax_eng)
    assert {(r.signature, r.is_valid) for r in port.rows} == \
        {(r.signature, r.is_valid) for r in jax_eng.rows}
    knowns = {r.paper_solution_name for r in port.valid_rows
              if r.paper_solution_name}
    assert knowns == {r.paper_solution_name for r in jax_eng.valid_rows
                      if r.paper_solution_name} == {
        "Vertical field", "X-point", "Parabolic"}
    # the cache holds every unique's jets on the engine's device, and no
    # screen kernel ran
    assert port.cache.n == sum(u for _, u, _ in TAPE_D3)
    assert port.cache.screen.device == port.device
    assert port.dispatch_counts() == {"segmented": 0, "structured": 0,
                                      "tiled": 0, "universal": 0}
    st = port.stats[2]
    assert 0 < st.t_enum + st.t_ingest + st.t_gray <= st.seconds


def test_tape_engine_refuses_sharding():
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    p = load_problem("laplace")
    for cfg in (dict(shard_cache=True), dict(shard_registry=True)):
        with pytest.raises(ValueError, match="one device"):
            DiscoveryEngine(p, SearchConfig(engine="tape", **cfg),
                            device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        DiscoveryEngine(p, SearchConfig(engine="xla"), device="cpu")


def _exact_keys(eng, rows):
    """The tape engine's key of each row: its whole tape through the
    float64 oracle (``_eval_tape_groups``)."""
    from pde_engine_tpu_torch.pipeline import Candidate
    from pde_engine_tpu_torch.utils.hashing import (FP_MASK,
                                                    struct_key_for_expr)
    cands = [Candidate(depth=r.depth, expr_str=r.expression, top_op="",
                       has_var=True, tape=eng.enumerator.tape_of(r.id - 1),
                       consts=eng.problem.consts) for r in rows]
    key = {}
    for group, sr, _, _ in eng._eval_tape_groups(cands):
        for j, c in enumerate(group):
            key[id(c)] = (((int(sr.fp_a[j]) << 32) | int(sr.fp_b[j]))
                          & FP_MASK if sr.fp_finite[j]
                          else struct_key_for_expr(c.expr_str))
    return [key[id(c)] for c in cands]


def _f32_keys(eng, rows):
    """The key of each row from its whole tape in float32
    (``make_search_kernel_raw``), in batches of like tape length."""
    from pde_engine_tpu_torch.parallel import make_search_kernel_raw
    from pde_engine_tpu_torch.utils.hashing import (FP_MASK,
                                                    struct_key_for_expr)
    p = eng.problem
    tapes = [eng.enumerator.tape_of(r.id - 1) for r in rows]
    out = [None] * len(rows)
    for lo, hi in ((0, 8), (9, 16), (17, MAX_NODES)):
        idx = [i for i, t in enumerate(tapes) if lo <= len(t) <= hi]
        if not idx:
            continue
        kernel = make_search_kernel_raw(p.residual_order, hi,
                                        p.get_residual_key(), p.screen_rtol,
                                        len(p.screen_points),
                                        len(p.fingerprint_points))
        sr = kernel(torch.as_tensor(np.stack([tapes[i].padded(hi)
                                              for i in idx])),
                    torch.as_tensor(np.array([len(tapes[i]) for i in idx])),
                    torch.as_tensor(p.consts.as_array(np.float32)),
                    torch.as_tensor(p.screen_points, dtype=torch.float32),
                    torch.as_tensor(p.fingerprint_points,
                                    dtype=torch.float32))
        for j, i in enumerate(idx):
            out[i] = (((int(sr.fp_a[j]) << 32) | int(sr.fp_b[j])) & FP_MASK
                      if bool(sr.fp_finite[j])
                      else struct_key_for_expr(rows[i].expression))
    return out


def test_tape_and_incremental_counts_classified(tape_engines):
    """Where the tape engine's depth-3 counts (9,835 candidates, 6,665
    uniques) part from the incremental engine's (9,965, 8,976): the
    incremental engine's uniques are re-keyed from their whole tapes.

    - Depth 2: of its 153 uniques, ``(rho / (z))`` has the exact key of
      the primitive ``rho/z`` and ``(z / (rho))`` that of
      ``inv(rho/z)``: two uniques the tape engine folds, so its depth 3
      has exactly the 130 candidates that take one of them as a parent
      fewer (``candidates_at_depth`` composes what
      ``vector_batches_at_depth`` composes).
    - Depth 3: the 8,976 uniques hold 6,805 exact (float64) keys, and
      6,820 float32 whole-tape keys: the float32 rounding of a whole tape
      splits 15 functions, the incremental route 2,171 more.  The
      incremental engine keys a candidate from its parents' cache rows,
      whose fingerprint jets are snapped to a 12-bit significand, so a
      function reached by two routes lands in two cells.  Of the 6,805,
      139 are functions of depth 1-2, which the tape engine folds into
      them.
    """
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    _, tape = tape_engines
    inc = DiscoveryEngine(load_problem("force_free"),
                          SearchConfig(max_depth=3), device="cpu")
    inc.run(3)
    assert _counts(inc) == [(5, 5, 4), (168, 153, 93), (9965, 8976, 2153)]
    rows = [r for r in inc.rows if r.depth <= 3]
    exact = _exact_keys(inc, rows)
    t_rows = [r for r in tape.rows if r.depth <= 3]
    t_exact = _exact_keys(tape, t_rows)
    assert t_exact == [int(r.signature, 16) for r in t_rows]

    by_depth = {d: [k for k, r in zip(exact, rows) if r.depth == d]
                for d in (1, 2, 3)}
    assert [len(set(by_depth[d])) for d in (1, 2, 3)] == [5, 152, 6805]
    shallow = {k: r.expression for k, r in sorted(
        zip(exact, rows), key=lambda kr: -kr[1].id) if r.depth <= 2}
    tape2 = {r.expression for r in tape.rows if r.depth == 2}
    folded = {r.id - 1: shallow[k] for k, r in zip(exact, rows)
              if r.depth == 2 and r.expression not in tape2}
    assert {inc.enumerator.expr_str_of(u): e for u, e in folded.items()} \
        == {"(rho / (z))": "rho/z", "(z / (rho))": "inv(rho/z)"}
    cands = list(inc.enumerator.candidates_at_depth(3))
    assert len(cands) == 9965
    via = sum(1 for c in cands
              if c.a.uid in folded or (c.b is not None and c.b.uid in folded))
    assert via == 130 == 9965 - 9835

    f32 = _f32_keys(inc, rows)
    assert len({k for k, r in zip(f32, rows) if r.depth == 3}) == 6820
    lower = {k for k, r in zip(exact, rows) if r.depth <= 2}
    d3 = set(by_depth[3])
    t3 = {k for k, r in zip(t_exact, t_rows) if r.depth == 3}
    assert len(d3 & lower) == 139
    # the rest: 3 keys of candidates with a folded parent, 2 constants
    # ((rho - 1)/(1 - rho), (1 - rho)/(1 - rho)) whose float64 roundoff
    # gives them keys of their own
    assert len(d3 - lower - t3) == 3 and len(t3 - d3) == 2
    assert len(t3) == 6805 - 139 - 3 + 2 == 6665
    digest = hashlib.sha256("\n".join(sorted(
        r.signature for r in tape.rows if r.depth == 3)).encode())
    assert digest.hexdigest()[:16] == "8cbae1519c42edf6"
