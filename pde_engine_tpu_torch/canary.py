"""Recall canaries: planted zero-residual force_free candidates that must
survive the funnel as valid rows (counterpart of the JAX package's
``tests/test_recall_canary.py``, shared by the port's tests and
``chip_smoke.py``).

Any u(rho) alone is a valid, degenerate foliation (u_z = 0 makes both Lie
columns vanish), so deep pure-rho compositions are valid at every depth.
A canary is located among an engine's valid rows by its fingerprint
values (the f64 oracle's, within 1e-3 relative, as the engine matches
known solutions) and confirmed by exact SymPy equality: the row that
holds it may spell it another way.  Its stored dedup key must map back
to the row's own uid.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# (expression, depth) of each canary
CANARIES = (
    ("square(square(rho))", 3),          # rho^4
    ("exp_neg(square(rho))", 3),         # exp(-rho^2)
    ("sqrt(square(square(rho)))", 4),    # rho^4 through Abs
)


def canary_fp_values(problem, expr: str) -> np.ndarray:
    """The f64 oracle's snapped fingerprint values of ``expr``; raises if
    it fails its own screen or its fingerprint is not finite."""
    from .ops.interpreter import eval_jets_np_many
    from .parallel.search import verdicts_from_jets_np
    t = problem.parse(expr)
    tapes = np.stack([t.padded(max(len(t), 16))])
    lengths = np.array([len(t)], np.int64)
    consts = problem.consts.as_array(np.float64)
    jets = eval_jets_np_many(tapes, lengths, consts, problem.screen_points,
                             problem.residual_order)
    fj = eval_jets_np_many(tapes, lengths, consts,
                           problem.fingerprint_points, 1)
    sr = verdicts_from_jets_np(jets, fj, problem.screen_points,
                               problem.residual_fn,
                               float(problem.screen_rtol))
    if not (bool(sr.screen_ok[0]) and bool(sr.fp_finite[0])):
        raise ValueError(f"canary {expr} fails its own screen")
    return np.asarray(sr.fp_vals[0], np.float64).ravel()


def locate(engine, expr: str) -> Optional[object]:
    """The valid row of ``engine`` that holds the canary ``expr``, or
    None.  Raises if that row's dedup key does not map to its uid."""
    import sympy as sp
    import torch
    p = engine.problem
    vals = canary_fp_values(p, expr)
    rows = engine.valid_rows
    if not rows:
        return None
    uids = torch.as_tensor([r.id - 1 - engine.id_offset for r in rows],
                           dtype=torch.int64)
    fps = engine.cache.fp[uids.to(engine.cache.fp.device)].cpu().numpy()
    close = np.max(np.abs(fps.astype(np.float64) - vals)
                   / (np.abs(vals) + 1.0), axis=1) < 1e-3
    target = p.tape_to_sympy(p.parse(expr))
    for i in np.nonzero(close)[0].tolist():
        row = rows[i]
        if sp.simplify(p.tape_to_sympy(p.parse(row.expression))
                       - target) != 0:
            continue
        uid = engine.fp_to_uid.get(int(row.signature, 16))
        if uid != row.id - 1 - engine.id_offset:
            raise AssertionError(f"canary {expr}: the key of row {row.id} "
                                 f"maps to uid {uid}")
        return row
    return None
