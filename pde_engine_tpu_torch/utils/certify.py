"""Offline certifier: machine-checkable exactness certificates for stored
solutions.

This replaces the reference's vestigial Lean subsystem (SURVEY.md §2.2 —
its normalizer never ran per-expression and its `foliation_search` targets
don't exist) with something that actually certifies: for each valid row we
emit a self-contained JSON certificate recording the candidate, the exact
symbolic residual, the proof strategy that reduced it to zero, and exact
rational spot checks.  `tools/check_certificates.py` re-verifies a
certificate file using ONLY its own contents + SymPy — an independent
audit path that needs neither the engine nor the run DB (the role SURVEY
§7 stage 9 assigned to an "optional offline certifier").

Certificate schema (one per expression):
  expression        the stored candidate string
  residual_srepr    sympy srepr of the residual lhs BEFORE simplification
  proof             how it was reduced to zero:
                      "cancel-zero"   together(cancel(lhs)) == 0
                      "simplify-zero" simplify(...) == 0
                      "refuted"       residual does NOT vanish (negative
                                      certificate — the row is disproved)
                      "open"          could not decide within limits
  spot_checks       [{point: {var: "p/q"...}, value: str}] — residual at
                    exact rational points; "0" entries are exact zeros
                    (sympy rational arithmetic), other values are evalf(30)
  problem / math    the PDE being certified, for the independent checker
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from fractions import Fraction


SPOT_POINTS = [(Fraction(4, 5), Fraction(6, 7)),
               (Fraction(1, 3), Fraction(2, 5)),
               (Fraction(7, 4), Fraction(9, 8))]


def certificate_for(problem, expr_str: str,
                    simplify_len_limit: int = 6000) -> Dict:
    """Build one certificate (pure function of problem + expression).

    Symbolic work is length-bounded: sympy.simplify on the sqrt-laden
    order-4 determinants can take minutes, so residuals whose
    cancel-normal form exceeds ``simplify_len_limit`` characters fall back
    to the 50-digit numeric tier ("evalf-zero" — the same evidence class
    as the reference's fast-path evalf(50) |det| < 1e-20 acceptance,
    force_free/validator.py:388-389, clearly labeled as numeric)."""
    import sympy as sp
    cert: Dict = {"expression": expr_str}
    try:
        u = problem.tape_to_sympy(problem.parse(expr_str))
        lhs = problem.sympy_residual(u)
    except Exception as e:
        cert["proof"] = "open"
        cert["note"] = f"could not derive residual: {type(e).__name__}: {e}"
        return cert
    srepr = sp.srepr(lhs)
    cert["residual_srepr"] = (srepr if len(srepr) <= simplify_len_limit
                              else srepr[:simplify_len_limit] + "...")

    proof = "open"
    try:
        q = sp.together(sp.cancel(lhs))
        if q == 0:
            proof = "cancel-zero"
        elif len(str(q)) <= simplify_len_limit and sp.simplify(q) == 0:
            proof = "simplify-zero"
    except Exception:
        pass

    # exact rational spot checks (independent of the simplification path);
    # named problem parameters (Kerr's M, a) bind to their exact values
    v0, v1 = problem.sympy_vars()
    params = {}
    try:
        psyms = problem.sympy_params()
        for name, value in getattr(problem, "param_values", {}).items():
            params[psyms[name]] = sp.nsimplify(value, rational=True)
    except Exception:
        params = {}
    if params:
        cert["params"] = {str(k): str(v) for k, v in params.items()}
    spots: List[Dict] = []
    nonzero = False
    all_zero50 = True
    for (a, b) in SPOT_POINTS:
        pt = {v0: sp.Rational(a.numerator, a.denominator),
              v1: sp.Rational(b.numerator, b.denominator), **params}
        try:
            val = lhs.subs(pt)
            if val.is_zero:                      # structurally exact zero
                spots.append({"point": [str(a), str(b)], "value": "0"})
                continue
            approx = sp.N(val, 50)
            mag = None
            try:
                mag = abs(complex(approx))
            except (TypeError, ValueError):
                pass
            if mag is not None and mag == 0.0:
                spots.append({"point": [str(a), str(b)], "value": "0"})
            else:
                spots.append({"point": [str(a), str(b)],
                              "value": str(sp.N(approx, 30))})
                if mag is None or mag > 1e-30:
                    all_zero50 = False
                if mag is not None and mag > 1e-25:
                    nonzero = True
        except Exception as e:
            all_zero50 = False
            spots.append({"point": [str(a), str(b)],
                          "value": f"error: {type(e).__name__}"})
    cert["spot_checks"] = spots
    if proof == "open":
        if nonzero:
            proof = "refuted"
        elif all_zero50 and spots:
            proof = "evalf-zero"
    cert["proof"] = proof
    return cert


def certify_rows(problem, rows, out_dir: str,
                 run_id: str = "") -> Dict:
    """Certify a row set and write certificates_<ts>.json; returns a
    summary dict (and the path)."""
    import sympy
    certs = []
    counts = {"cancel-zero": 0, "simplify-zero": 0, "evalf-zero": 0,
              "refuted": 0, "open": 0}
    for r in rows:
        expr = r["expression"] if not isinstance(r, str) else r
        c = certificate_for(problem, expr)
        counts[c["proof"]] = counts.get(c["proof"], 0) + 1
        certs.append(c)
    doc = {
        "run_id": run_id,
        "problem": problem.name,
        "math_definition": problem.describe().get("math_definition", ""),
        "variables": list(problem.var_names),
        "sympy_version": sympy.__version__,
        "timestamp": time.strftime("%Y%m%d_%H%M%S"),
        "counts": counts,
        "certificates": certs,
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"certificates_{doc['timestamp']}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    return {"path": path, "counts": counts, "n": len(certs)}
