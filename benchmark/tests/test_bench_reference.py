"""The plain reference: its Taylor arithmetic, its residuals, and its
verdict on the configurations' known solutions (CPU)."""

from __future__ import annotations

import math
import os

import numpy as np
import pytest

from benchmark.harness import spec
from benchmark.reference import taylor, verdict

CONFIGS = {n: spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                          n + ".json"))
           for n in ("force_free_d4", "laplace_d5")}


def test_taylor_derivatives_against_closed_forms():
    pts = np.array([[0.7, 0.4], [1.2, 0.9]])
    x, y = pts[:, 0], pts[:, 1]
    u = verdict.polynomials(["exp((rho * z))"], ("rho", "z"), pts, 4)[0][0]
    d = taylor.derivatives(u, 4)
    e = np.exp(x * y)
    np.testing.assert_allclose(d[(0, 0)], e)
    np.testing.assert_allclose(d[(2, 1)], e * (2 * y + x * y * y), rtol=1e-13)
    np.testing.assert_allclose(d[(1, 3)], e * (3 * x * x + x ** 3 * y),
                               rtol=1e-13)
    r = np.sqrt(x * x + y * y)
    u = verdict.polynomials(["sqrt(rho**2 + z**2)", "log_mul(1, rho)",
                             "pow_neg_3_2(rho)"], ("rho", "z"), pts, 4)[0]
    np.testing.assert_allclose(taylor.derivative(u[0], 2, 0, 4),
                               y * y / r ** 3, rtol=1e-13)
    np.testing.assert_allclose(taylor.derivative(u[1], 4, 0, 4),
                               -6.0 / x ** 4, rtol=1e-13)
    np.testing.assert_allclose(taylor.derivative(u[2], 3, 0, 4),
                               -1.5 * -2.5 * -3.5 * x ** -4.5, rtol=1e-13)


def test_spellings_of_the_surface_ops():
    pts = np.array([[0.8, 0.5]])
    x, y = 0.8, 0.5
    got = verdict.values(
        ["geom_sum(rho, z)", "(rho / (1 - z))", "sqrt_shift_neg(rho, z)",
         "sqrt_shift_pos(rho, z)", "exp_mul(rho, z)", "log_mul(rho, z)",
         "exp_neg(z)", "square(inv(rho))", "pow_3_2(z)", "neg(rho/z)",
         "rho**2 + z**2"], ("rho", "z"), pts)[:, 0]
    want = [x / (1 - y), x / (1 - y), math.hypot(x - 1, y),
            math.hypot(x + 1, y), x * math.exp(y), x * math.log(y),
            math.exp(-y), x ** -2, y ** 1.5, -x / y, x * x + y * y]
    np.testing.assert_allclose(got, want, rtol=1e-15)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_reference_accepts_the_known_solutions(name):
    cfg = CONFIGS[name]
    knowns = list(cfg["knowns"])
    out = verdict.judge(knowns, cfg["reference"])
    assert out["solution"].all(), dict(zip(knowns, out["rel_screen"]))
    assert (out["rel_screen"] < 1e-12).all()
    assert not out["undecided"].any()


PERTURB = {"force_free_d4": "(({k}) * (1 + rho*z/10))",
           "laplace_d5": "(({k}) + X**3/10)"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_reference_rejects_perturbed_knowns(name):
    cfg = CONFIGS[name]
    bad = [PERTURB[name].format(k=k) for k in cfg["knowns"]]
    bad += ["exp(exp(rho/z))" if name.startswith("force") else
            "exp(exp(exp(X/Y)))"]           # beyond float32 on the screen
    bad += ["(rho - rho)" if name.startswith("force") else "(X - X)"]
    out = verdict.judge(bad, cfg["reference"])
    assert not out["solution"].any(), dict(zip(bad, out["rel_screen"]))
    assert out["constant"][-1] and not out["finite"][-2]


@pytest.mark.parametrize("name,exact,zero", [
    ("force_free_d4",
     ["sqrt(square((rho - z)))", "(exp_mul(z, (rho + 1)) / (z))"],
     ["(1 - (rho * inv(rho)))",
      "log_mul(rho**2 + z**2, exp_mul(exp_neg(z), z))"]),
    ("laplace_d5", ["square(sqrt(X))", "(X * (Y / (X)))"],
     ["(X + ((X**2 + Y**2) - (X + (X**2 + Y**2))))",
      "log_mul(X, ((Y + 1) - Y))"]),
])
def test_zeros_of_exact_arithmetic_are_told_from_small_numbers(name, exact,
                                                               zero):
    """A solution whose residual is roundoff at every screen point is
    undecided; a row that is 0 in exact arithmetic is constant."""
    out = verdict.judge(exact + zero, CONFIGS[name]["reference"])
    assert out["solution"][:2].all() and out["undecided"][:2].all()
    assert not out["constant"][:2].any()
    assert out["constant"][2:].all() and not out["solution"][2:].any()
    assert not out["undecided"][2:].any()


def test_unreadable_spellings_raise():
    with pytest.raises(ValueError):
        verdict.values(["frobnicate(rho)"], ("rho", "z"), [[1.0, 1.0]])
    with pytest.raises(ValueError):
        verdict.values(["q + rho"], ("rho", "z"), [[1.0, 1.0]])
