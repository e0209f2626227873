"""The Laplace residual: u_xx + u_yy."""

from __future__ import annotations

from .residuals import Term

ORDER = 2


def residual(d, de, points):
    res = (Term(d[(2, 0)], None, de[(2, 0)])
           + Term(d[(0, 2)], None, de[(0, 2)]))
    return res.v, res.m, res.e
